"""empower_srslte_tpu — a batched JAX LTE PHY framework.

A brand-new JAX/XLA/Pallas implementation of the complete LTE Release-8/9
FDD PHY signal chain (the capability surface of the EmPOWER srsLTE fork):
OFDM modulation/demodulation, PSS/SSS synchronization, channel estimation,
ZF/MMSE equalization (TM1-TM4), soft demapping, HARQ rate (de)matching and
windowed max-log-MAP turbo decoding — built for throughput batching on
GPU device meshes rather than per-subframe real-time threading.

Design stance (see SURVEY.md section 7): the unit of work is a
``[batch, ...]`` tensor of subframes / code blocks / carriers compiled under
``jax.jit`` / ``pjit``; all spec tables (QPP interleavers, rate-matching
index maps, Gold sequences, pilot grids) are precomputed host-side as numpy
constants keyed on a static cell/grant configuration, mirroring the
reference's plan-per-size approach (lib/src/phy/dft/dft_fftw.c:76,
fec/rm_turbo.c:65, phch/pdsch.c:616) without translating its C layout.

Subpackages
-----------
utils     cell/grant config dataclasses, Gold sequences, CRC, bit helpers
ops       DSP compute kernels (OFDM, modem, FEC, chest, MIMO, sync)
models    channel processors (PDSCH/PDCCH/PBCH/...) and full UE/eNB chains
parallel  mesh construction and sharded pipelines (pjit / shard_map)
runtime   host-side runtime: IQ file/net I/O, config, logging, metrics
"""

__version__ = "0.1.0"
