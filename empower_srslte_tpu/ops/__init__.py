"""DSP compute kernels: OFDM, modem, scrambling, FEC, chest, MIMO, sync.

Batched counterparts of the reference's per-function DSP modules under
lib/src/phy/ (dft/, modem/, scrambling/, fec/, ch_estimation/, mimo/,
sync/). Every op is a batched, statically-shaped jnp/Pallas transform;
spec tables are precomputed host-side in numpy and closed over as device
constants.
"""
