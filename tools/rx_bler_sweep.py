"""End-to-end receiver BLER vs SNR over AWGN (SURVEY.md section 4 tier-3).

The full DL chain per subframe — compose grid + CRS -> iFFT -> AWGN at
sample level -> FFT -> LS channel estimation off the CRS -> equalize ->
decode — swept over SNR for several MCS, printing a BLER table. This is
the swept version of the reference's enb_dl->ue_dl loopback
(lib/test/phy/phy_dl_test.c, which runs noiseless; the AWGN generator is
its channel/ch_awgn.c), used as the decode-quality parity evidence:
each curve's waterfall must sit at the textbook
position for its code rate.

Usage: python tools/rx_bler_sweep.py [batch=64] [prb=50]
(GPU recommended; JAX_PLATFORMS=cpu works with small batches.)
"""

import sys

import _pathfix  # noqa: F401  (repo root on sys.path)
import time

import numpy as np

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import ra
from empower_srslte_tpu.models.enb_dl import enb_dl_base_grid, enb_dl_gen_signal
from empower_srslte_tpu.models.pdsch import PdschConfig, pdsch_decode, pdsch_encode
from empower_srslte_tpu.ops.chest import chest_dl, noise_est_pilots
from empower_srslte_tpu.ops.modem import Mod
from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf
from empower_srslte_tpu.utils.cell import Cell

#: MCS and the SNR grids bracketing each waterfall (QPSK r~1/3, 16QAM
#: r~1/2, 64QAM r~3/4 operating points).
SWEEPS = [
    (4, (-4.0, -3.0, -2.0, -1.0, 0.0, 1.0)),
    (12, (2.0, 3.0, 4.0, 5.0, 6.0, 7.0)),
    (22, (10.0, 11.0, 12.0, 13.0, 14.0, 15.0)),
]


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    prb = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    cell = Cell(nof_prb=prb, id=1)
    rng = np.random.default_rng(0)

    print(f"# full receiver (chest off CRS), {prb} PRB SISO, "
          f"batch {batch} subframes per point")
    print(f"{'mcs':>4} {'snr_db':>7} {'bler':>8} {'tbs':>7}")
    for mcs, snrs in SWEEPS:
        mod, tbs = ra.mcs_to_tbs(mcs, prb)
        cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod)
        plan = cfg.plan(tbs)
        tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)

        @jax.jit
        def chain(tb_bits, nz_re, nz_im, inv_snr):
            # base grid built inside the jit, so that no complex64
            # closure constant crosses the host-device boundary
            base = enb_dl_base_grid(cell, 1, (1,))
            grid = base + pdsch_encode(tb_bits, cfg, plan)  # [B,P,14,nre]
            samples = jax.vmap(
                lambda g: enb_dl_gen_signal(g, cell).reshape(-1))(grid)
            p = jnp.mean(jnp.abs(samples) ** 2, axis=-1, keepdims=True)
            sigma = jnp.sqrt(p * inv_snr / 2.0)
            noisy = samples + sigma * jax.lax.complex(nz_re, nz_im)
            rx = jax.vmap(lambda s: ofdm_rx_sf(s, cell))(noisy)
            rx = rx.reshape(rx.shape[0], cell.nsymb_sf, -1)  # [B,14,nre]
            h = chest_dl(rx, cell, 1)
            n0 = noise_est_pilots(rx, cell, 1)
            hh = h[:, None, None]              # [B, A=1, P=1, 14, nre]
            noise = jnp.mean(n0)
            bits, ok, _ = pdsch_decode(rx[:, None], hh, cfg, plan,
                                       noise_est=noise)
            return ok

        for snr in snrs:
            nz = (rng.normal(size=(batch, cell.sf_sample_len))
                  .astype(np.float32))
            nz2 = (rng.normal(size=(batch, cell.sf_sample_len))
                   .astype(np.float32))
            inv = np.float32(10 ** (-snr / 10))
            ok = np.asarray(chain(jnp.asarray(tb), jnp.asarray(nz),
                                  jnp.asarray(nz2), inv))
            bler = 1.0 - ok.mean()
            print(f"{mcs:>4} {snr:>7.1f} {bler:>8.3f} {tbs:>7}",
                  flush=True)


if __name__ == "__main__":
    main()
