#!/usr/bin/env python
"""Cell measurement over a capture (lib/examples/cell_measurement.c analog):
sync to the cell, then report RSRP / RSRQ / RSSI / SNR averaged over the
capture's subframes, the way the reference's example prints its running
averages (cell_measurement.c main loop).

Usage: python apps/cell_measurement.py -i /tmp/enb.bin -p 25
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from empower_srslte_tpu.backend import configure_compile_cache
from empower_srslte_tpu.models.ue_sync import sync_and_align
from empower_srslte_tpu.runtime.io import FileSource
from empower_srslte_tpu.runtime.logging import get_logger


def measure(subframes, cell_prb: int, cell_id: int) -> dict:
    """Batched per-subframe measurements -> capture averages (linear)."""
    import jax
    import jax.numpy as jnp

    from empower_srslte_tpu.ops.chest import (chest_dl, noise_est_pilots,
                                              rsrp, rsrq, rssi)
    from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf
    from empower_srslte_tpu.utils import Cell

    cell = Cell(nof_prb=cell_prb, id=cell_id)
    n = subframes.shape[0] - subframes.shape[0] % 10
    subframes = subframes[:n]

    import functools

    @functools.partial(jax.jit, static_argnums=(1,))
    def per_sf_idx(sf_batch, sf_idx):
        grid = ofdm_rx_sf(sf_batch, cell)
        p = rsrp(grid, cell, sf_idx)
        q = rsrq(grid, cell, sf_idx)
        s = rssi(grid)
        noise = noise_est_pilots(grid, cell, sf_idx)
        return p, q, s, p / jnp.maximum(noise, 1e-20)

    acc = {"rsrp": [], "rsrq": [], "rssi": [], "snr": []}
    for sf_idx in range(10):
        batch = jnp.asarray(subframes[sf_idx::10])
        p, q, s, snr = per_sf_idx(batch, sf_idx)
        acc["rsrp"].append(np.asarray(p))
        acc["rsrq"].append(np.asarray(q))
        acc["rssi"].append(np.asarray(s))
        acc["snr"].append(np.asarray(snr))
    return {k: float(np.mean(np.concatenate(v))) for k, v in acc.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    args = ap.parse_args(argv)
    configure_compile_cache()

    log = get_logger("MEAS", "info")
    samples = FileSource(args.input).read_all()
    res = sync_and_align(samples, cell_prb=args.nof_prb)
    log.info("camped on cell %d, CFO %+.1f Hz, %d subframes",
             res.cell_id, res.cfo * 15e3, res.subframes.shape[0])

    m = measure(np.asarray(res.subframes), args.nof_prb, res.cell_id)
    db = lambda x: 10 * np.log10(max(x, 1e-20))
    log.info("RSRP %6.2f dBfs | RSRQ %6.2f dB | RSSI %6.2f dBfs | SNR %5.2f dB",
             db(m["rsrp"]), db(m["rsrq"]), db(m["rssi"]), db(m["snr"]))
    print({k: round(db(v), 2) for k, v in m.items()})


if __name__ == "__main__":
    main()
