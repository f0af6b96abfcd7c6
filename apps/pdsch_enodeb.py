#!/usr/bin/env python
"""eNB downlink signal generator (lib/examples/pdsch_enodeb.c analog).

Composes frames with CRS + PSS/SSS + PBCH(MIB) + PCFICH + PDCCH(DCI 1A) +
PDSCH for one RNTI and writes the IQ samples to a file or UDP sink.

Usage:
  python apps/pdsch_enodeb.py -o /tmp/enb.bin -p 25 -m 10 -f 20

Runs on the accelerator JAX finds; JAX_PLATFORMS=cpu selects the CPU.
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from empower_srslte_tpu.backend import configure_compile_cache
from empower_srslte_tpu.models import dci as dci_mod
from empower_srslte_tpu.models import ra
from empower_srslte_tpu.models.enb_dl import (
    enb_dl_base_grid, enb_dl_gen_signal, put_sync_signals)
from empower_srslte_tpu.models.pbch import mib_pack, pbch_put
from empower_srslte_tpu.models.pcfich import pcfich_put
from empower_srslte_tpu.models.pdcch import pdcch_encode
from empower_srslte_tpu.models.pdsch import PdschConfig, pdsch_encode
from empower_srslte_tpu.runtime.io import FileSink, NetSink
from empower_srslte_tpu.runtime.logging import get_logger
from empower_srslte_tpu.utils import Cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", required=True, help="IQ file or udp:host:port")
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    ap.add_argument("-c", "--cell-id", type=int, default=1)
    ap.add_argument("-m", "--mcs", type=int, default=10)
    ap.add_argument("-r", "--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("-f", "--nof-frames", type=int, default=10)
    ap.add_argument("--cfi", type=int, default=2)
    args = ap.parse_args(argv)
    configure_compile_cache()

    log = get_logger("ENB", "info")
    cell = Cell(nof_prb=args.nof_prb, id=args.cell_id)
    prb_len = args.nof_prb - 2
    mod, tbs = ra.mcs_to_tbs(args.mcs, prb_len)
    mask = ra.prb_mask_type2(cell.nof_prb, 0, prb_len)
    rng = np.random.default_rng(0)
    mib = mib_pack(cell.nof_prb, 0, 1, 0)

    if args.output.startswith("udp:"):
        _, host, port = args.output.split(":")
        sink = NetSink(host, int(port))
    else:
        sink = FileSink(args.output)

    log.info("cell: %d PRB, id %d; PDSCH mcs=%d tbs=%d rnti=0x%x",
             cell.nof_prb, cell.id, args.mcs, tbs, args.rnti)
    dci_payload = dci_mod.pack_format1a(cell.nof_prb, 0, prb_len, args.mcs)
    for sfn in range(args.nof_frames):
        for sf_idx in range(10):
            log.step(10 * sfn + sf_idx)
            grid = enb_dl_base_grid(cell, sf_idx, ())
            grid = put_sync_signals(grid, cell, sf_idx)
            grid = pcfich_put(grid, args.cfi, cell, sf_idx)
            if sf_idx == 0:
                grid = pbch_put(grid, jnp.asarray(mib_pack(
                    cell.nof_prb, 0, 1, sfn)), cell, sfn=sfn)
            cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=args.cfi,
                              rnti=args.rnti, mod=mod, prb_mask=mask)
            plan = cfg.plan(tbs)
            tb = rng.integers(0, 2, size=(1, tbs)).astype(np.int8)
            grid = grid + pdcch_encode(jnp.asarray(dci_payload), args.rnti,
                                       0, 4, cell, args.cfi, sf_idx)
            grid = grid + pdsch_encode(jnp.asarray(tb), cfg, plan)[0]
            sink.write(np.asarray(enb_dl_gen_signal(grid, cell))[0])
    sink.close()
    log.info("wrote %d frames to %s", args.nof_frames, args.output)


if __name__ == "__main__":
    main()
