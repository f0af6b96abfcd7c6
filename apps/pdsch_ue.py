#!/usr/bin/env python
"""File/UDP-driven UE receiver (lib/examples/pdsch_ue.c analog).

Synchronizes to a capture, then decodes every subframe for one RNTI and
reports rates like pdsch_ue.c:786-827 (net/processing Mbps, BLER).

Usage:
  python apps/pdsch_ue.py -i /tmp/enb.bin -p 25 -r 0x1234

Runs on the accelerator JAX finds; JAX_PLATFORMS=cpu selects the CPU.
"""

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from empower_srslte_tpu.backend import configure_compile_cache
from empower_srslte_tpu.models.ue_dl import ue_dl_decode, ue_mib_acquire
from empower_srslte_tpu.models.ue_sync import sync_and_align
from empower_srslte_tpu.runtime.io import FileSource
from empower_srslte_tpu.runtime.logging import get_logger
from empower_srslte_tpu.runtime.metrics import MetricsHub, MetricsStdout
from empower_srslte_tpu.utils import Cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    ap.add_argument("-r", "--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("-n", "--max-subframes", type=int, default=100)
    args = ap.parse_args(argv)
    configure_compile_cache()

    log = get_logger("UE", "info")
    hub = MetricsHub()
    hub.add_listener(MetricsStdout())

    samples = FileSource(args.input).read_all()
    log.info("capture: %d samples", len(samples))
    res = sync_and_align(samples, cell_prb=args.nof_prb)
    log.info("found cell id=%d cfo=%.3f sf0@%d (metric %.2f)",
             res.cell_id, res.cfo, res.sf0_offset, res.metric)
    cell = Cell(nof_prb=args.nof_prb, id=res.cell_id)
    mib = ue_mib_acquire(res.subframes[0], cell, res.cell_id)
    log.info("MIB: %s", mib)

    bits_ok = 0
    blocks = 0
    errors = 0
    t0 = time.time()
    nof = min(len(res.subframes), args.max_subframes)
    for i in range(nof):
        sf_idx = i % 10
        log.step(i)
        # res.subframes stays on device
        for r in ue_dl_decode(res.subframes[i], cell, sf_idx,
                              args.rnti):
            if r.dci is None:
                continue
            blocks += 1
            if r.crc_ok:
                bits_ok += len(r.tb_bits)
            else:
                errors += 1
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            hub.report({
                "sf": i + 1,
                "net_mbps": bits_ok / (i + 1) / 1e3,   # per 1ms subframe
                "proc_mbps": bits_ok / dt / 1e6,
                "bler": errors / max(blocks, 1),
            })
    log.info("done: %d subframes, %d TBs, BLER %.3f",
             nof, blocks, errors / max(blocks, 1))
    return {"cell_id": res.cell_id, "mib": mib, "subframes": nof,
            "tbs": blocks, "crc_errors": errors, "bits_ok": bits_ok}


if __name__ == "__main__":
    main()
