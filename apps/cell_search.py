#!/usr/bin/env python
"""Cell scanner over a capture (lib/examples/cell_search.c analog):
PSS/SSS scan for all N_id_2 + MIB decode.

Usage: python apps/cell_search.py -i /tmp/enb.bin [-p 6]
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from empower_srslte_tpu.backend import configure_compile_cache
from empower_srslte_tpu.models.ue_dl import ue_mib_decode
from empower_srslte_tpu.models.ue_sync import sync_and_align
from empower_srslte_tpu.runtime.io import FileSource
from empower_srslte_tpu.runtime.logging import get_logger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=6,
                    help="search bandwidth (6 = MIB acquisition rate)")
    args = ap.parse_args(argv)
    configure_compile_cache()

    log = get_logger("SRCH", "info")
    samples = FileSource(args.input).read_all()
    res = sync_and_align(samples, cell_prb=args.nof_prb)
    log.info("cell id %d (N_id_1=%d, N_id_2=%d), CFO %.1f Hz, metric %.2f",
             res.cell_id, res.cell_id // 3, res.n_id_2, res.cfo * 15e3,
             res.metric)
    if args.nof_prb == 6 and len(res.subframes) > 0:
        mib = ue_mib_decode(np.asarray(res.subframes[0]), res.cell_id)
        if mib:
            log.info("MIB: %d PRB, %d ports, SFN %d",
                     mib["nof_prb"], mib["nof_ports"], mib["sfn_msb"] * 4
                     + mib["sfn_mod4"])
        else:
            log.warning("PBCH decode failed")


if __name__ == "__main__":
    main()
