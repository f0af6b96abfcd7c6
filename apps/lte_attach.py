#!/usr/bin/env python
"""Full-stack demo: srsUE + srsENB + srsEPC equivalents attach over an
IQ air interface, with S1AP over a local socket.

The integration the reference's three binaries perform (srsue/srsenb/
srsepc), in one process: PRACH -> RAR -> msg3/contention resolution ->
RRC connection -> NAS mutual auth -> AS security -> DRB setup.

  python apps/lte_attach.py [--prb 25] [--snr 15] [--imsi ...]

Runs on the accelerator JAX finds; JAX_PLATFORMS=cpu selects the CPU.
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--snr", type=float, default=None,
                    help="air SNR in dB (default: noiseless)")
    ap.add_argument("--imsi", default="001010123456789")
    ap.add_argument("--max-tti", type=int, default=100)
    args = ap.parse_args()

    import numpy as np

    from empower_srslte_tpu.backend import configure_compile_cache

    configure_compile_cache()

    from empower_srslte_tpu.epc import Hss, Subscriber
    from empower_srslte_tpu.epc.mme import Mme, UeNas
    from empower_srslte_tpu.runtime.logging import get_logger
    from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap
    from empower_srslte_tpu.s1ap.transport import S1Client, S1Server
    from empower_srslte_tpu.stack import Air, EnbStack, UeStack
    from empower_srslte_tpu.upper import security
    from empower_srslte_tpu.utils.cell import Cell

    log = get_logger("STACK", "info")

    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = security.milenage_opc(
        k, bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318"))
    hss = Hss()
    hss.add_subscriber(Subscriber(name="demo", auth_algo="mil",
                                  imsi=args.imsi, key=k, opc=opc))
    mme = Mme(hss)
    mme_s1 = MmeS1ap(mme=mme)
    server = S1Server(mme_s1.handle)
    client = S1Client("127.0.0.1", server.port)
    log.info("EPC up (S1AP on 127.0.0.1:%d)", server.port)

    cell = Cell(nof_prb=args.prb, id=1)
    enb = EnbStack(cell, EnbS1ap(send=client))
    ue = UeStack(cell, UeNas(imsi=args.imsi, key=k, opc=opc))
    air = Air(cell.sf_sample_len, snr_db=args.snr,
              h_dl=0.9 * np.exp(1j * 0.5), h_ul=0.85 * np.exp(-1j * 0.3))
    log.info("cell: %d PRB, id %d; air SNR: %s", args.prb, cell.id,
             f"{args.snr} dB" if args.snr is not None else "ideal")

    seen: set = set()

    def show(tag, events):
        for e in events:
            if (tag, e) not in seen:
                seen.add((tag, e))
                log.info("[%s] %s", tag, e)

    t0 = time.time()
    ul_iq = None
    for tti in range(args.max_tti):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        show("UE", ue.events)
        show("UE-RRC", ue.rrc.events)
        show("ENB", enb.events)
        show("MME", mme_s1.events)
        if ue.rrc.nas.attached and ue.rrc.drbs and not ue.rx_ip \
                and not enb.ul_gtpu and "ping_sent" not in seen:
            seen.add("ping_sent")
            log.info("ATTACH COMPLETE at tti %d (%.1fs wall): IP %s, "
                     "DRBs %s", tti, time.time() - t0, ue.rrc.nas.ue_ip,
                     ue.rrc.drbs)
            ue.send_ip(b"\x45\x00" + bytes(18) + b"PING-FROM-UE-01")
            pong = (b"\x45\x00" + bytes(14)
                    + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                    + b"PONG-TO-THE-UE!")
            fwd = mme.spgw.downlink(pong)
            if fwd is not None:
                enb.deliver_gtpu(fwd[1])
        if enb.ul_gtpu and ue.rx_ip:
            from empower_srslte_tpu.upper.gtpu import gtpu_unpack

            log.info("USER PLANE: UL %r at SP-GW, DL %r at UE",
                     gtpu_unpack(enb.ul_gtpu[0])[1][-15:],
                     ue.rx_ip[0][-15:])
            break
    else:
        log.error("attach did not complete in %d ttis", args.max_tti)
        server.close()
        client.close()
        return 1
    server.close()
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
