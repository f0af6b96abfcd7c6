"""Instrumented DL HARQ fade scenario (mirrors TestDlHarqOverTheAir)."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
from empower_srslte_tpu.backend import configure_compile_cache

configure_compile_cache()

from tests.test_stack import _epc
from empower_srslte_tpu.stack import Air, EnbStack, UeStack
from empower_srslte_tpu.utils.cell import Cell

mme, nas = _epc()
cell = Cell(nof_prb=25, id=1)
enb = EnbStack(cell, mme)
ue = UeStack(cell, nas)
air = Air(cell.sf_sample_len)
ul_iq, attached_at, sent_at = None, None, None
marks = {"enb": 0, "ue": 0}
for tti in range(120):
    air.snr_db = -5.0 if (sent_at is not None and tti == sent_at) else None
    dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
    ul_iq = ue.tti(tti, air.dl(dl_iq))
    for name, node in (("enb", enb), ("ue", ue)):
        ev = node.events
        for e in ev[marks[name]:]:
            print(f"tti {tti:3d} {name}: {e}", flush=True)
        marks[name] = len(ev)
    if attached_at is None and ue.rrc.nas.attached and ue.rrc.drbs:
        attached_at = tti
        print(f"tti {tti:3d} --- attached", flush=True)
    if (attached_at is not None and tti == attached_at + 14
            and sent_at is None):
        pong = (b"\x45\x00" + bytes(14)
                + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                + b"HARQ-COMBINED!!!")
        fwd = mme.spgw.downlink(pong)
        enb.deliver_gtpu(fwd[1])
        sent_at = tti + 1
        print(f"tti {tti:3d} --- pong queued, fade at {sent_at}", flush=True)
    if sent_at is not None and tti == sent_at:
        print(f"tti {tti:3d} --- FADE; dl_queues={ {r: len(q) for r, q in enb.dl_queues.items()} }", flush=True)
    if sent_at is not None and ue.rx_ip:
        print(f"tti {tti:3d} --- delivered: {ue.rx_ip[0][-16:]}", flush=True)
        break
print("rx_ip:", len(ue.rx_ip), "attached_at:", attached_at, "sent_at:", sent_at)
