"""Instrumented two-UE attach run: prints per-TTI events for debugging."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

from empower_srslte_tpu.backend import configure_compile_cache

configure_compile_cache()

import numpy as np
from empower_srslte_tpu.epc import Hss, Subscriber
from empower_srslte_tpu.epc.mme import Mme, UeNas
from empower_srslte_tpu.stack import Air, EnbStack, UeStack
from empower_srslte_tpu.upper import security
from empower_srslte_tpu.utils.cell import Cell


def _epc_two():
    hss = Hss()
    subs = []
    for i, imsi in enumerate(("001010123456789", "001010123456790")):
        k = bytes([0x46 + i]) + bytes.fromhex("5b5ce8b199b49faa5f0a2ee238a6bc")
        opc = security.milenage_opc(
            k, bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318"))
        hss.add_subscriber(Subscriber(name=f"u{i}", auth_algo="mil",
                                      imsi=imsi, key=k, opc=opc))
        subs.append(UeNas(imsi=imsi, key=k, opc=opc))
    return Mme(hss), subs


mme, (nas1, nas2) = _epc_two()
cell = Cell(nof_prb=25, id=1)
enb = EnbStack(cell, mme)
ue1 = UeStack(cell, nas1, preamble=7, ra_delay_frames=0)
ue2 = UeStack(cell, nas2, preamble=23, ra_delay_frames=2)
air = Air(cell.sf_sample_len)

marks = {"enb": 0, "ue1": 0, "ue2": 0}
ul1 = ul2 = None
pinged = set()
for tti in range(200):
    if tti and tti % 50 == 0:
        jax.clear_caches()
    ul_sum = None
    for u in (ul1, ul2):
        if u is not None:
            ul_sum = u if ul_sum is None else ul_sum + u
    dl_iq = enb.tti(tti, air.ul(ul_sum) if ul_sum is not None else None)
    dl = air.dl(dl_iq)
    ul1 = ue1.tti(tti, dl)
    ul2 = ue2.tti(tti, dl)
    for name, node in (("enb", enb), ("ue1", ue1), ("ue2", ue2)):
        ev = node.events
        for e in ev[marks[name]:]:
            print(f"tti {tti:3d} {name}: {e}", flush=True)
        marks[name] = len(ev)
    for i, ue in enumerate((ue1, ue2)):
        if i not in pinged and ue.rrc.nas.attached and ue.rrc.drbs:
            pinged.add(i)
            print(f"tti {tti:3d} ue{i+1}: >>> attached, sending ping",
                  flush=True)
            ue.send_ip(b"\x45\x00" + bytes(18) + b"PING-FROM-UE-%d!" % i)
    if len(enb.ul_gtpu) >= 2:
        print(f"tti {tti:3d}: both pings received", flush=True)
        break

print("ue1 attached:", ue1.rrc.nas.attached, "drbs:", len(ue1.rrc.drbs))
print("ue2 attached:", ue2.rrc.nas.attached, "drbs:", len(ue2.rrc.drbs))
print("ul_gtpu:", len(enb.ul_gtpu))
from empower_srslte_tpu.upper.gtpu import gtpu_unpack
for p in enb.ul_gtpu:
    print("  gtpu payload tail:", gtpu_unpack(p)[1][-15:])
