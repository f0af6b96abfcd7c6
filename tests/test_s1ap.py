"""S1AP codec + procedure tests (36.413; srsenb/srsepc s1ap parity).

Covers the codecs' round-trips, the MME/eNB endpoints, and the full
UE->eNB->S1AP(socket)->MME attach — the reference's
srsepc/src/mme/s1ap_nas_transport + s1ap_ctx_mngmt_proc flow.
"""

import numpy as np
import pytest

from empower_srslte_tpu.s1ap import messages as S


class TestCodecs:
    def test_initial_ue_message_roundtrip(self):
        pdu = S.pack_initial_ue_message(11, b"\x07\x41\x01", "001", "01",
                                        7, 0x1A2D001)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert kind == S.INITIATING and proc == S.PROC_INITIAL_UE_MESSAGE
        assert S.get_nas(ies) == b"\x07\x41\x01"
        assert S.get_ue_ids(ies) == (None, 11)
        assert S.dec_tai(ies[S.IE_TAI]) == ("001", "01", 7)
        assert S.dec_cgi(ies[S.IE_EUTRAN_CGI]) == ("001", "01", 0x1A2D001)

    def test_plmn_three_digit_mnc(self):
        pdu = S.pack_initial_ue_message(1, b"\x00", "310", "410", 5, 9)
        _, _, ies = S.unpack_pdu(pdu)
        assert S.dec_tai(ies[S.IE_TAI]) == ("310", "410", 5)

    def test_s1_setup_roundtrip(self):
        pdu = S.pack_s1_setup_request("001", "01", 0x19B, "srs-enb", 7)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert proc == S.PROC_S1_SETUP
        req = S.unpack_s1_setup_request(ies)
        assert req == {"mcc": "001", "mnc": "01", "enb_id": 0x19B,
                       "enb_name": "srs-enb"}

    def test_initial_context_setup_roundtrip(self):
        k_enb = bytes(range(32))
        pdu = S.pack_initial_context_setup_request(
            5, 11, erab_id=5, teid=0xABCD,
            gtp_addr=bytes([172, 16, 0, 1]), security_key=k_enb,
            nas_pdu=b"\x27NAS")
        kind, proc, ies = S.unpack_pdu(pdu)
        assert proc == S.PROC_INITIAL_CONTEXT_SETUP
        assert S.get_ue_ids(ies) == (5, 11)
        assert ies[S.IE_SECURITY_KEY] == k_enb
        item = S.unpack_erab_setup_item(ies, with_nas=True)
        assert item["erab_id"] == 5 and item["qci"] == 9
        assert item["teid"] == 0xABCD
        assert item["addr"] == bytes([172, 16, 0, 1])
        assert item["nas_pdu"] == b"\x27NAS"

    def test_big_int_encoding(self):
        from empower_srslte_tpu.s1ap.per import AReader, AWriter

        for v in (0, 1, 255, 256, 65535, 16777215, 0xFFFFFFFF):
            w = AWriter()
            w.put_big_int(v)
            assert AReader(w.to_bytes()).get_big_int() == v

    def test_malformed_pdu(self):
        with pytest.raises(ValueError):
            S.unpack_pdu(b"\xFF\xFF")
        with pytest.raises((ValueError, KeyError, IndexError)):
            S.unpack_pdu(bytes(3))


def _epc():
    from empower_srslte_tpu.epc import Hss, Subscriber
    from empower_srslte_tpu.epc.mme import Mme, UeNas
    from empower_srslte_tpu.upper import security

    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    opc = security.milenage_opc(
        k, bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318"))
    imsi = "001010123456789"
    hss = Hss()
    hss.add_subscriber(Subscriber(name="t", auth_algo="mil", imsi=imsi,
                                  key=k, opc=opc))
    return Mme(hss), UeNas(imsi=imsi, key=k, opc=opc)


def _attach(ue, enb):
    srb, pdu = ue.connect()
    ul, dl, rnti = [(srb, pdu)], [], None
    for _ in range(30):
        if not ul and not dl:
            break
        while ul:
            s, p = ul.pop(0)
            for mr, ms, mp in enb.handle_ul(rnti if s != 0 else 0, s, p):
                rnti = mr
                dl.append((ms, mp))
        while dl:
            s, p = dl.pop(0)
            ul.extend(ue.handle_dl(s, p))
    return rnti


class TestProcedures:
    def test_attach_over_inmemory_s1ap(self):
        from empower_srslte_tpu.rrc.procedures import EnbRrc, UeRrc
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme, ue_nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        enb_s1 = EnbS1ap(send=mme_s1.handle)
        ue = UeRrc(nas=ue_nas)
        enb = EnbRrc(mme=enb_s1)
        _attach(ue, enb)
        assert ue.nas.attached and ue.drbs == [1]
        assert "initial_ctx_setup_request" in mme_s1.events
        assert "initial_ctx_setup_complete" in mme_s1.events
        assert "s1_setup_srs-enb" in mme_s1.events

    def test_attach_over_socket_s1ap(self):
        from empower_srslte_tpu.rrc.procedures import EnbRrc, UeRrc
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap
        from empower_srslte_tpu.s1ap.transport import S1Client, S1Server

        mme, ue_nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        server = S1Server(mme_s1.handle)
        client = S1Client("127.0.0.1", server.port)
        try:
            enb_s1 = EnbS1ap(send=client)
            assert enb_s1.s1_setup()
            ue = UeRrc(nas=ue_nas)
            enb = EnbRrc(mme=enb_s1)
            _attach(ue, enb)
            assert ue.nas.attached
            assert ue.nas.ue_ip.startswith("172.16.0.")
        finally:
            client.close()
            server.close()

    def test_ue_context_release(self):
        from empower_srslte_tpu.s1ap.procedures import MmeS1ap

        mme, _ = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        cmd = S.pack_ue_context_release_command(5, 11)
        kind, proc, ies = S.unpack_pdu(cmd)
        assert proc == S.PROC_UE_CONTEXT_RELEASE and S.IE_CAUSE in ies
        mme_s1.handle(S.pack_ue_context_release_complete(5, 11))
        assert "ue_context_released" in mme_s1.events

    def test_paging_pack(self):
        from empower_srslte_tpu.s1ap.procedures import MmeS1ap

        mme, _ = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        pdu = mme_s1.page(0xDEADBEEF, 0x1A, tac=7)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert proc == S.PROC_PAGING
        assert S.IE_UE_PAGING_ID in ies and S.IE_TAI_LIST in ies


class TestAddedProcedures:
    """The remaining procedures the reference apps exercise
    (srsenb/src/upper/s1ap.cc:409-443 and the send_* family)."""

    def _attached(self):
        from empower_srslte_tpu.rrc.procedures import EnbRrc, UeRrc
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme, ue_nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        enb_s1 = EnbS1ap(send=mme_s1.handle)
        ue = UeRrc(nas=ue_nas)
        enb = EnbRrc(mme=enb_s1)
        rnti = _attach(ue, enb)
        assert ue.nas.attached
        return mme_s1, enb_s1, enb, ue, rnti

    def test_ue_capabilities_forwarded_over_s1(self):
        mme_s1, enb_s1, enb, ue, rnti = self._attached()
        srb, _, pdu = enb.send_capability_enquiry(rnti)
        for s, p in ue.handle_dl(srb, pdu):
            enb.handle_ul(rnti, s, p)
        assert "capabilities_forwarded" in enb_s1.events
        assert "ue_capabilities_stored" in mme_s1.events
        cap = list(mme_s1.ue_capabilities.values())[0]
        assert len(cap) > 0

    def test_erab_setup_request_response(self):
        mme_s1, enb_s1, enb, ue, rnti = self._attached()
        enb_ue = list(mme_s1.ue_ids)[0]
        req = mme_s1.setup_bearer(enb_ue, erab_id=6, qci=8, teid=0x77,
                                  gtp_addr=bytes([172, 16, 255, 1]),
                                  nas_pdu=b"\x27activate-dedicated")
        directives = enb_s1._directives([req])
        assert directives and directives[0][0] == "erab_setup"
        _, erab_id, qci, teid, addr, nas = directives[0]
        assert (erab_id, qci, teid) == (6, 8, 0x77)
        assert nas == b"\x27activate-dedicated"
        assert any(e.startswith("erab_setup_complete") for e in mme_s1.events)

    def test_enb_initiated_release(self):
        mme_s1, enb_s1, enb, ue, rnti = self._attached()
        directives = enb_s1.release_request()
        assert ("release",) in directives
        assert "release_requested" in mme_s1.events
        assert "released" in enb_s1.events
        assert "ue_context_released" in mme_s1.events

    def test_initial_ctx_setup_failure(self):
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme, _ = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        enb_s1 = EnbS1ap(send=mme_s1.handle)
        enb_s1._current_ue = 3
        directives = enb_s1.initial_ctx_setup_failure()
        assert "initial_ctx_setup_failure" in mme_s1.events
        assert ("release",) in directives  # MME commands release; eNB acks

    def test_cause_codec(self):
        for group, value in [(0, 21), (1, 1), (2, 0), (3, 5), (4, 2)]:
            assert S._dec_cause(S._enc_cause(group, value)) == (group, value)


class TestS1Handover:
    """S1-based inter-eNB handover relay (36.413 8.4): source eNB ->
    MME -> target eNB -> command -> status transfer -> notify ->
    source release. The reference ships these codecs in liblte_s1ap but
    its apps only do intra-eNB RRC handover; this completes the S1 leg."""

    def test_codec_roundtrips(self):
        pdu = S.pack_handover_required(5, 11, "001", "01", 0x20, 7, b"ctx")
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_HANDOVER_PREPARATION)
        assert S.dec_target_enb_id(ies[S.IE_TARGET_ID])["enb_id"] == 0x20
        pdu = S.pack_handover_request(5, 5, 9, 0x44, bytes(4), b"c",
                                      bytes(range(32)), 2)
        _, _, ies = S.unpack_pdu(pdu)
        req = S.unpack_handover_request(ies)
        assert req["ncc"] == 2 and req["nh"] == bytes(range(32))
        pdu = S.pack_status_transfer(5, 11, [(5, 100, 3, 200, 4)])
        _, _, ies = S.unpack_pdu(pdu)
        assert S.unpack_status_transfer(ies) == [
            {"erab_id": 5, "ul_count": (100, 3), "dl_count": (200, 4)}]

    def test_full_s1_handover_flow(self):
        from empower_srslte_tpu.rrc.procedures import EnbRrc, UeRrc
        from empower_srslte_tpu.s1ap.procedures import (EnbS1ap,
                                                        EnbS1apTarget,
                                                        MmeS1ap)

        mme, ue_nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        src = EnbS1ap(send=mme_s1.handle, enb_id=0x19B)
        target = EnbS1apTarget(prepare=lambda req: b"rrc-reconf-mobility")
        mme_s1.attach_enb_link(0x19B, lambda pdu: (src.deliver(pdu), [])[1])
        mme_s1.attach_enb_link(0x2AA, target.handle)

        # attach the UE through the source eNB first
        ue = UeRrc(nas=ue_nas)
        enb = EnbRrc(mme=src)
        _attach(ue, enb)
        assert ue.nas.attached

        # source decides to hand over (e.g. after an A3 report)
        directives = src.handover_required(0x2AA, b"src-enb-rrc-context",
                                           bearers=[(5, 7, 0, 9, 0)])
        cmds = [d for d in directives if d[0] == "handover_command"]
        assert cmds and cmds[0][1] == b"rrc-reconf-mobility"
        assert "handover_request" in target.events
        assert target.last_request["container"] == b"src-enb-rrc-context"
        assert target.last_request["ncc"] == 1
        assert len(target.last_request["nh"]) == 32
        assert "status_received" in target.events
        assert target.counts[0]["ul_count"] == (7, 0)

        # UE arrives at the target -> notify -> source released
        target.notify_arrival(mme_s1)
        assert "handover_notify" in mme_s1.events
        assert "source_released" in mme_s1.events
        # the MME now maps the target's eNB-UE id
        assert mme_s1.ue_ids[target.last_request["enb_ue"]] == \
            target.last_request["mme_ue"]


class TestInterEnbHandover:
    """Full inter-eNB S1 handover at the RRC level: A3 report at the
    source -> HandoverRequired -> target RRC admission (K_eNB* from the
    MME's NH/NCC) -> HandoverCommand forwarded by the source -> UE NH
    chain re-keying -> ReconfigurationComplete accepted by the TARGET
    with the new keys -> HandoverNotify -> source release.

    (The reference only does intra-eNB handover, srsenb rrc.cc; this is
    the S1 leg its liblte_s1ap codecs support but its apps never use.)"""

    def test_inter_enb_s1_handover(self):
        from empower_srslte_tpu.rrc.procedures import EnbRrc, UeRrc
        from empower_srslte_tpu.s1ap.procedures import (EnbS1ap,
                                                        EnbS1apTarget,
                                                        MmeS1ap)

        mme, ue_nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        src_s1 = EnbS1ap(send=mme_s1.handle, enb_id=0x19B)
        src = EnbRrc(mme=src_s1, pci=1, neighbor_enbs={2: 0x2AA})
        tgt = EnbRrc(mme=src_s1, pci=2, next_c_rnti=0x60)
        tgt_s1 = EnbS1apTarget(prepare=tgt.prepare_handover)
        mme_s1.attach_enb_link(0x19B,
                               lambda pdu: (src_s1.deliver(pdu), [])[1])
        mme_s1.attach_enb_link(0x2AA, tgt_s1.handle)

        ue = UeRrc(nas=ue_nas)
        rnti = _attach(ue, src)
        assert ue.nas.attached

        # A3 event: neighbour pci 2 (served by the other eNB) is stronger
        srb, mr = ue.send_measurement_report(50, 20, [(2, 70, 25)])
        dl = src.handle_ul(rnti, srb, mr)
        assert "s1_handover_cmd" in src.events
        assert any(e.startswith("ho_admitted") for e in tgt.events)
        assert "handover_request" in tgt_s1.events

        # UE executes: NH-chain re-key + complete toward the TARGET
        ul = ue.handle_dl(dl[0][1], dl[0][2])
        assert "nh_chain_ncc1" in ue.events
        assert "handover_to_2" in ue.events and ue.serving_pci == 2
        new_rnti = [r for r in tgt.ues][0]
        assert ue.c_rnti == new_rnti
        for s, p in ul:
            tgt.handle_ul(new_rnti, s, p)
        # the complete decoded under the target's K_eNB*-derived keys:
        # key agreement UE<->MME<->target proven end to end
        assert "integrity_failure" not in tgt.events
        assert "reconfig_complete" in tgt.events
        assert tgt.ues[new_rnti]["state"] == "reconfigured"

        # arrival -> notify -> source context released
        tgt_s1.notify_arrival(mme_s1)
        assert "source_released" in mme_s1.events
        assert "released" in src_s1.events


class TestManagementProcedures:
    """Reset / Error Indication / E-RAB Release / E-RAB Modify —
    completing the 36.413 elementary-procedure families (codec surface
    of liblte_s1ap.cc beyond what srsenb/srsepc originate)."""

    def test_reset_codec_roundtrips(self):
        pdu = S.pack_reset(cause=(4, 1))
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_RESET)
        r = S.unpack_reset(ies)
        assert r["reset_all"] and r["cause"] == (4, 1)

        pdu = S.pack_reset(partial=[(7, 3), (None, 9)])
        _, _, ies = S.unpack_pdu(pdu)
        r = S.unpack_reset(ies)
        assert not r["reset_all"]
        assert r["partial"] == [(7, 3), (None, 9)]

        pdu = S.pack_reset_ack(partial=[(7, 3)])
        kind, proc, ies = S.unpack_pdu(pdu)
        assert kind == S.SUCCESSFUL
        assert S.unpack_reset_ack(ies)["partial"] == [(7, 3)]

    def test_error_indication_codec(self):
        pdu = S.pack_error_indication(mme_ue_id=5, enb_ue_id=2,
                                      cause=(3, 1))
        kind, proc, ies = S.unpack_pdu(pdu)
        assert proc == S.PROC_ERROR_INDICATION
        e = S.unpack_error_indication(ies)
        assert e == dict(mme_ue_id=5, enb_ue_id=2, cause=(3, 1))
        # all-optional: empty is legal
        pdu = S.pack_error_indication(cause=None)
        _, _, ies = S.unpack_pdu(pdu)
        e = S.unpack_error_indication(ies)
        assert e["cause"] is None and e["mme_ue_id"] is None

    def test_erab_release_codec(self):
        pdu = S.pack_erab_release_command(
            10, 20, [(5, (0, 21)), (6, (2, 0))], nas_pdu=b"\x27NAS")
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_ERAB_RELEASE)
        c = S.unpack_erab_release_command(ies)
        assert c["erabs"] == [(5, (0, 21)), (6, (2, 0))]
        assert c["nas_pdu"] == b"\x27NAS"
        pdu = S.pack_erab_release_response(10, 20, [5, 6])
        _, _, ies = S.unpack_pdu(pdu)
        assert S.unpack_erab_release_response(ies)["released"] == [5, 6]

    def test_erab_modify_codec(self):
        pdu = S.pack_erab_modify_request(10, 20, [(5, 7, b"\x27MOD")])
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_ERAB_MODIFY)
        m = S.unpack_erab_modify_request(ies)
        assert m["erabs"] == [(5, 7, b"\x27MOD")]
        pdu = S.pack_erab_modify_response(10, 20, [5])
        _, _, ies = S.unpack_pdu(pdu)
        assert S.unpack_erab_modify_response(ies)["modified"] == [5]

    def test_reset_flow_enb_to_mme(self):
        from empower_srslte_tpu.s1ap.procedures import MmeS1ap

        mme, _nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        mme_s1.ue_ids = {1: 100, 2: 101, 3: 102}
        # partial reset drops only the named connections
        resp = mme_s1.handle(S.pack_reset(partial=[(101, 2)]))
        assert mme_s1.ue_ids == {1: 100, 3: 102}
        kind, proc, ies = S.unpack_pdu(resp[0])
        assert (kind, proc) == (S.SUCCESSFUL, S.PROC_RESET)
        # full reset drops everything
        resp = mme_s1.handle(S.pack_reset())
        assert mme_s1.ue_ids == {}
        assert "reset_all" in mme_s1.events

    def test_reset_flow_mme_to_enb(self):
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme, _nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        enb_s1 = EnbS1ap(send=mme_s1.handle)
        out = enb_s1.deliver(mme_s1.reset())
        assert out == [("reset", True, None)]
        assert "reset_acked" in mme_s1.events

    def test_erab_release_and_modify_flow(self):
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme, _nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        enb_s1 = EnbS1ap(send=mme_s1.handle)
        mme_s1.ue_ids[1] = 7
        out = enb_s1.deliver(mme_s1.release_bearers(
            1, [(6, (0, 21))], nas_pdu=b"\x27D"))
        assert out == [("erab_release", [6], b"\x27D")]
        assert any(e.startswith("erab_released_") for e in mme_s1.events)
        out = enb_s1.deliver(mme_s1.modify_bearers(1, [(5, 7, b"\x27M")]))
        assert out == [("erab_modify", [(5, 7, b"\x27M")])]
        assert any(e.startswith("erab_modified_") for e in mme_s1.events)

    def test_unknown_pdu_triggers_error_indication(self):
        from empower_srslte_tpu.s1ap.procedures import MmeS1ap

        mme, _nas = _epc()
        mme_s1 = MmeS1ap(mme=mme)
        # a procedure the MME does not serve (handover notify kind
        # mismatch): craft an initiating PDU with an unused proc code
        bogus = S._pdu(S.INITIATING, 40, S.CRIT_IGNORE, S._enc_ies([]))
        resp = mme_s1.handle(bogus)
        kind, proc, ies = S.unpack_pdu(resp[0])
        assert proc == S.PROC_ERROR_INDICATION
        assert S.unpack_error_indication(ies)["cause"] == (3, 1)


class TestInterfaceManagementTail:
    """eNB/MME Configuration Update, Overload Start/Stop, NAS Non-
    Delivery Indication, Write-Replace Warning — the last four
    procedure families of liblte_s1ap.cc (liblte_s1ap.h:89-109 codes
    16/29/30/34/35/36)."""

    def test_nas_non_delivery_codec(self):
        pdu = S.pack_nas_non_delivery_indication(5, 2, b"\x07\x4B",
                                                 cause=(0, 25))
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_NAS_NON_DELIVERY)
        d = S.unpack_nas_non_delivery_indication(ies)
        assert d == dict(mme_ue_id=5, enb_ue_id=2, nas_pdu=b"\x07\x4B",
                         cause=(0, 25))

    def test_enb_configuration_update_codec(self):
        pdu = S.pack_enb_configuration_update(enb_name="new-name",
                                              tac=99, paging_drx=0x40)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING,
                                S.PROC_ENB_CONFIGURATION_UPDATE)
        u = S.unpack_enb_configuration_update(ies)
        assert u["enb_name"] == "new-name" and u["tac"] == 99
        assert u["paging_drx"] == 0x40
        ack = S.pack_enb_configuration_update_ack()
        kind, proc, _ = S.unpack_pdu(ack)
        assert kind == S.SUCCESSFUL

    def test_mme_configuration_update_codec(self):
        pdu = S.pack_mme_configuration_update(mme_name="mme2", mcc="001",
                                              mnc="01", mme_group=3,
                                              mme_code=9, capacity=80)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING,
                                S.PROC_MME_CONFIGURATION_UPDATE)
        u = S.unpack_mme_configuration_update(ies)
        assert u["mme_name"] == "mme2" and u["mme_group"] == 3
        assert u["mme_code"] == 9 and u["capacity"] == 80

    def test_overload_codec(self):
        pdu = S.pack_overload_start(S.OVERLOAD_REJECT_ALL)
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING, S.PROC_OVERLOAD_START)
        assert S.unpack_overload_start(ies)["action"] \
            == S.OVERLOAD_REJECT_ALL
        kind, proc, _ = S.unpack_pdu(S.pack_overload_stop())
        assert (kind, proc) == (S.INITIATING, S.PROC_OVERLOAD_STOP)

    def test_write_replace_warning_codec(self):
        pdu = S.pack_write_replace_warning_request(
            0x1102, 0x3000, repetition_period=512, num_broadcast=4,
            coding_scheme=0x01, contents=b"EARTHQUAKE WARNING")
        kind, proc, ies = S.unpack_pdu(pdu)
        assert (kind, proc) == (S.INITIATING,
                                S.PROC_WRITE_REPLACE_WARNING)
        w = S.unpack_write_replace_warning_request(ies)
        assert w["message_id"] == 0x1102 and w["serial"] == 0x3000
        assert w["repetition_period"] == 512 and w["num_broadcast"] == 4
        assert w["contents"] == b"EARTHQUAKE WARNING"
        resp = S.pack_write_replace_warning_response(0x1102, 0x3000)
        kind, _, ies = S.unpack_pdu(resp)
        assert kind == S.SUCCESSFUL
        assert S.unpack_write_replace_warning_response(ies) \
            == dict(message_id=0x1102, serial=0x3000)

    def _pair(self):
        from empower_srslte_tpu.epc import Hss, Subscriber
        from empower_srslte_tpu.epc.mme import Mme
        from empower_srslte_tpu.s1ap.procedures import EnbS1ap, MmeS1ap

        mme_s1 = MmeS1ap(mme=Mme(Hss()))
        enb = EnbS1ap(send=lambda pdu: mme_s1.handle(pdu))
        enb.s1_setup()
        return enb, mme_s1

    def test_enb_config_update_flow(self):
        enb, mme_s1 = self._pair()
        assert enb.configuration_update(enb_name="renamed", tac=8)
        assert any(e.startswith("enb_config_update")
                   for e in mme_s1.events)

    def test_overload_flow(self):
        enb, mme_s1 = self._pair()
        mme_s1.attach_enb_link(enb.enb_id,
                               lambda pdu: enb._directives([pdu]))
        mme_s1.overload_start(S.OVERLOAD_REJECT_NON_EMERGENCY_MO)
        assert enb.overload_action == S.OVERLOAD_REJECT_NON_EMERGENCY_MO
        mme_s1.overload_stop()
        assert enb.overload_action is None

    def test_warning_broadcast_flow(self):
        enb, mme_s1 = self._pair()
        mme_s1.attach_enb_link(enb.enb_id,
                               lambda pdu: enb._directives([pdu]))
        mme_s1.write_replace_warning(7, 1, contents=b"TSUNAMI")
        assert enb.warnings and enb.warnings[0]["contents"] == b"TSUNAMI"
        # the eNB responded; the MME recorded the broadcast confirmation
        assert any(e.startswith("warning_broadcast_7")
                   for e in mme_s1.events)

    def test_nas_non_delivery_flow(self):
        enb, mme_s1 = self._pair()
        enb._current_ue = 4
        enb.nas_non_delivery(b"\x07\x4B")
        assert any(e.startswith("nas_non_delivery")
                   for e in mme_s1.events)
