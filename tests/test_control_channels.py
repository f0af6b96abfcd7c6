"""Control channel tests: PBCH, PCFICH, PHICH, PDCCH blind decoding, REGs.

Mirrors the reference's phch test tier: pbch_test, pcfich_test,
phich_test, pdcch_test over ports/PRB sweeps (SURVEY.md section 4).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from empower_srslte_tpu.models import dci as dci_mod
from empower_srslte_tpu.models import ra
from empower_srslte_tpu.models.pbch import (
    mib_pack,
    mib_unpack,
    pbch_decode,
    pbch_put,
    pbch_re_indices,
)
from empower_srslte_tpu.models.pcfich import pcfich_decode, pcfich_put
from empower_srslte_tpu.models.pdcch import (
    pdcch_blind_decode,
    pdcch_encode,
    ue_search_candidates,
)
from empower_srslte_tpu.models.phich import phich_decode, phich_put
from empower_srslte_tpu.models.regs import (
    pcfich_regs,
    pdcch_nof_cces,
    pdcch_reg_map,
    phich_regs,
    symbol_regs,
)
from empower_srslte_tpu.utils import Cell


def _flat_channel(rng, shape, scale=1.0):
    return (scale * (0.7 + 0.1 * rng.normal()) *
            np.exp(1j * rng.uniform(-np.pi, np.pi))) * np.ones(shape, np.complex64)


class TestRegs:
    @pytest.mark.parametrize("prb", [6, 25, 50, 100])
    def test_symbol0_reg_count(self, prb):
        cell = Cell(nof_prb=prb, id=7)
        assert len(symbol_regs(cell, 0)) == 2 * prb
        assert len(symbol_regs(cell, 2)) == 3 * prb

    def test_no_overlap_pcfich_phich(self):
        cell = Cell(nof_prb=50, id=11)
        pc = set(pcfich_regs(cell))
        assert len(pc) == 4
        for trip in phich_regs(cell, 1.0):
            assert not (set(trip) & pc)

    @pytest.mark.parametrize("prb,cfi", [(6, 2), (25, 1), (50, 3), (100, 1)])
    def test_pdcch_map_unique(self, prb, cfi):
        cell = Cell(nof_prb=prb, id=3)
        m = pdcch_reg_map(cell, cfi)
        flat = m.reshape(-1)
        assert len(np.unique(flat)) == len(flat)  # no RE reused
        assert pdcch_nof_cces(cell, cfi) >= 1

    def test_regs_avoid_crs(self):
        cell = Cell(nof_prb=25, id=5)
        vshift = cell.id % 6
        for reg in symbol_regs(cell, 0):
            for k in reg:
                assert (k - vshift) % 3 != 0


class TestPbch:
    def test_mib_roundtrip(self):
        bits = mib_pack(50, 0, 1, 444)
        m = mib_unpack(bits)
        assert m["nof_prb"] == 50 and m["sfn_msb"] == 444 >> 2

    def test_re_count(self):
        assert len(pbch_re_indices(Cell(nof_prb=6, id=3))) == 240

    @pytest.mark.parametrize("sfn_q", [0, 1, 2, 3])
    def test_roundtrip_quarters(self, sfn_q, rng):
        cell = Cell(nof_prb=6, id=13, nof_ports=1)
        mib = mib_pack(50, 0, 1, 4 * 25 + sfn_q)
        grid = jnp.zeros((1, 1, 14, 72), jnp.complex64)
        grid = pbch_put(grid, jnp.asarray(mib), cell, sfn=4 * 25 + sfn_q)
        h = np.full((1, 14, 72), 0.8 - 0.2j, np.complex64)
        rx = grid[:, 0] * jnp.asarray(h)
        rx = rx + 0.02 * jnp.asarray(
            (rng.normal(size=rx.shape) + 1j * rng.normal(size=rx.shape))
        ).astype(jnp.complex64)
        bits, q, ports, ok = pbch_decode(rx, jnp.asarray(h), cell)
        assert bool(np.asarray(ok)[0])
        assert int(np.asarray(q)[0]) == sfn_q
        assert int(np.asarray(ports)[0]) == 1
        assert np.array_equal(np.asarray(bits)[0], mib)


class TestPcfich:
    @pytest.mark.parametrize("cfi", [1, 2, 3])
    def test_roundtrip(self, cfi, rng):
        cell = Cell(nof_prb=25, id=9)
        grid = jnp.zeros((1, 1, 14, 300), jnp.complex64)
        grid = pcfich_put(grid, cfi, cell, sf_idx=4)
        h = _flat_channel(rng, (1, 14, 300))
        rx = grid[:, 0] * jnp.asarray(h) + 0.05 * jnp.asarray(
            (rng.normal(size=(1, 14, 300)) + 1j * rng.normal(size=(1, 14, 300)))
        ).astype(jnp.complex64)
        got, corr = pcfich_decode(rx, jnp.asarray(h), cell, 4)
        assert int(np.asarray(got)[0]) == cfi


class TestPhich:
    @pytest.mark.parametrize("ack,seq", [(1, 0), (0, 3), (1, 5)])
    def test_roundtrip(self, ack, seq, rng):
        cell = Cell(nof_prb=25, id=17)
        grid = jnp.zeros((1, 1, 14, 300), jnp.complex64)
        grid = phich_put(grid, ack, cell, sf_idx=2, group=0, seq_idx=seq)
        h = _flat_channel(rng, (1, 14, 300))
        rx = grid[:, 0] * jnp.asarray(h) + 0.05 * jnp.asarray(
            (rng.normal(size=(1, 14, 300)) + 1j * rng.normal(size=(1, 14, 300)))
        ).astype(jnp.complex64)
        got, corr = phich_decode(rx, jnp.asarray(h), cell, 2, group=0, seq_idx=seq)
        assert bool(np.asarray(got)[0]) == bool(ack)


class TestDci:
    def test_riv_roundtrip(self):
        for n in (6, 25, 50, 100):
            for start, length in [(0, 1), (1, min(5, n - 1)), (0, n), (n - 3, 3)]:
                riv = ra.riv_encode(n, start, length)
                assert ra.riv_decode(riv, n) == (start, length)

    def test_format1a_pack_unpack(self):
        bits = dci_mod.pack_format1a(50, start=10, length=20, mcs=15, rv=2)
        assert len(bits) == dci_mod.format0_1a_size(50)
        d = dci_mod.unpack_format1a(bits, 50)
        assert d.mcs == 15 and d.rv == 2
        assert sum(d.prb_mask) == 20 and d.prb_mask[10]

    def test_format0_同size(self):
        # formats 0 and 1A are size-matched by construction
        b0 = dci_mod.pack_format0(100, 0, 50, 10)
        b1 = dci_mod.pack_format1a(100, 0, 50, 10)
        assert len(b0) == len(b1)

    def test_mcs_tbs(self):
        mod, tbs = ra.mcs_to_tbs(9, 50)
        assert mod.name == "QPSK" and tbs == ra.tbs_lookup(9, 50)
        mod64, _ = ra.mcs_to_tbs(28, 100)
        assert mod64.name == "QAM64"


class TestPdcch:
    def test_search_space_properties(self):
        cands = ue_search_candidates(0x1234, 3, 42)
        assert all(cce + l <= 42 for l, cce in cands)
        assert any(l == 4 and cce == 0 for l, cce in cands)  # common space

    @pytest.mark.parametrize("l_agg", [1, 2, 4, 8])
    def test_blind_decode_roundtrip(self, l_agg, rng):
        cell = Cell(nof_prb=50, id=1)
        cfi, sf_idx, rnti = 3, 3, 0x404F
        n_cce = pdcch_nof_cces(cell, cfi)
        cands = [c for l, c in ue_search_candidates(rnti, sf_idx, n_cce)
                 if l == l_agg]
        if not cands:
            pytest.skip("no candidate at this aggregation")
        cce = cands[0]
        size = dci_mod.format0_1a_size(cell.nof_prb)
        payload = dci_mod.pack_format1a(cell.nof_prb, 5, 12, 7)
        grid = pdcch_encode(jnp.asarray(payload), rnti, cce, l_agg, cell,
                            cfi, sf_idx)
        h = _flat_channel(rng, (14, 600))
        rx = grid[0] * jnp.asarray(h) + 0.03 * jnp.asarray(
            (rng.normal(size=(14, 600)) + 1j * rng.normal(size=(14, 600)))
        ).astype(jnp.complex64)
        hits = pdcch_blind_decode(rx, jnp.asarray(h), cell, cfi, sf_idx,
                                  rnti, (size,))
        assert len(hits) == 1
        # a high-aggregation PDCCH may also pass CRC at a nested lower-L
        # candidate covering its repetition-coded prefix; the payload is
        # what matters
        assert hits[0].cce == cce
        assert np.array_equal(hits[0].payload, payload)
        d = dci_mod.unpack_format1a(hits[0].payload, cell.nof_prb)
        assert d.mcs == 7 and sum(d.prb_mask) == 12

    def test_no_false_alarm_wrong_rnti(self, rng):
        cell = Cell(nof_prb=50, id=1)
        cfi, sf_idx = 2, 1
        payload = dci_mod.pack_format1a(cell.nof_prb, 0, 10, 5)
        grid = pdcch_encode(jnp.asarray(payload), 0x1111, 0, 4, cell, cfi, sf_idx)
        h = _flat_channel(rng, (14, 600))
        rx = grid[0] * jnp.asarray(h)
        size = dci_mod.format0_1a_size(cell.nof_prb)
        hits = pdcch_blind_decode(rx, jnp.asarray(h), cell, cfi, sf_idx,
                                  0x2222, (size,))
        assert len(hits) == 0


class TestDciFormat2:
    def test_pack_unpack(self):
        bits = dci_mod.pack_format2(50, rbg_bitmap=0x1FFFF, mcs=(12, 14),
                                    harq_pid=3, rv=(0, 2), pmi=1)
        assert len(bits) == dci_mod.format2_size(50)
        d = dci_mod.unpack_format2(bits, 50)
        assert d.mcs == (12, 14) and d.rv == (0, 2)
        assert d.harq_pid == 3 and d.pmi == 1
        assert d.n_prb == 50  # all 17 RBGs, last one truncated

    def test_sizes_distinct(self):
        for n in (25, 50, 100):
            assert dci_mod.format2_size(n) != dci_mod.format0_1a_size(n)
            assert dci_mod.format2_size(n) != dci_mod.format1_size(n)


class TestDciCompactFormats:
    """Formats 1B/1C/1D + distributed VRB (dci.c:777-1206, ra.c:353-420)."""

    def test_sizes_match_reference_table(self):
        # expected values from the reference's precomputed dci_sz_table.h
        expected_1c = {6: 8, 15: 10, 25: 12, 50: 13, 75: 14, 100: 15}
        for n, e in expected_1c.items():
            assert dci_mod.format1c_size(n) == e
        # 1B == 1D and avoids ambiguous sizes
        for n in (6, 15, 25, 50, 75, 100):
            s = dci_mod.format1b_size(n)
            assert s == dci_mod.format1d_size(n)
            assert s not in dci_mod.AMBIGUOUS_SIZES

    @pytest.mark.parametrize("n_prb", [6, 25, 50, 100])
    def test_format1b_roundtrip(self, n_prb):
        b = dci_mod.pack_format1b(n_prb, 1, 3, mcs=9, harq_pid=5, ndi=1,
                                  rv=2, pinfo=1, pmi_confirm=1)
        d = dci_mod.unpack_format1b(b, n_prb)
        assert (d.mcs, d.harq_pid, d.ndi, d.rv, d.pinfo, d.flag) == \
            (9, 5, 1, 2, 1, 1)
        assert d.n_prb == 3 and not d.dist

    @pytest.mark.parametrize("n_prb", [6, 25, 50, 100])
    def test_format1d_distributed(self, n_prb):
        from empower_srslte_tpu.models import ra as ra_mod

        nvrb = ra_mod.type2_n_vrb_dl(n_prb, True)
        L = min(4, nvrb)
        b = dci_mod.pack_format1d(n_prb, 0, L, mcs=4, dist=True,
                                  power_offset=1)
        d = dci_mod.unpack_format1d(b, n_prb)
        assert d.dist and d.n_prb == L and sum(d.prb_mask_slot1) == L
        # slot hop: each individual VRB maps to different PRBs in the two
        # slots (the full *set* may coincide for symmetric allocations)
        m0, m1 = ra_mod.prb_mask_type2_dist(n_prb, 0, 1, True)
        assert m0 != m1

    def test_format1c_roundtrip(self):
        from empower_srslte_tpu.models import ra as ra_mod

        for n_prb in (6, 25, 50, 100):
            step = ra_mod.type2_n_rb_step(n_prb)
            c = dci_mod.pack_format1c(n_prb, 0, step * 2, i_tbs=11)
            assert len(c) == dci_mod.format1c_size(n_prb)
            d = dci_mod.unpack_format1c(c, n_prb)
            assert d.i_tbs == 11 and d.n_prb == step * 2

    def test_dist_mapping_is_permutation(self):
        from empower_srslte_tpu.models import ra as ra_mod

        # mapping the full DVRB range must hit each PRB at most once
        for n_prb in (25, 50):
            nvrb = ra_mod.type2_n_vrb_dl(n_prb, True)
            m0, m1 = ra_mod.prb_mask_type2_dist(n_prb, 0, nvrb, True)
            assert sum(m0) == nvrb and sum(m1) == nvrb


class TestViterbiHalo:
    """The 40-step circular-halo tail-biting Viterbi (the default) must
    reproduce the full-copy wrap decode (train=None) — the halo is the
    classic >=5-constraint-length truncation depth, so decisions match
    at any workable SNR."""

    @pytest.mark.parametrize("k", [40, 55, 76, 120])
    def test_halo_matches_full_copies(self, k, rng):
        from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                          viterbi_decode)

        u = rng.integers(0, 2, size=(32, k)).astype(np.int8)
        d = conv_encode_np(u)
        # LLRs at a realistic operating point (sigma such that Viterbi
        # still decodes cleanly: ~4 dB Eb/N0 for rate 1/3 K=7)
        llr = (1.0 - 2.0 * d + 0.45 * rng.normal(size=d.shape)
               ).astype(np.float32)
        full = np.asarray(viterbi_decode(jnp.asarray(llr), train=None))
        halo = np.asarray(viterbi_decode(jnp.asarray(llr)))
        assert np.array_equal(full, halo)
        assert np.mean(full != u) < 0.01


class TestPdcchBlindBits:
    def test_matches_per_candidate_decode(self, rng):
        """pdcch_blind_bits (one Viterbi batch across every aggregation
        level) must equal decoding each candidate separately, including
        the candidate-order restoration across the L-grouping."""
        from empower_srslte_tpu.models.pdcch import pdcch_blind_bits
        from empower_srslte_tpu.ops.fec.convcoder import viterbi_decode
        from empower_srslte_tpu.ops.fec.rm_conv import rm_conv_rx

        cell = Cell(nof_prb=50, id=1)
        cfi, sf_idx, rnti = 2, 1, 0x404F
        n_cce = pdcch_nof_cces(cell, cfi)
        cands = ue_search_candidates(rnti, sf_idx, n_cce)
        size = dci_mod.format0_1a_size(cell.nof_prb)
        llr = jnp.asarray(rng.normal(
            size=(2, n_cce * 72)).astype(np.float32))  # leading batch dim
        got = np.asarray(pdcch_blind_bits(llr, cands, size))
        assert got.shape == (2, len(cands), size + 16)
        for i, (l, cce) in enumerate(cands):
            seg = llr[..., cce * 72 : (cce + l) * 72]
            ref = np.asarray(viterbi_decode(rm_conv_rx(seg, size + 16),
                                            wrap=1))
            assert np.array_equal(got[:, i], ref), (l, cce)


class TestViterbiPallas:
    def test_kernel_matches_scan(self, rng):
        """The Pallas Viterbi kernel (the GPU auto-dispatch path) must be
        decision-identical to the XLA-scan formulation — same
        three-segment recursion, state-unrolled in registers."""
        from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                          viterbi_decode)
        from empower_srslte_tpu.ops.fec.viterbi_pallas import (
            viterbi_decode_pallas)

        for k in (55, 44, 40, 20):
            u = rng.integers(0, 2, size=(48, k)).astype(np.int8)
            d = conv_encode_np(u)
            llr = (1.0 - 2.0 * d + 0.45 * rng.normal(size=d.shape)
                   ).astype(np.float32)
            ref = np.asarray(viterbi_decode(jnp.asarray(llr), impl="scan"))
            got = np.asarray(viterbi_decode_pallas(
                jnp.asarray(llr), interpret=True))
            assert np.array_equal(got, ref), k
            assert np.mean(ref != u) < 0.01
