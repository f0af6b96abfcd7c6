"""Fused receiver feed (ops/fec/derm_tiles.py + sch._dlsch_decode_fused).

Validates the precomputed index-map formulation against the classic
de-rate-match -> stream-split -> tile-pack path: the tables must
reproduce TurboDecoder._split_streams + RateMatchTurbo.rx exactly, the
GF(2) machinery (shift matrices, interleaved parity rows) must match the
bitwise CRC, and the full fused dlsch decode (Pallas interpret mode)
must agree with the classic decode on clean and corrupted codewords.

Reference semantics covered: lib/src/phy/phch/sch.c:307-437
(decode_tb_cb + CRC checks), lib/src/phy/fec/rm_turbo.c:378-905 (soft
de-rate-matching), 36.212 5.1.3.2.2 tail bit collection.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from empower_srslte_tpu.models.sch import (DlschPlan, _dlsch_decode_fused,
                                           dlsch_decode, dlsch_encode)
from empower_srslte_tpu.ops.fec.derm_tiles import (
    _d_sources, build_tile_plan, parity_rows_interleaved, shift_matrix,
    stream_row_maps)
from empower_srslte_tpu.ops.fec.rate_matching import RateMatchTurbo
from empower_srslte_tpu.ops.fec.tables import qpp_interleaver
from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu.utils.crc import CRC24A, CRC24B


class TestStreamRowMaps:
    def test_matches_split_streams(self):
        """The numpy d-maps ARE _split_streams applied to an index array."""
        k = 40
        d = k + 4
        dec = TurboDecoder(k=k)
        ref = np.arange(3 * d, dtype=np.float32).reshape(3, d)
        sys1, par1, sys2t, par2 = (np.asarray(a) for a in
                                   dec._split_streams(jnp.asarray(ref)))
        m_sys, m_par1, m_par2, m_sys2t = stream_row_maps(k)
        flat = ref.reshape(-1)
        np.testing.assert_array_equal(flat[m_sys], sys1)
        np.testing.assert_array_equal(flat[m_par1], par1)
        np.testing.assert_array_equal(flat[m_par2], par2)
        np.testing.assert_array_equal(flat[m_sys2t], sys2t)


class TestDSources:
    @pytest.mark.parametrize("k,f,rv,e", [
        (40, 0, 0, 100), (64, 4, 0, 120), (64, 0, 2, 300),
        (512, 12, 0, 900), (512, 0, 0, 4000),   # e > circle: repetitions
    ])
    def test_inverts_tx_selection(self, k, f, rv, e):
        """Gather-by-sources + sum == rate_matching.rx (up to the filler
        pinning, which the tile plan applies separately)."""
        rng = np.random.default_rng(0)
        llr_e = rng.standard_normal(e).astype(np.float32)
        src = _d_sources(k, f, rv, e)
        padded = np.concatenate([llr_e, [0.0]])
        via_src = padded[np.where(src >= 0, src, e)].sum(axis=1)

        rm = RateMatchTurbo(k, f=f)
        d_llr, _ = rm.rx(jnp.asarray(llr_e), rv)
        d_ref = np.array(d_llr).reshape(-1)
        if f:
            d_ref[:f] = 0.0  # undo the strong-filler pinning for comparison
        np.testing.assert_allclose(via_src, d_ref, rtol=1e-5, atol=1e-5)


class TestGf2Machinery:
    def test_shift_matrix_composition(self):
        """crc(a || b) == W_{len(b)} @ crc(a) ^ crc(b)."""
        rng = np.random.default_rng(3)
        for crc in (CRC24A, CRC24B):
            a = rng.integers(0, 2, 53).astype(np.int8)
            b = rng.integers(0, 2, 171).astype(np.int8)
            w = shift_matrix(crc.poly, crc.order, len(b))
            lhs = crc.compute(np.concatenate([a, b]))
            rhs = (w @ crc.compute(a) + crc.compute(b)) % 2
            np.testing.assert_array_equal(lhs, rhs)

    def test_interleaved_parity_rows(self):
        """Syndrome via P_int on interleaved bits == crc on natural bits."""
        k = 64
        rng = np.random.default_rng(4)
        bits = rng.integers(0, 2, k).astype(np.float32)
        pi = qpp_interleaver(k)
        bits_int = bits[pi]
        p_int = parity_rows_interleaved(CRC24B.poly, 24, k)
        snd = (bits_int @ p_int) % 2
        np.testing.assert_array_equal(snd.astype(np.int8),
                                      CRC24B.compute(bits.astype(np.int8)))

    def test_interleaved_parity_payload_window(self):
        k = 64
        lo, hi = 8, 40
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2, k).astype(np.float32)
        p = parity_rows_interleaved(CRC24A.poly, 24, k, (lo, hi))
        snd = (bits[qpp_interleaver(k)] @ p) % 2
        np.testing.assert_array_equal(
            snd.astype(np.int8), CRC24A.compute(bits[lo:hi].astype(np.int8)))


@pytest.fixture
def tiny_tiles():
    """Interpret-mode geometry: the dispatch sizes the kernel tile to the
    test batch (sch._fused_geometry), so the Pallas interpreter (which
    emulates every element in Python) stays fast; direct calls pass
    lanes=2, sub=8."""


def _run_both(plan_fast, plan_ref, llrs):
    bits_f, ok_f, _ = _dlsch_decode_fused(jnp.asarray(llrs), plan_fast,
                                          lanes=2, sub=8, interpret=True)
    bits_r, ok_r, _ = dlsch_decode(jnp.asarray(llrs), plan_ref)
    return (np.asarray(bits_f), np.asarray(ok_f),
            np.asarray(bits_r), np.asarray(ok_r))


def _mini_multicb_plans(early_stop=True):
    """A real LTE multi-CB TB needs tbs > 6120 — far too big for the
    Pallas interpreter. Inject a synthetic (but internally consistent)
    segmentation of two K groups (96, 128) with filler bits, exercising
    exactly the rx_20mimo decode structure in miniature. cached_property
    stores into __dict__, so pre-seeding it works on the frozen plan."""
    from empower_srslte_tpu.ops.fec.cbsegm import CbSegm

    tbs, g = 148, 1200   # payloads (96-4-24) + (128-24) = tbs + 24
    segm = CbSegm(tbs=tbs, c=2, c_plus=1, c_minus=1,
                  k_plus=128, k_minus=96, f=4)
    fast = DlschPlan(tbs=tbs, g=g, qm=4, decoder_impl="pallas2_interpret",
                     early_stop=early_stop)
    ref = DlschPlan(tbs=tbs, g=g, qm=4, decoder_impl="xla",
                    early_stop=early_stop)
    fast.__dict__["segm"] = segm
    ref.__dict__["segm"] = segm
    return fast, ref


class TestFusedDlsch:
    """Fused vs classic decode, Pallas interpret mode, multi-CB TB with
    filler bits and two K groups (the rx_20mimo structure in miniature)."""

    def _plans(self, tbs, g, early_stop=True):
        fast = DlschPlan(tbs=tbs, g=g, qm=4, decoder_impl="pallas2_interpret",
                         early_stop=early_stop)
        ref = DlschPlan(tbs=tbs, g=g, qm=4, decoder_impl="xla",
                        early_stop=early_stop)
        return fast, ref

    def test_multi_cb_clean(self, tiny_tiles, rng):
        fast, ref = _mini_multicb_plans()
        tbs = fast.tbs
        assert fast.segm.c == 2 and fast.segm.f > 0
        tb = rng.integers(0, 2, size=(3, 2, tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        assert ok_f.shape == (3, 2) and ok_f.all()
        np.testing.assert_array_equal(bits_f, tb)
        np.testing.assert_array_equal(bits_r, tb)
        assert ok_r.all()

    def test_multi_cb_corruption(self, tiny_tiles, rng):
        """A burst confined to one TB of the batch flips only its ok."""
        fast, ref = _mini_multicb_plans()
        tb = rng.integers(0, 2, size=(1, 2, fast.tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        llrs[0, 1] = rng.standard_normal(fast.g).astype(np.float32) * 4.0
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        np.testing.assert_array_equal(ok_f, ok_r)
        assert ok_f[0, 0] and not ok_f[0, 1]
        np.testing.assert_array_equal(bits_f[0, 0], tb[0, 0])

    def test_single_cb_and_corruption(self, tiny_tiles, rng):
        tbs, g = 104, 520    # c=1: CRC24A is the early-stop CRC
        fast, ref = self._plans(tbs, g)
        assert fast.segm.c == 1
        tb = rng.integers(0, 2, size=(1, 2, tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        llrs[0, 1] = -llrs[0, 1] * 0.0 + rng.standard_normal(g) * 4.0
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        np.testing.assert_array_equal(ok_f, ok_r)
        assert ok_f[0, 0] and not ok_f[0, 1]
        np.testing.assert_array_equal(bits_f[0, 0], tb[0, 0])

    def test_zero_input_rejected(self, tiny_tiles):
        """All-zero LLRs decode to the all-zero word, whose CRC trivially
        passes — the zero-TB guard must reject it (sch.py parity with the
        classic path)."""
        tbs, g = 104, 520
        fast, _ = self._plans(tbs, g)
        llrs = np.zeros((1, 2, g), np.float32)
        _bits, ok, _ = _dlsch_decode_fused(jnp.asarray(llrs), fast,
                                           lanes=2, sub=8, interpret=True)
        assert not np.asarray(ok).any()

    def test_repetition_rates(self, tiny_tiles, rng):
        """E > circular-buffer length: the reps axis soft-combines."""
        tbs, g = 104, 1600   # rate ~0.065 -> multiple circle laps
        fast, ref = self._plans(tbs, g)
        tb = rng.integers(0, 2, size=(1, 2, tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 2.0 + rng.standard_normal(
            cw.shape).astype(np.float32)
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        assert ok_f.all() and ok_r.all()
        np.testing.assert_array_equal(bits_f, tb)

    def test_dispatch_via_dlsch_decode(self, tiny_tiles, rng):
        """dlsch_decode routes to the fused path for pallas2_interpret
        and returns usable first-transmission softbuffers."""
        fast, _ = _mini_multicb_plans()
        tbs = fast.tbs
        tb = rng.integers(0, 2, size=(1, 2, tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits, ok, soft = dlsch_decode(jnp.asarray(llrs), fast)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(bits), tb)
        # softbuffers come from the classic de-RM graph (HARQ state)
        assert len(soft) == fast.segm.c and soft[0] is not None


class TestGridPath:
    """Grid-domain fused path (no RE extraction): pdsch_decode must agree
    with the classic extracted path for SINGLE and SPATIAL_MUX."""

    def _cell_cfgs(self, mimo, rng):
        from empower_srslte_tpu.models.pdsch import PdschConfig
        from empower_srslte_tpu.ops.equalizer import MimoType
        from empower_srslte_tpu.ops.modem import Mod
        from empower_srslte_tpu.utils import Cell

        if mimo == "single":
            cell = Cell(nof_prb=6, nof_ports=1, id=1)
            cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=Mod.QPSK)
        else:
            cell = Cell(nof_prb=6, nof_ports=2, id=1)
            cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=Mod.QPSK,
                              mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                              nof_codewords=2)
        return cfg

    @pytest.mark.parametrize("mimo", ["single", "mux"])
    def test_matches_classic(self, tiny_tiles, monkeypatch, rng, mimo):
        import jax

        from empower_srslte_tpu.models import ra
        from empower_srslte_tpu.models.pdsch import pdsch_decode, pdsch_encode

        cfg = self._cell_cfgs(mimo, rng)
        tbs = 136                      # K=160 -> window 80
        plan_f = cfg.plan(tbs, decoder_impl="pallas2_interpret")
        plan_c = cfg.plan(tbs, decoder_impl="xla")
        b = 2
        tb = rng.integers(0, 2, size=(b, tbs)).astype(np.int8)
        n0 = 1e-3
        if mimo == "single":
            grid = pdsch_encode(jnp.asarray(tb), cfg, plan_f)
            h = jnp.full((b, 1, 1, cfg.cell.nsymb_sf, cfg.cell.nof_re),
                         0.9 - 0.2j, jnp.complex64)
            y = grid * h[:, :, 0]
            args_f = (y, h, cfg, plan_f)
            args_c = (y, h, cfg, plan_c)
            kw = {}
        else:
            tb2 = rng.integers(0, 2, size=(b, tbs)).astype(np.int8)
            ports = pdsch_encode(jnp.asarray(tb), cfg, plan_f,
                                 jnp.asarray(tb2), plan_f)
            hm = np.zeros((b, 2, 2, cfg.cell.nsymb_sf, cfg.cell.nof_re),
                          np.complex64)
            hm[:, 0, 0] = 1.0
            hm[:, 1, 1] = 0.8 + 0.3j
            hm[:, 0, 1] = 0.2
            hm[:, 1, 0] = 0.1j
            h = jnp.asarray(hm)
            y = jnp.einsum("brpsk,bpsk->brsk", h, ports)
            args_f = (y, h, cfg, plan_f)
            args_c = (y, h, cfg, plan_c)
            kw = {"plan2": plan_f}
            kw_c = {"plan2": plan_c}

        out_f = pdsch_decode(*args_f, noise_est=n0,
                             **(kw if mimo == "single" else kw))
        monkeypatch.setenv("SRSLTE_FUSED_RX", "0")
        out_c = pdsch_decode(*args_c, noise_est=n0,
                             **(kw if mimo == "single" else kw_c))
        if mimo == "single":
            bits_f, ok_f, _ = out_f
            bits_c, ok_c, _ = out_c
            assert np.asarray(ok_f).all() and np.asarray(ok_c).all()
            np.testing.assert_array_equal(np.asarray(bits_f), tb)
            np.testing.assert_array_equal(np.asarray(bits_c), tb)
        else:
            (b1f, b2f), (ok1f, ok2f), _ = out_f
            (b1c, b2c), (ok1c, ok2c), _ = out_c
            assert np.asarray(ok1f).all() and np.asarray(ok2f).all()
            assert np.asarray(ok1c).all() and np.asarray(ok2c).all()
            np.testing.assert_array_equal(np.asarray(b1f), tb)
            np.testing.assert_array_equal(np.asarray(b2f), tb2)
            np.testing.assert_array_equal(np.asarray(b1c), tb)


class TestFeedV2AndPosMajor:
    """The round-5 feed variants: the shared-index v2 cross-check path
    (SRSLTE_FEED=v2) and positions-major input (pos_major, incl. lane
    folds) must decode identically to the default v1 batch-major feed."""

    def test_v2_feed_matches_v1(self, tiny_tiles, monkeypatch, rng):
        fast, _ref = _mini_multicb_plans()
        tb = rng.integers(0, 2, size=(3, 2, fast.tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits1, ok1, _ = _dlsch_decode_fused(
            jnp.asarray(llrs), fast, lanes=2, sub=8, interpret=True)
        monkeypatch.setenv("SRSLTE_FEED", "v2")
        bits2, ok2, _ = _dlsch_decode_fused(
            jnp.asarray(llrs), fast, lanes=2, sub=8, interpret=True)
        np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
        np.testing.assert_array_equal(np.asarray(bits1), np.asarray(bits2))
        assert np.asarray(ok2).all()
        np.testing.assert_array_equal(np.asarray(bits2), tb)

    @pytest.mark.parametrize("lanes,expected_folds", [(2, 1), (1, 2)])
    def test_pos_major_matches_batch_major(self, tiny_tiles, rng, lanes,
                                           expected_folds):
        fast, _ref = _mini_multicb_plans()
        tb = rng.integers(0, 2, size=(3, 2, fast.tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits1, ok1, _ = _dlsch_decode_fused(
            jnp.asarray(llrs), fast, lanes=lanes, sub=8, interpret=True)
        llrs_t = np.swapaxes(llrs, -1, -2)          # [3, G, 2]
        assert llrs_t.shape[-1] // lanes == expected_folds
        bits2, ok2, _ = _dlsch_decode_fused(
            jnp.asarray(llrs_t), fast, lanes=lanes, sub=8,
            interpret=True, pos_major=True)
        np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok2))
        np.testing.assert_array_equal(np.asarray(bits1), np.asarray(bits2))
        np.testing.assert_array_equal(np.asarray(bits2), tb)


class TestFusedVariants:
    """Redundancy versions, fixed-iteration mode, int8 lane — through the
    fused path, against the classic path."""

    def test_rv2_selection(self, tiny_tiles, rng):
        """Non-zero redundancy version shifts the circular-buffer start
        (k0, 36.212 5.1.4.1.2); the fused tables must follow."""
        from empower_srslte_tpu.models.sch import DlschPlan

        tbs, g = 104, 520
        fast = DlschPlan(tbs=tbs, g=g, qm=4, rv=2,
                         decoder_impl="pallas2_interpret")
        ref = DlschPlan(tbs=tbs, g=g, qm=4, rv=2, decoder_impl="xla")
        tb = rng.integers(0, 2, size=(1, 2, tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        assert ok_f.all() and ok_r.all()
        np.testing.assert_array_equal(bits_f, tb)

    def test_fixed_iterations(self, tiny_tiles, rng):
        """early_stop=False: the fixed-count scan path of decode_tiles."""
        fast, ref = _mini_multicb_plans(early_stop=False)
        tb = rng.integers(0, 2, size=(1, 2, fast.tbs)).astype(np.int8)
        cw = np.asarray(dlsch_encode(jnp.asarray(tb), fast))
        llrs = (1.0 - 2.0 * cw) * 6.0
        bits_f, ok_f, bits_r, ok_r = _run_both(fast, ref, llrs)
        assert ok_f.all() and ok_r.all()
        np.testing.assert_array_equal(bits_f, tb)

    def test_int8_lane_grid_path(self, tiny_tiles, monkeypatch, rng):
        """llr_int8 through the grid-domain fused path: quantized byte
        LLRs (demod_soft.c scales), decoded in bf16."""
        from empower_srslte_tpu.models.pdsch import (PdschConfig,
                                                     pdsch_decode,
                                                     pdsch_encode)
        from empower_srslte_tpu.ops.modem import Mod
        from empower_srslte_tpu.utils import Cell

        cell = Cell(nof_prb=6, nof_ports=1, id=1)
        cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=Mod.QPSK,
                          llr_int8=True)
        tbs = 136
        plan = cfg.plan(tbs, decoder_impl="pallas2_interpret")
        b = 2
        tb = rng.integers(0, 2, size=(b, tbs)).astype(np.int8)
        grid = pdsch_encode(jnp.asarray(tb), cfg, plan)
        h = jnp.full((b, 1, 1, cell.nsymb_sf, cell.nof_re),
                     0.9 - 0.2j, jnp.complex64)
        y = grid * h[:, :, 0]
        bits, ok, _ = pdsch_decode(y, h, cfg, plan, noise_est=1e-3)
        assert np.asarray(ok).all()
        np.testing.assert_array_equal(np.asarray(bits), tb)
