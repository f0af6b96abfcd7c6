"""The Hopper Pallas kernels, the backend switch and the GPU entry points.

On the CPU the kernels run in the Pallas interpreter against their plain
references (ops/fec/turbo_decoder_pallas2.map_decode_nii_ref and the
scan Viterbi); the tests marked ``gpu`` compile them for the card and
skip elsewhere (``python chip_smoke.py`` runs them on the GPU).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from empower_srslte_tpu import backend
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas2 import (
    TILE, map_decode_nii, map_decode_nii_ref, tile_width)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


def _nii_inputs(rng, t, k, sub, lanes, l, dtype=np.float32):
    w = k // l
    f = lambda *s: jnp.asarray((rng.normal(size=s) * 3).astype(dtype))
    return dict(u=f(t, k, sub, lanes), p=f(t, k, sub, lanes),
                tail_u=f(t, 8, sub, lanes), tail_p=f(t, 8, sub, lanes),
                a_st=f(t, w + 1, 8, sub, lanes),
                b_st=f(t, w + 1, 8, sub, lanes), e=f(t, k, sub, lanes))


def _nii_both(ins, l, apr, bounds, interpret=True):
    kw = dict(l=l, apr=ins["e"] if apr else None,
              bounds=None if bounds is None
              else jnp.asarray(bounds, jnp.int32))
    args = [ins[n] for n in ("u", "p", "tail_u", "tail_p", "a_st", "b_st")]
    return (map_decode_nii(*args, interpret=interpret, **kw),
            map_decode_nii_ref(*args, **kw))


class TestNiiKernelInterpret:
    @pytest.mark.parametrize("k,l,sub,lanes,apr,bounds", [
        (64, 16, 2, 4, True, None),       # 4 windows, a-priori input
        (64, 32, 1, 8, False, None),      # no a-priori input
        (48, 16, 1, 4, True, [-1, 2]),    # interior shard: no exact start
        (48, 48, 4, 2, True, [0, -1]),    # one window, no tail walk
        (96, 16, 2, 2, False, [-1, -1]),  # interior shard on both ends
        (40, 8, 1, 2, True, None),        # a window of one group
    ])
    def test_matches_reference_bitwise(self, rng, k, l, sub, lanes, apr,
                                       bounds):
        """ext and both boundary-metric slot arrays bit-identical to
        map_decode_nii_ref in float32."""
        ins = _nii_inputs(rng, 2, k, sub, lanes, l)
        got, want = _nii_both(ins, l, apr, bounds)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    def test_bfloat16_close_to_reference(self, rng):
        """bf16 metrics: same contract, every extrinsic within a few bf16
        ulps of the reference's (op-for-op the same arithmetic)."""
        ins = _nii_inputs(rng, 1, 32, 1, 4, 16)
        ins = {n: v.astype(jnp.bfloat16) for n, v in ins.items()}
        got, want = _nii_both(ins, 16, True, None)
        g = np.asarray(got[0], np.float32)
        w = np.asarray(want[0], np.float32)
        assert got[0].dtype == jnp.bfloat16
        assert np.max(np.abs(g - w)) <= 0.05 * np.max(np.abs(w))

    def test_slot_convention(self, rng):
        """Slot 0 of the next alpha state and slot W of the next beta
        state are the zero padding; the rest are per-window outputs."""
        ins = _nii_inputs(rng, 1, 32, 1, 2, 8)
        (_ext, a_next, b_next), _ = _nii_both(ins, 8, False, None)
        assert a_next.shape == b_next.shape == (1, 5, 8, 1, 2)
        assert not np.asarray(a_next[:, 0]).any()
        assert not np.asarray(b_next[:, -1]).any()


class TestTileGeometry:
    @pytest.mark.parametrize("n,want", [(1, 1), (3, 4), (26, 32),
                                        (200, 256), (6656, TILE)])
    def test_tile_width(self, n, want):
        assert tile_width(n) == want

    @pytest.mark.parametrize("shape,lanes,sub", [
        ((2, 256, 1), 256, 1),   # batch-256 MIMO grid path: 2 cw x 256
        ((2, 1, 1), 1, 32),      # batch 1: one tile of the 22 CBs
        ((2, 8, 1), 8, 32),      # batch 8: 8 lanes x 32 slots
        ((3, 2, 100), 2, 64),    # batch-major codeword rows
    ])
    def test_fused_geometry_follows_shape(self, shape, lanes, sub):
        from empower_srslte_tpu.models import ra
        from empower_srslte_tpu.models.sch import (DlschPlan,
                                                   _fused_geometry)

        _mod, tbs = ra.mcs_to_tbs(27, 100)
        plan = DlschPlan(tbs=tbs, g=2 * 14 * 1200 * 6, qm=6,
                         decoder_impl="pallas2")
        assert plan.segm.c == 11
        assert _fused_geometry(shape, plan) == (lanes, sub, False)
        assert lanes * sub <= TILE

    def test_fused_path_off_on_cpu(self):
        from empower_srslte_tpu.models.sch import DlschPlan, _fused_geometry

        plan = DlschPlan(tbs=1000, g=3000, qm=2)
        assert _fused_geometry((4, 2, 3000), plan) is None


class TestDispatch:
    def test_turbo_auto_uses_kernel_on_gpu(self, monkeypatch):
        from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder

        calls = []
        monkeypatch.setattr(backend, "platform", lambda: "gpu")
        monkeypatch.setattr(TurboDecoder, "_decode_nii",
                            lambda self, d, **kw: calls.append(kw) or "nii")
        dec = TurboDecoder(k=512, window=128)
        assert dec.decode(jnp.zeros((1, 3, 516))) == "nii"
        assert calls == [dict(iterations=None, crc=None, interpret=False)]

    def test_turbo_auto_uses_scan_on_cpu(self, monkeypatch):
        from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder

        monkeypatch.setattr(TurboDecoder, "_decode_nii",
                            lambda *a, **kw: pytest.fail("kernel on CPU"))
        bits, _ = TurboDecoder(k=40, iterations=1, window=None).decode(
            jnp.zeros((1, 3, 44)))
        assert bits.shape == (1, 40)

    def test_unknown_impl_raises(self):
        from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder

        with pytest.raises(ValueError, match="impl"):
            TurboDecoder(k=40, impl="pallas").decode(jnp.zeros((1, 3, 44)))

    def test_viterbi_auto_uses_kernel_on_gpu(self, monkeypatch):
        from empower_srslte_tpu.ops.fec import convcoder, viterbi_pallas

        monkeypatch.setattr(backend, "platform", lambda: "gpu")
        monkeypatch.setattr(viterbi_pallas, "viterbi_decode_pallas",
                            lambda llr, train: ("kernel", train))
        assert convcoder.viterbi_decode(jnp.zeros((2, 3, 44))) == \
            ("kernel", convcoder.TRAIN_LEN)
        # wrap != 1 stays on the scan
        assert convcoder.viterbi_decode(
            jnp.zeros((2, 3, 44)), wrap=0).shape == (2, 44)


class TestViterbiInterpret:
    @pytest.mark.parametrize("k,batch", [(20, 3), (44, 5), (67, 2)])
    def test_matches_scan(self, rng, k, batch):
        from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                          viterbi_decode)
        from empower_srslte_tpu.ops.fec.viterbi_pallas import (
            viterbi_decode_pallas)

        u = rng.integers(0, 2, size=(batch, k)).astype(np.int8)
        d = conv_encode_np(u)
        llr = jnp.asarray(((1.0 - 2.0 * d) + 0.9 * rng.normal(size=d.shape))
                          .astype(np.float32))
        got = np.asarray(viterbi_decode_pallas(llr, interpret=True))
        want = np.asarray(viterbi_decode(llr, impl="scan"))
        np.testing.assert_array_equal(got, want)


class TestBackendSwitch:
    def test_cpu_here(self):
        assert backend.platform() == "cpu"

    @pytest.mark.parametrize("name", ["gpu", "cpu"])
    def test_known_platforms(self, monkeypatch, name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        assert backend.platform() == name

    @pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
    def test_unknown_platform_raises(self, monkeypatch, name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            backend.platform()


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        prev = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", prev)

    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", "/unchanged")
        assert backend.configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "/unchanged"

    def test_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = backend.configure_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path


class TestChipSmokeRefusesCpu:
    def _run(self, cwd, script):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)

    def test_no_ok_line_on_cpu(self):
        r = self._run(ROOT, "chip_smoke.py")
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "needs an NVIDIA GPU" in r.stderr

    def test_fails_alone(self, tmp_path):
        script = tmp_path / "chip_smoke.py"
        script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
        r = self._run(str(tmp_path), "chip_smoke.py")
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


class TestChipSmokeChecksOnCpu:
    """chip_smoke.py's comparison phases at test sizes, kernels in the
    Pallas interpreter (the card runs them at the flagship widths)."""

    def test_nii_kernel_check(self):
        import chip_smoke

        r = chip_smoke.nii_kernel_check(t_tiles=1, k=64, l=16, lanes=4,
                                        interpret=True, timing=False)
        assert r["bit_identical"] == [True] * 3

    def test_viterbi_check(self):
        import chip_smoke

        r = chip_smoke.viterbi_check(batch=1, interpret=True, timing=False)
        assert r == {"k55_identical": True, "k44_identical": True}

    def test_encoder_ks_cover_the_flagship_blocks(self):
        import chip_smoke

        ks = chip_smoke.encoder_ks()
        # 20 MHz MCS 27/25 DL, 96-PRB MCS 20 UL, 10 MHz MCS 23 DL, ends
        assert {5824, 5760, 5120, 40, 6144} <= set(ks)
        assert 8 <= len(ks) <= 12

    def test_encoder_check(self):
        import chip_smoke

        r = chip_smoke.encoder_check(ks=[40, 1056], batch=3, big=2,
                                     timing=False)
        assert r["blocks_wrong"] == {} and r["ks"] == 3

    def test_encoder_check_sees_a_wrong_tail(self, monkeypatch):
        """A wrong termination bit fails the check (the columns past K
        are compared too)."""
        import chip_smoke
        from empower_srslte_tpu.ops import fec

        real = fec.turbo_encode
        monkeypatch.setattr(fec, "turbo_encode",
                            lambda u: real(u).at[..., 1, -1].add(1) % 2)
        with pytest.raises(RuntimeError, match="bit for bit"):
            chip_smoke.encoder_check(ks=[40], batch=2, big=1, timing=False)

    def test_sharded_nii_check(self):
        import chip_smoke

        r = chip_smoke.sharded_nii_check(jax.devices()[:2], k=256, batch=2,
                                         interpret=True)
        assert r["bits_identical"] and r["llr_identical"]
        assert r["bit_errors"] == 0


@pytest.mark.gpu
class TestOnGpu:
    def test_nii_kernel_compiled(self, gpu, rng):
        ins = _nii_inputs(rng, 2, 512, 1, 64, 128)
        got, want = _nii_both(ins, 128, True, None, interpret=False)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))

    def test_turbo_decode_compiled(self, gpu, rng):
        from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np

        u = rng.integers(0, 2, size=(64, 1024)).astype(np.int8)
        llr = (1.0 - 2.0 * turbo_encode_np(u).astype(np.float32)) * 4.0
        bits, _ = TurboDecoder(k=1024, iterations=3, window=128).decode(
            jnp.asarray(llr))
        np.testing.assert_array_equal(np.asarray(bits), u)

    @pytest.mark.parametrize("k", [40, 6144])
    def test_turbo_encode_compiled(self, gpu, rng, k):
        """Every output bit, tail columns included, equals the numpy
        encoder's."""
        from empower_srslte_tpu.ops.fec import turbo_encode, turbo_encode_np

        u = rng.integers(0, 2, size=(300, k)).astype(np.int8)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(turbo_encode)(jnp.asarray(u))),
            turbo_encode_np(u))

    def test_viterbi_compiled(self, gpu, rng):
        from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                          viterbi_decode)

        u = rng.integers(0, 2, size=(300, 55)).astype(np.int8)
        d = conv_encode_np(u)
        llr = jnp.asarray(((1.0 - 2.0 * d) + 0.8 * rng.normal(size=d.shape))
                          .astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(viterbi_decode(llr)),
            np.asarray(viterbi_decode(llr, impl="scan")))


class TestBenchGuards:
    """bench.py ends a run whose phase decoded wrongly, before it prints
    the phase's numbers."""

    def test_require_exits_non_zero(self):
        import bench

        bench.require(True, "fine")
        with pytest.raises(SystemExit) as e:
            bench.require(False, "rx_20mimo", {"crc_ok": False})
        assert e.value.code != 0 and "rx_20mimo" in str(e.value.code)

    def test_bad_bits_counts_crc_passing_tbs_only(self):
        import bench

        tb = jnp.zeros((3, 8), jnp.int8)
        bits = tb.at[0, 1].set(1).at[2, :4].set(1)
        ok = jnp.asarray([True, True, False])
        assert int(bench.bad_bits(bits, tb, ok)) == 1
        assert int(bench.bad_bits(bits, tb, jnp.ones(3, bool))) == 5
