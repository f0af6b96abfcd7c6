"""Multi-device tests on the virtual 8-CPU mesh: batch sharding and the
sequence-parallel turbo decoder with halo exchange.

These validate the multi-device path (SURVEY.md section 7 stage 10)
on virtual CPU devices; chip_smoke.py --devices 4 runs it on GPUs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from empower_srslte_tpu.ops.fec import TurboDecoder, turbo_encode_np
from empower_srslte_tpu.parallel import make_mesh, shard_batch, sp_turbo_decode
from empower_srslte_tpu.parallel.turbo_sp import (_pick_window,
                                                  sp_turbo_decode_nii)


@pytest.fixture(scope="module")
def devices():
    return jax.devices()


class TestMesh:
    def test_make_mesh_shapes(self, devices):
        m = make_mesh(8)
        assert m.shape["carrier"] * m.shape["sf"] == 8
        m2 = make_mesh(8, carriers=4)
        assert m2.shape["carrier"] == 4 and m2.shape["sf"] == 2

    def test_shard_batch_placement(self, devices, rng):
        m = make_mesh(8, carriers=2)
        x = jnp.asarray(rng.normal(size=(2, 4, 64)).astype(np.float32))
        xs = shard_batch(m, x)
        assert len(xs.sharding.device_set) == 8

    def test_sharded_computation_correct(self, rng):
        m = make_mesh(8, carriers=2)
        x = rng.normal(size=(2, 4, 128)).astype(np.float32)
        xs = shard_batch(m, jnp.asarray(x))
        out = jax.jit(lambda v: jnp.sum(v * 2, axis=-1))(xs)
        np.testing.assert_allclose(np.asarray(out), (x * 2).sum(-1), rtol=1e-5)


class TestSequenceParallelTurbo:
    @pytest.mark.parametrize("n_sp", [2, 4])
    def test_sp_decode_matches_quality(self, n_sp, rng):
        k = 1024
        u = rng.integers(0, 2, size=(4, k)).astype(np.int8)
        d = turbo_encode_np(u)
        ebn0 = 10 ** (1.6 / 10)
        n0 = 1.0 / (ebn0 / 3)
        sig = np.sqrt(n0 / 2)
        llr = (4 / n0 * (1 - 2 * d.astype(np.float64)
                         + sig * rng.normal(size=d.shape))).astype(np.float32)

        mesh = Mesh(np.asarray(jax.devices()[:n_sp]), axis_names=("sf",))
        bits, _ = sp_turbo_decode(jnp.asarray(llr), k, mesh, axis="sf",
                                  iterations=6)
        errs = int(np.sum(np.asarray(bits) != u))
        assert errs == 0, f"{errs} errors with {n_sp}-way trellis sharding"

    @pytest.mark.parametrize("n_sp", [2, 4])
    def test_sp_nii_bit_identical_to_single_chip(self, n_sp, rng,
                                                 monkeypatch):
        """The DEPLOYED decoder, trellis-sharded: the NII Pallas kernel
        runs per shard with its boundary metrics exchanged via ppermute
        — decisions AND soft outputs must be bit-identical to the
        single-chip kernel at equal window geometry (the exchange ships
        exactly the metrics a single chip passes between windows)."""
        k = 1024
        u = rng.integers(0, 2, size=(8, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = ((1 - 2 * d.astype(np.float32)) * 4.0
               + rng.normal(size=d.shape).astype(np.float32))
        mesh = Mesh(np.asarray(jax.devices()[:n_sp]), axis_names=("sf",))
        bits_sp, llr_sp = sp_turbo_decode_nii(
            jnp.asarray(llr), k, mesh, axis="sf", iterations=3,
            sub=8, lanes=1, interpret=True)

        l = _pick_window(k // n_sp, 16)
        ref = TurboDecoder(k=k, iterations=3, window=l,
                           impl="pallas2_interpret", dtype="float32")
        bits_ref, llr_ref = ref.decode(jnp.asarray(llr))
        np.testing.assert_array_equal(np.asarray(bits_sp),
                                      np.asarray(bits_ref))
        np.testing.assert_array_equal(np.asarray(llr_sp),
                                      np.asarray(llr_ref))
        assert np.array_equal(np.asarray(bits_sp), u)

    def test_sp_matches_single_device_windowed(self, rng):
        # With aligned windows the sp decode trains boundaries on the same
        # data as the single-device windowed decode: results should agree
        # closely (identical up to float reassociation).
        k = 512
        u = rng.integers(0, 2, size=(2, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = ((1 - 2 * d.astype(np.float32)) * 4.0
               + rng.normal(size=d.shape).astype(np.float32))
        mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("sf",))
        bits_sp, llr_sp = sp_turbo_decode(jnp.asarray(llr), k, mesh,
                                          axis="sf", iterations=3)
        ref = TurboDecoder(k=k, iterations=3, window=64)
        bits_ref, llr_ref = ref.decode(jnp.asarray(llr))
        assert np.array_equal(np.asarray(bits_sp), np.asarray(bits_ref))


class TestPallasUnderShardMap:
    def test_nii_kernel_batch_sharded(self, devices, monkeypatch):
        """The flagship NII Pallas decoder executes under shard_map with
        the CB batch sharded across the mesh (interpret mode on the CPU
        devices; identical code path to the compiled kernel on the GPU) —
        sharded-execution evidence for the deployed windowed decoder
        (turbodecoder_win.h is the reference's production path)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from empower_srslte_tpu.ops.fec import turbo_encode_np
        from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder

        mesh = make_mesh(8)
        k = 320
        dec = TurboDecoder(k=k, iterations=2, window=80,
                           impl="pallas2_interpret")
        rng = np.random.default_rng(5)
        u = rng.integers(0, 2, size=(8, 1, k)).astype(np.int8)
        d = turbo_encode_np(u.reshape(-1, k)).reshape(8, 1, 3, k + 4)
        llr = jnp.asarray((1.0 - 2.0 * d.astype(np.float32)) * 8.0)
        spec = P(("carrier", "sf"))

        def local(llr_shard):
            bits, _ = dec.decode(llr_shard)
            return bits

        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,),
                                   out_specs=spec, check_vma=False))
        bits = fn(jax.device_put(llr, NamedSharding(mesh, spec)))
        # each device decoded only its own shard (no replication)
        shard_elems = max(int(np.prod(s.data.shape))
                          for s in bits.addressable_shards)
        assert shard_elems * 8 <= bits.size
        np.testing.assert_array_equal(np.asarray(bits), u)


    def test_viterbi_kernel_batch_sharded(self, devices):
        """The Pallas Viterbi kernel (the GPU blind-PDCCH/PBCH decode
        path) executes under shard_map with the codeword batch sharded
        across the mesh (interpret mode; identical code path to the
        compiled kernel) and matches the XLA-scan decode."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                          viterbi_decode)
        from empower_srslte_tpu.ops.fec.viterbi_pallas import (
            viterbi_decode_pallas)

        mesh = make_mesh(8)
        k = 44
        rng = np.random.default_rng(6)
        u = rng.integers(0, 2, size=(8, 8, k)).astype(np.int8)
        d = conv_encode_np(u.reshape(-1, k)).reshape(8, 8, 3, k)
        llr = jnp.asarray((1.0 - 2.0 * d.astype(np.float32)) * 4.0)
        spec = P(("carrier", "sf"))

        def local(llr_shard):
            return viterbi_decode_pallas(llr_shard, interpret=True)

        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,),
                                   out_specs=spec, check_vma=False))
        bits = fn(jax.device_put(llr, NamedSharding(mesh, spec)))
        shard_elems = max(int(np.prod(s.data.shape))
                          for s in bits.addressable_shards)
        assert shard_elems * 8 <= bits.size
        np.testing.assert_array_equal(np.asarray(bits), u)
        ref = np.asarray(viterbi_decode(llr.reshape(-1, 3, k),
                                        impl="scan"))
        np.testing.assert_array_equal(np.asarray(bits).reshape(-1, k), ref)
