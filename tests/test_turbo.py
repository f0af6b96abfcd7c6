"""Turbo codec tests: encoder structure, QPP, loopback decode, windowed mode.

Mirrors the reference's fec/test tier (lib/src/phy/fec/test/CMakeLists.txt:
turbodecoder_test -n 100 -s 1 -l 6144 -e 1.5 -t): encode -> AWGN -> decode
and assert error-free recovery at moderate Eb/N0, plus table sanity.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from empower_srslte_tpu.ops.fec import (
    TURBO_CB_SIZES,
    TurboDecoder,
    cbsegm,
    qpp_interleaver,
    turbo_encode,
    turbo_encode_np,
)
from empower_srslte_tpu.ops.fec.tables import qpp_deinterleaver


class TestTables:
    def test_cb_sizes(self):
        assert len(TURBO_CB_SIZES) == 188
        assert TURBO_CB_SIZES[0] == 40 and TURBO_CB_SIZES[-1] == 6144
        assert TURBO_CB_SIZES[59] == 512 and TURBO_CB_SIZES[60] == 528

    @pytest.mark.parametrize("k", [40, 104, 512, 1056, 6144])
    def test_qpp_is_permutation(self, k):
        pi = qpp_interleaver(k)
        assert sorted(pi.tolist()) == list(range(k))
        pinv = qpp_deinterleaver(k)
        assert np.array_equal(pi[pinv], np.arange(k))

    def test_qpp_spot_values(self):
        # K=40: f1=3, f2=10 -> pi(1) = 13, pi(2) = 46 mod 40 = 6
        pi = qpp_interleaver(40)
        assert pi[0] == 0 and pi[1] == 13 and pi[2] == 6


class TestCbsegm:
    def test_single_block(self):
        s = cbsegm(1000)
        assert s.c == 1 and s.k_plus == 1024 and s.f == 0
        # 1000 + 24 = 1024 exactly a valid size

    def test_single_block_filler(self):
        s = cbsegm(1001)
        assert s.c == 1 and s.k_plus == 1056 and s.f == 1056 - 1025

    def test_segmented(self):
        s = cbsegm(10000)
        b = 10000 + 24
        assert s.c == int(np.ceil(b / 6120))
        total = s.c_plus * s.k_plus + s.c_minus * s.k_minus
        assert total - s.f == b + s.c * 24
        assert s.k_plus in TURBO_CB_SIZES
        assert s.k_minus in TURBO_CB_SIZES

    def test_max_tbs(self):
        s = cbsegm(75376)  # largest Rel-8 TBS
        assert s.c == 13
        assert all(k in TURBO_CB_SIZES for k in s.cb_sizes)


class TestEncoder:
    def test_np_shapes_and_systematic(self, rng):
        u = rng.integers(0, 2, size=(3, 104)).astype(np.int8)
        d = turbo_encode_np(u)
        assert d.shape == (3, 3, 108)
        assert np.array_equal(d[:, 0, :104], u)

    def test_trellis_termination_structure(self, rng):
        # re-encoding the decoded tail: encoder 1 ends in state 0 =>
        # running the RSC over (u + x_tail) from state 0 ends at state 0.
        from empower_srslte_tpu.ops.fec.turbo_encoder import trellis

        t = trellis()
        u = rng.integers(0, 2, size=(1, 40)).astype(np.int8)
        d = turbo_encode_np(u)
        x_tail = [d[0, 0, 40], d[0, 2, 40], d[0, 1, 41]]  # x_K, x_K+1, x_K+2
        state = 0
        for bit in list(u[0]) + x_tail:
            state = t.next_state[state, int(bit)]
        assert state == 0

    def test_jnp_matches_np(self, rng):
        u = rng.integers(0, 2, size=(2, 64)).astype(np.int8)
        d_np = turbo_encode_np(u)
        d_j = np.asarray(turbo_encode(jnp.asarray(u)))
        assert np.array_equal(d_np, d_j)

    def test_rate_one_third(self):
        u = np.zeros((1, 40), dtype=np.int8)
        d = turbo_encode_np(u)
        # all-zero input -> all-zero codeword (linear code)
        assert not d.any()


def _awgn_llrs(d_bits: np.ndarray, ebn0_db: float, rng, rate: float = 1 / 3):
    """BPSK over AWGN: bits -> LLRs with convention llr>0 <=> bit 0."""
    es = 1.0
    ebn0 = 10 ** (ebn0_db / 10)
    n0 = es / (rate * ebn0)
    sigma = np.sqrt(n0 / 2)
    x = 1.0 - 2.0 * d_bits.astype(np.float64)
    y = x + sigma * rng.normal(size=d_bits.shape)
    return (4.0 / n0 * y).astype(np.float32) * es


class TestDecoder:
    @pytest.mark.parametrize("k", [40, 104, 512])
    def test_noiseless_roundtrip(self, k, rng):
        u = rng.integers(0, 2, size=(4, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = (1.0 - 2.0 * d.astype(np.float32)) * 8.0
        dec = TurboDecoder(k=k, iterations=3)
        bits, _ = dec.decode(jnp.asarray(llr))
        assert np.array_equal(np.asarray(bits), u)

    def test_awgn_moderate_snr(self, rng):
        # Mirrors turbodecoder_test -l 6144 -e 1.5: at Eb/N0 = 1.5 dB a
        # rate-1/3 turbo code with >=5 iterations decodes error-free with
        # very high probability.
        k = 6144
        u = rng.integers(0, 2, size=(4, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = _awgn_llrs(d, 1.5, rng)
        dec = TurboDecoder(k=k, iterations=6)
        bits, _ = dec.decode(jnp.asarray(llr))
        errs = int(np.sum(np.asarray(bits) != u))
        assert errs == 0, f"{errs} bit errors at 1.5 dB"

    def test_low_snr_fails_high_snr_works(self, rng):
        # sanity: the decoder is actually using the channel values
        k = 1024
        u = rng.integers(0, 2, size=(2, k)).astype(np.int8)
        d = turbo_encode_np(u)
        dec = TurboDecoder(k=k, iterations=4)
        bits_bad, _ = dec.decode(jnp.asarray(_awgn_llrs(d, -6.0, rng)))
        assert np.sum(np.asarray(bits_bad) != u) > 50
        bits_ok, _ = dec.decode(jnp.asarray(_awgn_llrs(d, 4.0, rng)))
        assert np.array_equal(np.asarray(bits_ok), u)

    @pytest.mark.parametrize("window", [64, 128])
    def test_windowed_matches_quality(self, window, rng):
        # Windowed decode with 40-step overlap training must also be
        # error-free at the reference operating point.
        k = 2048
        u = rng.integers(0, 2, size=(4, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = _awgn_llrs(d, 1.6, rng)
        dec = TurboDecoder(k=k, iterations=6, window=window)
        bits, _ = dec.decode(jnp.asarray(llr))
        errs = int(np.sum(np.asarray(bits) != u))
        assert errs == 0, f"{errs} bit errors (windowed w={window})"

    def test_windowed_noiseless_exact(self, rng):
        k = 512
        u = rng.integers(0, 2, size=(2, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = (1.0 - 2.0 * d.astype(np.float32)) * 8.0
        dec = TurboDecoder(k=k, iterations=2, window=64)
        bits, _ = dec.decode(jnp.asarray(llr))
        assert np.array_equal(np.asarray(bits), u)


class TestNiiKernel:
    """NII kernel path (turbo_decoder_pallas2): NII windows, fused
    extrinsics, tile-major layout — validated via the pallas interpreter
    (the tile width follows the test batch)."""

    def _awgn(self, rng, k, batch, ebn0_db):
        u = rng.integers(0, 2, size=(batch, k)).astype(np.int8)
        d = turbo_encode_np(u)
        ebn0 = 10 ** (ebn0_db / 10)
        n0 = 1.0 / (ebn0 / 3)
        y = 1 - 2 * d.astype(np.float64) \
            + np.sqrt(n0 / 2) * rng.normal(size=d.shape)
        return u, jnp.asarray((4 / n0 * y).astype(np.float32))

    def test_noiseless_exact(self, rng):
        k = 512
        u = rng.integers(0, 2, size=(4, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = (1.0 - 2.0 * d.astype(np.float32)) * 8.0
        dec = TurboDecoder(k=k, iterations=2, window=128,
                           impl="pallas2_interpret", dtype="float32")
        bits, _ = dec.decode(jnp.asarray(llr))
        assert np.array_equal(np.asarray(bits), u)

    def test_awgn_quality(self, rng):
        k = 1024
        u, llr = self._awgn(rng, k, batch=8, ebn0_db=1.5)
        dec = TurboDecoder(k=k, iterations=5, window=128,
                           impl="pallas2_interpret", dtype="float32")
        bits, _ = dec.decode(llr)
        assert int(np.sum(np.asarray(bits) != u)) == 0

    def test_single_window(self, rng):
        # W=1: exact boundaries on both ends, no NII state involved
        k = 128
        u, llr = self._awgn(rng, k, batch=8, ebn0_db=2.0)
        dec = TurboDecoder(k=k, iterations=5, window=128,
                           impl="pallas2_interpret", dtype="float32")
        bits, _ = dec.decode(llr)
        assert int(np.sum(np.asarray(bits) != u)) == 0

    def test_crc_early_stop(self, rng):
        from empower_srslte_tpu.utils.crc import CRC24B as crc

        k = 512
        payload = rng.integers(0, 2, size=(4, k - 24)).astype(np.int8)
        u = np.concatenate([payload, np.zeros((4, 24), np.int8)], axis=1)
        for i in range(4):
            u[i] = np.asarray(crc.attach(jnp.asarray(payload[i])))
        d = turbo_encode_np(u)
        llr = (1.0 - 2.0 * d.astype(np.float32)) * 8.0
        dec = TurboDecoder(k=k, iterations=6, window=128,
                           impl="pallas2_interpret", dtype="float32")
        bits, _ = dec.decode(jnp.asarray(llr), crc=crc)
        assert np.array_equal(np.asarray(bits), u)
