"""OFDM round-trip, modulation tables, soft demapper, scrambling tests.

Mirrors the reference's dft (ofdm_test iFFT->FFT round trip), modem and
scrambling unit tiers (SURVEY.md section 4 tier 1).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from empower_srslte_tpu.ops.modem import Mod, constellation, demod_hard, demod_soft, modulate
from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf, ofdm_tx_sf
from empower_srslte_tpu.ops.scrambling import descramble_llrs, scramble_bits
from empower_srslte_tpu.utils import Cell


class TestOfdm:
    @pytest.mark.parametrize("prb", [6, 25, 50, 100])
    def test_roundtrip(self, prb, rng):
        cell = Cell(nof_prb=prb)
        grid = (rng.normal(size=(2, cell.nsymb_sf, cell.nof_re))
                + 1j * rng.normal(size=(2, cell.nsymb_sf, cell.nof_re))
                ).astype(np.complex64)
        samples = ofdm_tx_sf(jnp.asarray(grid), cell)
        assert samples.shape == (2, cell.sf_sample_len)
        back = ofdm_rx_sf(samples, cell)
        np.testing.assert_allclose(np.asarray(back), grid, atol=2e-3)

    def test_cp_is_cyclic(self, rng):
        cell = Cell(nof_prb=6)
        grid = (rng.normal(size=(1, 14, 72)) + 1j * rng.normal(size=(1, 14, 72))).astype(np.complex64)
        s = np.asarray(ofdm_tx_sf(jnp.asarray(grid), cell))[0]
        # symbol 0: CP of 10 samples (128-fft scaling 160/16) then 128 data
        cp0 = 160 * 128 // 2048
        np.testing.assert_allclose(s[:cp0], s[128 : 128 + cp0], atol=1e-6)

    def test_dc_and_guards_empty(self, rng):
        cell = Cell(nof_prb=6)
        grid = jnp.ones((1, 14, 72), dtype=jnp.complex64)
        s = ofdm_tx_sf(grid, cell)
        spec = np.fft.fft(np.asarray(s)[0, 10:138])  # symbol 0 data region
        assert abs(spec[0]) < 1e-4  # DC empty
        assert np.all(np.abs(spec[37:92]) < 1e-3)  # guards empty


class TestModem:
    @pytest.mark.parametrize("mod", list(Mod))
    def test_unit_average_power(self, mod):
        c = constellation(mod)
        assert len(c) == 2 ** mod.bits_per_symbol
        np.testing.assert_allclose(np.mean(np.abs(c) ** 2), 1.0, rtol=1e-6)

    @pytest.mark.parametrize("mod", list(Mod))
    def test_gray_neighbors(self, mod):
        # distinct constellation points
        c = constellation(mod)
        assert len(np.unique(np.round(c, 6))) == len(c)

    def test_qpsk_spot(self):
        c = constellation(Mod.QPSK)
        a = 1 / np.sqrt(2)
        np.testing.assert_allclose(c[0], a + 1j * a, rtol=1e-6)   # 00
        np.testing.assert_allclose(c[3], -a - 1j * a, rtol=1e-6)  # 11

    def test_16qam_spot(self):
        c = constellation(Mod.QAM16)
        s = 1 / np.sqrt(10)
        np.testing.assert_allclose(c[0b0000], s * (1 + 1j), rtol=1e-6)
        np.testing.assert_allclose(c[0b0010], s * (3 + 1j), rtol=1e-6)
        np.testing.assert_allclose(c[0b1011], s * (-3 + 3j), rtol=1e-6)

    @pytest.mark.parametrize("mod", list(Mod))
    def test_mod_demod_roundtrip_noiseless(self, mod, rng):
        bits = rng.integers(0, 2, size=(3, 240 * mod.bits_per_symbol)).astype(np.int8)
        sym = modulate(jnp.asarray(bits), mod)
        hard = demod_hard(sym, mod)
        assert np.array_equal(np.asarray(hard), bits)

    @pytest.mark.parametrize("mod", list(Mod))
    def test_soft_demod_sign_with_noise(self, mod, rng):
        bits = rng.integers(0, 2, size=(2000 * mod.bits_per_symbol,)).astype(np.int8)
        sym = np.asarray(modulate(jnp.asarray(bits), mod))
        noisy = sym + 0.05 * (rng.normal(size=sym.shape) + 1j * rng.normal(size=sym.shape))
        llr = np.asarray(demod_soft(jnp.asarray(noisy.astype(np.complex64)), mod))
        # at high SNR the sign must recover the bits
        assert np.mean((llr < 0) == bits) > 0.999


class TestScrambling:
    def test_bits_involution(self, rng):
        bits = rng.integers(0, 2, size=(4, 256)).astype(np.int8)
        s = scramble_bits(jnp.asarray(bits), 0x1234)
        assert not np.array_equal(np.asarray(s), bits)
        back = scramble_bits(s, 0x1234)
        assert np.array_equal(np.asarray(back), bits)

    def test_llr_descrambling_matches_bit_scrambling(self, rng):
        bits = rng.integers(0, 2, size=(512,)).astype(np.int8)
        scrambled = np.asarray(scramble_bits(jnp.asarray(bits), 77))
        llr_scrambled = (1.0 - 2.0 * scrambled).astype(np.float32)
        llr = np.asarray(descramble_llrs(jnp.asarray(llr_scrambled), 77))
        assert np.array_equal((llr < 0).astype(np.int8), bits)
