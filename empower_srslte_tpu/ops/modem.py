"""Modulation mapping and max-log soft demapping, 36.211 7.1.

Capability parity with lib/src/phy/modem/ (lte_tables.c constellation
tables, mod.c byte modulator, demod_soft.c linearized max-log LLRs). The
demapper uses the same piecewise-linear max-log approximations as the
reference's SSE paths (demod_soft.c:40-477), vectorized over the whole
batch of REs; LLR convention: positive LLR <=> bit 0 (bit 0 maps to the
positive amplitude in all LTE constellations).
"""

from __future__ import annotations

import enum
import functools

import numpy as np

import jax.numpy as jnp


class Mod(enum.Enum):
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6

    @property
    def bits_per_symbol(self) -> int:
        return self.value


@functools.lru_cache(maxsize=8)
def constellation(mod: Mod) -> np.ndarray:
    """Symbol table indexed by the bit group read MSB-first (36.211 7.1)."""
    if mod is Mod.BPSK:
        # 36.211 Table 7.1.1-1: b=0 -> (1+j)/sqrt(2), b=1 -> -(1+j)/sqrt(2)
        a = 1 / np.sqrt(2)
        return np.array([a + 1j * a, -a - 1j * a], dtype=np.complex64)
    if mod is Mod.QPSK:
        a = 1 / np.sqrt(2)
        out = np.empty(4, dtype=np.complex64)
        for b in range(4):
            b0, b1 = (b >> 1) & 1, b & 1
            out[b] = a * (1 - 2 * b0) + 1j * a * (1 - 2 * b1)
        return out
    if mod is Mod.QAM16:
        # 36.211 Table 7.1.3-1: I from (b0, b2): 00->1, 01->3 (sign b0)
        s = 1 / np.sqrt(10)
        out = np.empty(16, dtype=np.complex64)
        for b in range(16):
            b0, b1, b2, b3 = (b >> 3) & 1, (b >> 2) & 1, (b >> 1) & 1, b & 1
            i = (1 - 2 * b0) * (1 + 2 * b2)
            q = (1 - 2 * b1) * (1 + 2 * b3)
            out[b] = s * (i + 1j * q)
        return out
    if mod is Mod.QAM64:
        # 36.211 Table 7.1.4-1: |I| from (b2, b4): 00->3, 01->1, 10->5, 11->7
        s = 1 / np.sqrt(42)
        amp = {(0, 0): 3, (0, 1): 1, (1, 0): 5, (1, 1): 7}
        out = np.empty(64, dtype=np.complex64)
        for b in range(64):
            bits = [(b >> (5 - i)) & 1 for i in range(6)]
            i = (1 - 2 * bits[0]) * amp[(bits[2], bits[4])]
            q = (1 - 2 * bits[1]) * amp[(bits[3], bits[5])]
            out[b] = s * (i + 1j * q)
        return out
    raise ValueError(mod)


def modulate(bits, mod: Mod):
    """bits [..., n*bps] 0/1 -> symbols [..., n] complex64.

    Equivalent of srslte_mod_modulate_bytes (mod.c:157), but closed-form:
    every LTE constellation's I/Q is a (bi)linear function of its bits
    (36.211 7.1 tables), so modulation is pure elementwise arithmetic
    instead of a table gather over the symbol axis.
    """
    import jax

    bps = mod.bits_per_symbol
    *lead, n = bits.shape
    assert n % bps == 0
    grp = bits.reshape(*lead, n // bps, bps).astype(jnp.float32)
    b = [grp[..., i] for i in range(bps)]
    sgn = lambda x: 1.0 - 2.0 * x
    if mod is Mod.BPSK:
        s = np.float32(1 / np.sqrt(2))
        return jax.lax.complex(sgn(b[0]) * s, sgn(b[0]) * s)
    if mod is Mod.QPSK:
        s = np.float32(1 / np.sqrt(2))
        return jax.lax.complex(sgn(b[0]) * s, sgn(b[1]) * s)
    if mod is Mod.QAM16:
        s = np.float32(1 / np.sqrt(10))
        return jax.lax.complex(sgn(b[0]) * (1.0 + 2.0 * b[2]) * s,
                               sgn(b[1]) * (1.0 + 2.0 * b[3]) * s)
    if mod is Mod.QAM64:
        # |amp|(b_h, b_l): 00->3, 01->1, 10->5, 11->7
        s = np.float32(1 / np.sqrt(42))
        amp = lambda bh, bl: 3.0 + 2.0 * bh - 2.0 * bl + 4.0 * bh * bl
        return jax.lax.complex(sgn(b[0]) * amp(b[2], b[4]) * s,
                               sgn(b[1]) * amp(b[3], b[5]) * s)
    raise ValueError(mod)


#: 8-bit LLR quantization gains per modulation — the reference's byte
#: demodulators (demod_soft.c:44-46 SCALE_BYTE_CONV_QPSK/QAM16/QAM64)
DEMOD_INT8_SCALE = {Mod.BPSK: 20.0, Mod.QPSK: 20.0,
                    Mod.QAM16: 30.0, Mod.QAM64: 40.0}


def quantize_llr_int8(llrs, mod: Mod):
    """f32 LLRs -> int8 with the reference's per-modulation byte scale
    and symmetric saturation at ±127 (the 8/16-bit receive lane of
    demod_soft.c + rm_turbo.c:378 8-bit combining)."""
    s = jnp.float32(DEMOD_INT8_SCALE[mod])
    return jnp.clip(jnp.round(llrs * s), -127, 127).astype(jnp.int8)


def demod_planes(re, im, mod: Mod):
    """Max-log LLR bit-planes (plane-major): list of ``bps`` arrays, each
    shaped like ``re``. Same linearized formulas as ``demod_soft``
    without the per-symbol bit interleave — the grid-domain fused
    receiver keeps the planes major and lets the decoder-feed gather
    tables absorb the layout (models/pdsch.py), so no minor-axis
    shuffle pass is ever materialized."""
    if mod is Mod.BPSK:
        return [(re + im) * np.float32(1 / np.sqrt(2))]
    if mod is Mod.QPSK:
        return [re, im]
    if mod is Mod.QAM16:
        c = np.float32(2 / np.sqrt(10))
        return [re, im, c - jnp.abs(re), c - jnp.abs(im)]
    if mod is Mod.QAM64:
        c4 = np.float32(4 / np.sqrt(42))
        c2 = np.float32(2 / np.sqrt(42))
        return [re, im,
                c4 - jnp.abs(re), c4 - jnp.abs(im),
                c2 - jnp.abs(jnp.abs(re) - c4),
                c2 - jnp.abs(jnp.abs(im) - c4)]
    raise ValueError(mod)


def demod_soft(symbols, mod: Mod, scale=1.0):
    """Max-log soft demapping: [..., n] -> LLRs [..., n*bps] float32.

    Linearized max-log formulas matching demod_soft.c; ``scale`` is the
    post-equalization LLR gain (e.g. 4/N0 or per-RE CSI weighting applied
    by the caller). Positive LLR <=> bit 0.
    """
    planes = demod_planes(jnp.real(symbols), jnp.imag(symbols), mod)
    out = planes[0][..., None] if len(planes) == 1 \
        else jnp.stack(planes, axis=-1)
    if not (isinstance(scale, float) and scale == 1.0):
        out = out * scale
    return out.reshape(*symbols.shape[:-1], symbols.shape[-1] * mod.bits_per_symbol)


def demod_hard(symbols, mod: Mod):
    """Hard decisions via the sign structure (hard_demod_lte.c analog)."""
    llr = demod_soft(symbols, mod)
    return (llr < 0).astype(jnp.int8)
