"""Bit pack/unpack helpers (host numpy and device jnp).

Capability parity with lib/src/phy/utils/bit.c (srslte_bit_pack/unpack and
the bit interleaver). On the device the data path keeps bits as int8 0/1 tensors;
byte packing happens only at host boundaries (transport-block I/O, file
sinks), so these are thin vectorized wrappers rather than a port of the
word-at-a-time C routines.
"""

from __future__ import annotations

import numpy as np


def unpack_bytes(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """uint8 bytes -> MSB-first 0/1 int8 bits."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data)
    if nbits is not None:
        bits = bits[:nbits]
    return bits.astype(np.int8)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """MSB-first 0/1 bits -> uint8 bytes (zero-padded to a byte boundary)."""
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits)


def uint_to_bits(value: int, nbits: int) -> np.ndarray:
    """Integer -> MSB-first bit vector of fixed width."""
    return np.array([(value >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=np.int8)


def bits_to_uint(bits: np.ndarray) -> int:
    """MSB-first bit vector -> integer."""
    out = 0
    for b in np.asarray(bits).astype(np.int64):
        out = (out << 1) | int(b)
    return out


def jnp_pack_bits(bits):
    """Device-side pack: [..., 8*n] 0/1 -> [..., n] uint8 (MSB-first)."""
    import jax.numpy as jnp

    *lead, n = bits.shape
    assert n % 8 == 0, "bit count must be a byte multiple on device"
    b = bits.reshape(*lead, n // 8, 8).astype(jnp.uint8)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.uint8)
    return jnp.sum(b * weights, axis=-1, dtype=jnp.uint8)


def jnp_unpack_bits(data):
    """Device-side unpack: [..., n] uint8 -> [..., 8*n] 0/1 int8 (MSB-first)."""
    import jax.numpy as jnp

    shifts = jnp.asarray([7, 6, 5, 4, 3, 2, 1, 0], dtype=jnp.uint8)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8).astype(jnp.int8)
