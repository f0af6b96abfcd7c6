"""LTE CRC computation (36.212 5.1.1) as GF(2) linear algebra.

Capability parity with lib/src/phy/fec/crc.c (CRC8/16/24A/24B via byte LUT).
Batched redesign: LTE CRCs use a zero initial register and no output
inversion, so the CRC is a *linear* map over GF(2). For each message length
K we precompute the parity matrix H[K, L] with H[i] = x^(K-1-i+L) mod g(x);
then crc(bits) = (bits @ H) mod 2 — a single f32 matmul, exact because
its 0/1 operands are exact in any precision (TF32 included) and row sums
stay far below 2^24. This turns the reference's per-CB
early-stop CRC check inside the turbo iteration loop (lib/src/phy/phch/
sch.c:382) into a fully batched device op with no host sync.

Host-side (test vectors, table generation) a plain bitwise numpy
implementation is also provided.
"""

from __future__ import annotations

import functools

import numpy as np

# Generator polynomials, MSB-first including the x^L term (36.212 5.1.1).
POLY_CRC24A = 0x1864CFB
POLY_CRC24B = 0x1800063
POLY_CRC16 = 0x11021
POLY_CRC8 = 0x19B


class Crc:
    """One CRC flavor: polynomial + order, with host and device paths."""

    def __init__(self, poly: int, order: int, name: str):
        self.poly = poly
        self.order = order
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"Crc({self.name})"

    # --- host path ----------------------------------------------------------

    def compute(self, bits: np.ndarray) -> np.ndarray:
        """CRC of a 0/1 bit vector (MSB-first), returned as [order] bits."""
        reg = 0
        top = 1 << self.order
        for b in np.asarray(bits, dtype=np.int64):
            reg = (reg << 1) | int(b)
            if reg & top:
                reg ^= self.poly
        # flush with `order` zero bits
        for _ in range(self.order):
            reg <<= 1
            if reg & top:
                reg ^= self.poly
        return np.array(
            [(reg >> (self.order - 1 - i)) & 1 for i in range(self.order)], dtype=np.int8
        )

    def attach(self, bits: np.ndarray, mask_rnti: int = 0) -> np.ndarray:
        """bits ++ crc(bits), optionally XOR-masked by an RNTI (PDCCH)."""
        crc = self.compute(bits)
        if mask_rnti:
            mask = np.array(
                [(mask_rnti >> (self.order - 1 - i)) & 1 for i in range(self.order)],
                dtype=np.int8,
            )
            crc = crc ^ mask
        return np.concatenate([np.asarray(bits, dtype=np.int8), crc])

    # --- device path --------------------------------------------------------

    @functools.lru_cache(maxsize=1024)
    def parity_matrix(self, length: int) -> np.ndarray:
        """H[length, order] with H[i] = x^(length-1-i+order) mod g(x), int8.

        crc(bits) == (bits @ H) mod 2 for an MSB-first bit vector of the
        given length. For a message with its CRC appended,
        (msg||crc) @ H_{K+L} mod 2 == 0 iff the CRC checks.
        """
        top = 1 << self.order
        mask = top - 1
        rows = np.empty((length, self.order), dtype=np.int8)
        r = 1  # x^0; will become x^(length-1-i+order) mod g by repeated shifts
        # start from the last row: x^order mod g
        for _ in range(self.order):
            r <<= 1
            if r & top:
                r ^= self.poly
        for i in range(length - 1, -1, -1):
            rows[i] = [(r >> (self.order - 1 - j)) & 1 for j in range(self.order)]
            r <<= 1
            if r & top:
                r ^= self.poly
        return rows

    def jnp_compute(self, bits):
        """Batched device CRC: bits [..., K] int -> crc [..., order] int32."""
        import jax.numpy as jnp

        k = bits.shape[-1]
        h = jnp.asarray(self.parity_matrix(k), dtype=jnp.float32)
        acc = jnp.matmul(bits.astype(jnp.float32), h, preferred_element_type=jnp.float32)
        return jnp.mod(acc.astype(jnp.int32), 2)

    def jnp_check(self, bits_with_crc):
        """Batched device check: [..., K+order] -> bool [...] (True = OK)."""
        import jax.numpy as jnp

        rem = self.jnp_compute(bits_with_crc)
        return jnp.all(rem == 0, axis=-1)


CRC24A = Crc(POLY_CRC24A, 24, "24A")
CRC24B = Crc(POLY_CRC24B, 24, "24B")
CRC16 = Crc(POLY_CRC16, 16, "16")
CRC8 = Crc(POLY_CRC8, 8, "8")
