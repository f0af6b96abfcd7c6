"""Turbo-code rate matching, 36.212 5.1.4.1: sub-block interleaver +
circular buffer + bit selection, and the soft-combining inverse.

Capability parity with lib/src/phy/fec/rm_turbo.c. Same design insight as
the reference — precompute everything as index tables per (K, rv, E)
(rm_turbo.c:65-93 builds static gather/scatter LUTs for all 188 CB sizes x
4 RVs) — but realized as numpy index arrays driving XLA gather (TX) and
scatter-add (RX soft combine into the HARQ buffer), instead of the
SSE/AVX byte-level copies.
"""

from __future__ import annotations

import functools

import numpy as np

from .tables import cb_size_index  # noqa: F401  (validates K)

#: Sub-block interleaver column count and permutation (36.212 Table 5.1.4-1).
NCOLS = 32
PERM = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)

_NULL = -1


@functools.lru_cache(maxsize=512)
def _wmap(k: int, f: int) -> np.ndarray:
    """Circular-buffer map: w position -> flat index into d[3, K+4], or -1.

    Builds the three sub-block interleavers (streams 0/1 row-column, stream
    2 the +1-shifted variant) over inputs padded with ND leading NULLs, with
    the first ``f`` filler positions of streams 0 and 1 also NULL
    (36.212 5.1.3.2 / 5.1.4.1.1), then interlaces streams 1 and 2 after
    stream 0 (5.1.4.1.2).
    """
    d = k + 4
    r = -(-d // NCOLS)  # rows
    kp = r * NCOLS
    nd = kp - d

    # y index (position in padded stream) addressed by each v position
    j = np.arange(kp, dtype=np.int64)
    y01 = (j % r) * NCOLS + PERM[j // r]
    y2 = (PERM[j // r] + NCOLS * (j % r) + 1) % kp

    def to_d(y: np.ndarray, stream: int, null_filler: bool) -> np.ndarray:
        pos = y - nd
        out = np.where(pos >= 0, stream * d + pos, _NULL)
        if null_filler and f > 0:
            out = np.where((pos >= 0) & (pos < f), _NULL, out)
        return out

    v0 = to_d(y01, 0, True)
    v1 = to_d(y01, 1, True)
    v2 = to_d(y2, 2, False)

    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = v0
    w[kp::2] = v1
    w[kp + 1 :: 2] = v2
    return w


@functools.lru_cache(maxsize=2048)
def _circle(k: int, f: int, rv: int, ncb: int) -> np.ndarray:
    """One full circle of useful (non-NULL) circular-buffer reads starting
    at k0(rv), as flat d[3, K+4] indices (36.212 5.1.4.1.2)."""
    d = k + 4
    r = -(-d // NCOLS)
    w = _wmap(k, f)[:ncb]
    k0 = r * (2 * (-(-ncb // (8 * r))) * rv + 2)
    valid = w[(k0 + np.arange(ncb)) % ncb]
    return valid[valid != _NULL].astype(np.int32)


@functools.lru_cache(maxsize=2048)
def _selection(k: int, f: int, rv: int, e: int, ncb: int) -> np.ndarray:
    """TX bit-selection map: e output positions -> flat d[3, K+4] indices
    (the circle tiled to length e)."""
    circle = _circle(k, f, rv, ncb)
    reps = -(-e // len(circle))
    return np.tile(circle, reps)[:e]


class RateMatchTurbo:
    """Rate (de)matcher for one code-block size.

    Parameters
    ----------
    k:   turbo interleaver size (valid CB size)
    f:   filler bits in this CB (first CB of a segmented TB)
    ncb: soft-buffer-limited circular buffer length (default Kw = 3*Kp)
    """

    def __init__(self, k: int, f: int = 0, ncb: int | None = None):
        cb_size_index(k)
        self.k = k
        self.d = k + 4
        self.rows = -(-self.d // NCOLS)
        self.kp = self.rows * NCOLS
        self.kw = 3 * self.kp
        self.ncb = self.kw if ncb is None else ncb
        self.f = f

    # --- host index plans ----------------------------------------------------

    def tx_indices(self, rv: int, e: int) -> np.ndarray:
        return _selection(self.k, self.f, rv, e, self.ncb)

    def wmap(self) -> np.ndarray:
        return _wmap(self.k, self.f)

    # --- host reference paths (goldens) --------------------------------------

    def tx_np(self, d_streams: np.ndarray, rv: int, e: int) -> np.ndarray:
        """d[..., 3, K+4] bits -> e[..., E] selected bits."""
        flat = np.reshape(d_streams, (*d_streams.shape[:-2], 3 * self.d))
        return np.take(flat, self.tx_indices(rv, e), axis=-1)

    # --- device paths ---------------------------------------------------------

    def tx(self, d_streams, rv: int, e: int):
        """jnp: d[..., 3, K+4] -> [..., E] (gather; jit-friendly)."""
        import jax.numpy as jnp

        idx = jnp.asarray(self.tx_indices(rv, e))
        flat = d_streams.reshape(*d_streams.shape[:-2], 3 * self.d)
        return jnp.take(flat, idx, axis=-1)

    def rx(self, llr_e, rv: int, softbuffer=None):
        """jnp soft de-rate-matching with HARQ combining.

        llr_e[..., E] demodulated LLRs -> (d_llr[..., 3, K+4], new
        softbuffer[..., Kw]). ``softbuffer`` carries combined LLRs across
        retransmissions (the reference's srslte_softbuffer_rx_t,
        lib/src/phy/fec/softbuffer.c); pass None for a first transmission.
        Filler positions are returned as strong known-zero LLRs.
        """
        import jax.numpy as jnp

        from ...utils.scatter import place

        e = llr_e.shape[-1]
        d_flat_len = 3 * self.d
        # The selection is the k0(rv) circle tiled to E: combining
        # repetitions = zero-pad to a whole number of circles, sum the
        # circle copies, then one static placement into the d domain —
        # no runtime scatter.
        circle = _circle(self.k, self.f, rv, self.ncb)
        n = len(circle)
        reps = -(-e // n)
        pad = reps * n - e
        if pad:
            llr_e = jnp.pad(llr_e, [(0, 0)] * (llr_e.ndim - 1) + [(0, pad)])
        int8_lane = llr_e.dtype == jnp.int8
        if int8_lane:
            # 8-bit lane (rm_turbo.c:378-905 8-bit combining): widen to
            # i32 for the repetition sum + HARQ add, saturate back to
            # the symmetric int8 range like the reference's saturating
            # SIMD adds
            summed = jnp.sum(
                llr_e.astype(jnp.int32).reshape(
                    *llr_e.shape[:-1], reps, n), axis=-2)
        else:
            summed = jnp.sum(
                llr_e.reshape(*llr_e.shape[:-1], reps, n), axis=-2)
        acc = place(summed, circle, d_flat_len)
        if softbuffer is not None:
            acc = acc + (softbuffer.astype(jnp.int32) if int8_lane
                         else softbuffer)
        if int8_lane:
            acc = jnp.clip(acc, -127, 127).astype(jnp.int8)
        new_soft = acc

        d_llr = acc.reshape(*acc.shape[:-1], 3, self.d)
        if self.f > 0:
            # filler bits are known zeros: pin a strong positive LLR
            # (convention: llr > 0 <=> bit 0)
            strong = jnp.asarray(127 if int8_lane else 1e4, d_llr.dtype)
            d_llr = d_llr.at[..., 0, : self.f].set(strong)
        return d_llr, new_soft

    def softbuffer_shape(self) -> tuple[int, ...]:
        return (3 * self.d,)
