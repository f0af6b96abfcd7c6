"""Fused receiver feed: demodulated LLRs -> turbo-kernel tiles as ONE
precomputed index map, plus GF(2) matrices for tile-layout CRC checks.

The reference's receive chain materializes, per code block, the
de-rate-matched LLR buffer (rm_turbo.c:378-905 scatter-add into the
softbuffer), which the decoder then re-reads through its own lane-layout
tables (turbodecoder.c:263-271). A direct port of that staging makes
every step a full-size pass over device memory — pad-to-circular-buffer,
inverse-map gather, constituent stream-split concats, time-major
transpose, tile packing.

Batched replacement: the composition

    codeword bit position -> circular-buffer position (36.212 5.1.4.1.2)
    -> sub-block deinterleave (Table 5.1.4-1) -> d-stream split with tail
    depermutation (5.1.3.2.2) -> decoder batch-tile packing

is a single static permutation per (K, E, F, rv).  ``build_tile_plan``
precomputes it as numpy index tables mapping every row of the decoder's
tile inputs [T, rows, sub, lanes] to a source row of the [n_rows, lanes]
LLR array — with a reserved zero row for never-transmitted positions and
a strong-prior row for filler bits — so the whole chain executes as three
XLA row-gathers feeding the Pallas NII kernel directly.  Repetitions
(E > circular buffer length) become a static ``reps`` leading axis that
is summed, reproducing the reference's soft-combining adds.

CRC checks never leave the tile layout either: a CRC over GF(2) is a
linear map, so the syndrome of the decoder's a-posteriori LLR tiles is
one contraction with a (row-permuted) parity matrix — including in
the *interleaved* domain, where the early-stop check runs without the
per-iteration deinterleave gather (P_int = P[qpp_interleaver]).  The
transport-block CRC24A across code blocks composes from per-CB local
syndromes via x^n-shift matrices: crc(a || b) = shift(crc(a), len(b)) ^
crc(b).
"""

from __future__ import annotations

import functools

import numpy as np

from .rate_matching import RateMatchTurbo
from .tables import qpp_interleaver

#: Prior pinned on filler bits (known zeros; positive LLR <=> bit 0) —
#: same role as the old d_llr pinning in rate_matching.rx().
STRONG_LLR = 1e4


@functools.lru_cache(maxsize=512)
def stream_row_maps(k: int):
    """d-flat index feeding each decoder input row (36.212 5.1.3.2.2).

    Returns (sys1 [k+3], par1 [k+3], par2 [k+3], sys2_tail [3]) where each
    entry is the flat index into d[3, K+4] providing that row — exactly
    TurboDecoder._split_streams applied to an index array (asserted
    equivalent in tests/test_fused_rx.py).
    """
    d = k + 4
    idx = np.arange(3 * d, dtype=np.int64).reshape(3, d)
    d0, d1, d2 = idx
    sys1 = np.concatenate(
        [d0[:k], d0[k : k + 1], d2[k : k + 1], d1[k + 1 : k + 2]])
    par1 = np.concatenate(
        [d1[:k], d1[k : k + 1], d0[k + 1 : k + 2], d2[k + 1 : k + 2]])
    sys2t = np.array([d0[k + 2], d2[k + 2], d1[k + 3]])
    par2 = np.concatenate(
        [d2[:k], d1[k + 2 : k + 3], d0[k + 3 : k + 4], d2[k + 3 : k + 4]])
    return sys1, par1, par2, sys2t


@functools.lru_cache(maxsize=2048)
def _d_sources(k: int, f: int, rv: int, e: int) -> np.ndarray:
    """[3*(K+4), reps] codeword-bit position feeding each d position
    (inverse of RateMatchTurbo.tx_indices), -1 where absent."""
    sel = RateMatchTurbo(k, f=f).tx_indices(rv, e)
    d_len = 3 * (k + 4)
    reps = int(np.bincount(sel, minlength=d_len).max()) if e else 1
    src = np.full((d_len, reps), -1, np.int64)
    order = np.argsort(sel, kind="stable")
    s_sorted = sel[order]
    first = np.searchsorted(s_sorted, s_sorted)
    src[s_sorted, np.arange(e) - first] = order
    return src


#: decoder input name -> (row map selector, n_rows)
_TARGETS = ("sys", "par1", "par2", "ut1", "pt1", "ut2", "pt2")


@functools.lru_cache(maxsize=256)
def build_tile_plan(k: int, members: tuple, rv: int, sub: int,
                    zero_row: int, strong_row: int,
                    g_map_key: bytes | None = None):
    """Index tables for one same-K decode batch.

    members: slot-ordered tuple of (e, f, g_offset, base_row) — one per
    code block, already expanded over any leading batch folds; slot q
    lands at tile t = q // sub, sublane s = q % sub. The source row for
    codeword-bit position p of a member is ``base_row + g_map[g_offset +
    p]`` — ``g_map`` (int64 bytes, identity when None) composes in an
    extra layout hop, e.g. the resource-grid RE map when the LLR source
    is the un-extracted grid (models/pdsch.py grid path).
    Returns dict name -> int32 [reps, T, rows, sub] of source-row ids.
    """
    n = len(members)
    t_tiles = -(-n // sub)
    g_map = (np.frombuffer(g_map_key, dtype=np.int64)
             if g_map_key is not None else None)
    sys1, par1, par2, sys2t = stream_row_maps(k)
    pad8 = lambda a: np.concatenate([a, np.full(8 - len(a), -2)])
    target_rows = {
        "sys": sys1[:k], "par1": par1[:k], "par2": par2[:k],
        "ut1": pad8(sys1[k:]), "pt1": pad8(par1[k:]),
        "ut2": pad8(sys2t), "pt2": pad8(par2[k:]),
    }
    srcs = [_d_sources(k, f, rv, e) for e, f, _o, _b in members]
    reps = max(s.shape[1] for s in srcs)

    out = {}
    for name, dmap in target_rows.items():
        rows = len(dmap)
        idx = np.full((reps, t_tiles, rows, sub), zero_row, np.int32)
        for q, (e, f, off, base) in enumerate(members):
            t, s = divmod(q, sub)
            sm = srcs[q]
            for r in range(sm.shape[1]):
                col = np.where(dmap >= 0, sm[np.maximum(dmap, 0), r], -1)
                gpos = off + np.maximum(col, 0)
                row = g_map[gpos] if g_map is not None else gpos
                idx[r, t, :, s] = np.where(col >= 0, base + row, zero_row)
            if name == "sys" and f > 0:
                # filler bits: known zeros, pinned to the strong-prior row
                idx[0, t, :f, s] = strong_row
        out[name] = idx
    return out


@functools.lru_cache(maxsize=256)
def build_tile_plan_shared(k: int, f: int, rv: int, e_max: int):
    """Shared-index feed tables (round-5 feed, v2).

    One source index per decoder input row, COMMON to every code block of
    a (K, F, rv) group: codeword-bit position is the same function of d
    position for equal K/F/rv, and the E bits of a member are consecutive
    circular-buffer reads from the same k0 — so a member with E < e_max
    reads its zero padding exactly where the longer members read data
    (positions it never transmitted), and repetition layers it lacks sum
    zeros. This turns the v1 per-slot single-[lanes]-row gathers (16x
    HBM read amplification from sub-tile rows, the round-4 receiver
    bottleneck) into whole-[sub, lanes]-row gathers over a stacked
    [T, e_max + 2, sub, lanes] source.

    Returns dict name -> int32 [reps, rows] of source positions: [0,
    e_max) are codeword-bit positions, e_max is the reserved zero row,
    e_max + 1 the strong-prior row (filler bits, known zeros).
    """
    zero_row, strong_row = e_max, e_max + 1
    sys1, par1, par2, sys2t = stream_row_maps(k)
    pad8 = lambda a: np.concatenate([a, np.full(8 - len(a), -2)])
    target_rows = {
        "sys": sys1[:k], "par1": par1[:k], "par2": par2[:k],
        "ut1": pad8(sys1[k:]), "pt1": pad8(par1[k:]),
        "ut2": pad8(sys2t), "pt2": pad8(par2[k:]),
    }
    sm = _d_sources(k, f, rv, e_max)       # [3*(K+4), reps]
    reps = sm.shape[1]
    out = {}
    for name, dmap in target_rows.items():
        rows = len(dmap)
        idx = np.full((reps, rows), zero_row, np.int32)
        for r in range(reps):
            col = np.where(dmap >= 0, sm[np.maximum(dmap, 0), r], -1)
            idx[r] = np.where(col >= 0, col, zero_row).astype(np.int32)
        if name == "sys" and f > 0:
            # filler bits: known zeros, pinned to the strong-prior row
            idx[0, :f] = strong_row
        out[name] = idx
    return out


# --- GF(2) / CRC matrices for tile-layout checks ----------------------------


def _gf2_mulmod(a: int, b: int, poly: int, order: int) -> int:
    """Carry-less multiply of two GF(2) polynomials mod g."""
    res = 0
    while b:
        if b & 1:
            res ^= a
        a <<= 1
        b >>= 1
    for d in range(res.bit_length() - 1, order - 1, -1):
        if (res >> d) & 1:
            res ^= poly << (d - order)
    return res


@functools.lru_cache(maxsize=4096)
def _xpow_mod(poly: int, order: int, n: int) -> int:
    result, base = 1, 2
    while n:
        if n & 1:
            result = _gf2_mulmod(result, base, poly, order)
        base = _gf2_mulmod(base, base, poly, order)
        n >>= 1
    return result


@functools.lru_cache(maxsize=4096)
def shift_matrix(poly: int, order: int, n: int) -> np.ndarray:
    """W [order, order] with W @ s = syndrome bits of s(x) * x^n mod g
    (MSB-first bit convention, matching Crc.parity_matrix columns).
    Implements crc(a || b) = W_{len(b)} @ crc(a) ^ crc(b)."""
    w = np.zeros((order, order), np.int8)
    xn = _xpow_mod(poly, order, n)
    for j in range(order):
        col = _gf2_mulmod(1 << (order - 1 - j), xn, poly, order)
        w[:, j] = [(col >> (order - 1 - i)) & 1 for i in range(order)]
    return w


@functools.lru_cache(maxsize=1024)
def parity_rows_interleaved(poly: int, order: int, k: int,
                            payload: tuple | None = None) -> np.ndarray:
    """P_int [K, order] f32: parity matrix rows permuted into the QPP-
    interleaved domain, so syndromes compute directly on the decoder's
    interleaved a-posteriori tiles (llr_int row q <-> natural bit pi[q]).

    payload=(lo, hi): restrict to a payload sub-range (local CRC over
    bits lo..hi-1, zero rows elsewhere) — used for the per-CB
    contribution to the transport-block CRC24A.
    """
    from ...utils.crc import Crc

    crc = Crc(poly, order, "tmp")
    if payload is None:
        p = crc.parity_matrix(k).astype(np.float32)
    else:
        lo, hi = payload
        p = np.zeros((k, order), np.float32)
        p[lo:hi] = crc.parity_matrix(hi - lo).astype(np.float32)
    return p[qpp_interleaver(k)]
