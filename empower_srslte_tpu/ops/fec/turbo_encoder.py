"""LTE turbo encoder: rate-1/3 PCCC of two 8-state RSC codes, 36.212 5.1.3.2.

Capability parity with lib/src/phy/fec/turbocoder.c (srslte_tcod_encode).
Constituent code: G(D) = [1, g1(D)/g0(D)] with g0 = 1 + D^2 + D^3 (feedback)
and g1 = 1 + D + D^3. A vectorized numpy path (host golden/TX-table
generation) and a batched GF(2) matrix-product device path are provided;
the trellis transition tables here are shared with the max-log-MAP
decoder.

Output layout: three streams d0 (systematic), d1 (parity 1), d2 (parity 2),
each of length K + 4 including the 36.212 5.1.3.2.2 tail-bit permutation.
"""

from __future__ import annotations

import functools

import numpy as np

from .tables import qpp_interleaver

#: Number of trellis states (2^3 registers).
NOF_STATES = 8
#: Tail bits per stream appended by trellis termination.
TAIL = 4


class TurboTrellis:
    """Static transition tables for the LTE RSC constituent code.

    State encoding: s = (r1 << 2) | (r2 << 1) | r3 where r1 is the most
    recent register. Per (state, input) the tables give next state and
    parity output; ``prev_state``/``prev_parity`` are the time-reversed
    view used by the backward (beta) recursion.
    """

    def __init__(self):
        ns = np.zeros((NOF_STATES, 2), dtype=np.int32)
        par = np.zeros((NOF_STATES, 2), dtype=np.int32)
        for s in range(NOF_STATES):
            r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            for u in (0, 1):
                a = u ^ r2 ^ r3            # feedback g0 = 1 + D^2 + D^3
                z = a ^ r1 ^ r3            # output   g1 = 1 + D + D^3
                ns[s, u] = (a << 2) | (r1 << 1) | r2
                par[s, u] = z
        self.next_state = ns
        self.parity = par
        # feedback bit that *terminates* (drives a=0): u_tail = r2 ^ r3
        self.tail_input = np.array(
            [((s >> 1) & 1) ^ (s & 1) for s in range(NOF_STATES)], dtype=np.int32
        )
        # reverse tables: prev_state[s', u] = s such that next_state[s,u] = s'
        ps = np.zeros((NOF_STATES, 2), dtype=np.int32)
        pp = np.zeros((NOF_STATES, 2), dtype=np.int32)
        for s in range(NOF_STATES):
            for u in (0, 1):
                sp = ns[s, u]
                ps[sp, u] = s
                pp[sp, u] = par[s, u]
        self.prev_state = ps
        self.prev_parity = pp


@functools.lru_cache(maxsize=1)
def trellis() -> TurboTrellis:
    return TurboTrellis()


def _rsc_encode_np(u: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One RSC over batched inputs u[B, K] -> (parity[B, K], tail bits).

    Tail bits: three termination steps with the feedback-cancelling input,
    returning (x_tail[B, 3], z_tail[B, 3]).
    """
    t = trellis()
    b, k = u.shape
    state = np.zeros(b, dtype=np.int32)
    parity = np.empty((b, k), dtype=np.int8)
    for i in range(k):
        ui = u[:, i].astype(np.int32)
        parity[:, i] = t.parity[state, ui]
        state = t.next_state[state, ui]
    x_tail = np.empty((b, 3), dtype=np.int8)
    z_tail = np.empty((b, 3), dtype=np.int8)
    for j in range(3):
        ui = t.tail_input[state]
        x_tail[:, j] = ui
        z_tail[:, j] = t.parity[state, ui]
        state = t.next_state[state, ui]
    return parity, x_tail, z_tail


def turbo_encode_np(u: np.ndarray) -> np.ndarray:
    """Encode u[B, K] (0/1) -> d[B, 3, K+4] int8 streams (36.212 5.1.3.2).

    Stream tail layout per 36.212 5.1.3.2.2:
      d0: x_0..x_{K-1}, x_K,  z_{K+1}, x'_K,  z'_{K+1}
      d1: z_0..z_{K-1}, z_K,  x_{K+2}, z'_K,  x'_{K+2}
      d2: z'_0..z'_{K-1}, x_{K+1}, z_{K+2}, x'_{K+1}, z'_{K+2}
    """
    u = np.asarray(u, dtype=np.int8)
    if u.ndim == 1:
        return turbo_encode_np(u[None])[0]
    b, k = u.shape
    pi = qpp_interleaver(k)
    z, x_t, z_t = _rsc_encode_np(u)
    u2 = u[:, pi]
    z2, x2_t, z2_t = _rsc_encode_np(u2)

    d = np.empty((b, 3, k + TAIL), dtype=np.int8)
    d[:, 0, :k] = u
    d[:, 1, :k] = z
    d[:, 2, :k] = z2
    d[:, 0, k:] = np.stack([x_t[:, 0], z_t[:, 1], x2_t[:, 0], z2_t[:, 1]], axis=1)
    d[:, 1, k:] = np.stack([z_t[:, 0], x_t[:, 2], z2_t[:, 0], x2_t[:, 2]], axis=1)
    d[:, 2, k:] = np.stack([x_t[:, 1], z_t[:, 2], x2_t[:, 1], z2_t[:, 2]], axis=1)
    return d


# --- GF(2) matrix-product encoder -------------------------------------------
#
# The RSC constituent encoder is LINEAR over GF(2) and time-invariant from
# the zero state, so its parity stream is a Toeplitz generator matrix in
# the parity impulse response h (periodic with period 7 = the order of the
# 3-bit state-update matrix), and the final encoder state is a [K, 3]
# linear map with period-7 columns. Encoding therefore runs as ONE int8
# matrix product per constituent (int8 tensor cores on the GPU) — with the
# QPP interleaver folded into the second constituent's matrix as a row
# permutation — instead of a K-step serial scan over the trellis; the
# final state and the termination bits are a few int32 row sums. The
# reference reaches the same goal with byte-LUT tables (turbocoder.c).
# Exactness: 0/1 operands accumulate in int32, mod 2 at the end.


@functools.lru_cache(maxsize=32)
def _mm_tables(k: int):
    """(Gz [K,K] int8, Fs [K,3] int8, Tmat [3,6] int8) for one RSC.

    Gz[j, i] = h[i-j]: parity of impulse response; z = (u @ Gz) mod 2.
    Fs: final-state bits as linear functions of the input.
    Tmat: the 6 termination outputs (x_tail ++ z_tail) as linear
    functions of the final state bits (termination is linear: the
    feedback-cancelling input u = r2 ^ r3 and z = r1 ^ r3).
    """
    t = trellis()
    e = np.zeros((1, k), np.int8)
    e[0, 0] = 1
    h, _, _ = _rsc_encode_np(e)
    h = h[0].astype(np.int8)
    hpad = np.concatenate([np.zeros(k - 1, np.int8), h])
    from numpy.lib.stride_tricks import as_strided

    st = hpad.strides[0]
    gz = as_strided(hpad[k - 1 :], shape=(k, k), strides=(-st, st)).copy()

    # zero-input state orbit from the post-impulse state (period 7)
    s = int(t.next_state[0, 1])
    orbit = []
    for _ in range(7):
        orbit.append(s)
        s = int(t.next_state[s, 0])
    bits = lambda s: [(s >> 2) & 1, (s >> 1) & 1, s & 1]
    fs = np.zeros((k, 3), np.int8)
    for j in range(k):
        fs[j] = bits(orbit[(k - 1 - j) % 7])

    tmat = np.zeros((3, 6), np.int8)
    for row, s0 in enumerate((4, 2, 1)):       # basis states r1, r2, r3
        s, xs, zs = s0, [], []
        for _ in range(3):
            ui = int(t.tail_input[s])
            xs.append(ui)
            zs.append(int(t.parity[s, ui]))
            s = int(t.next_state[s, ui])
        tmat[row] = xs + zs
    return gz, fs, tmat


def _gf2_narrow(x, m):
    """(x @ m) mod 2 for a narrow 0/1 map m [n, c] (c <= 6), one int32
    row sum per column, no matrix product: on an H100, XLA's int8 matrix
    product [..., 3] @ [3, 6] returned wrong sums (the [..., K] @ [K, 3]
    one was right; a [B, K, 3] broadcast sum in its place made the
    encoder 2.6x slower)."""
    import jax.numpy as jnp

    x = x.astype(jnp.int32)
    m = np.asarray(m, np.int32)
    return jnp.stack([jnp.sum(x * m[:, c], axis=-1)
                      for c in range(m.shape[1])], axis=-1) & 1


def _rsc_encode_mm_jnp(u, gz_j, fs, tmat):
    """u [..., K] int8 -> (parity [..., K], x_tail [..., 3], z_tail)."""
    import jax.numpy as jnp

    acc = jnp.matmul(u, gz_j, preferred_element_type=jnp.int32)
    z = (acc & 1).astype(jnp.int8)
    tails = _gf2_narrow(_gf2_narrow(u, fs), tmat).astype(jnp.int8)
    return z, tails[..., 0:3], tails[..., 3:6]


def turbo_encode(u):
    """Device encoder: u [..., K] -> d [..., 3, K+4] int8; jit-compatible.

    Used by the eNB TX path inside jitted subframe composition
    (models/sch.py dlsch_encode)."""
    import jax.numpy as jnp

    k = u.shape[-1]
    gz, fs, tmat = _mm_tables(k)
    pi = qpp_interleaver(k)
    # fold the interleaver: (u[pi]) @ G == u @ G2 with G2[pi[m]] = G[m]
    g2 = np.empty_like(gz)
    g2[pi] = gz
    f2 = np.empty_like(fs)
    f2[pi] = fs
    u = u.astype(jnp.int8)
    z, x_t, z_t = _rsc_encode_mm_jnp(u, jnp.asarray(gz), fs, tmat)
    z2, x2_t, z2_t = _rsc_encode_mm_jnp(u, jnp.asarray(g2), f2, tmat)

    d0 = jnp.concatenate(
        [u, x_t[..., 0:1], z_t[..., 1:2], x2_t[..., 0:1], z2_t[..., 1:2]],
        axis=-1)
    d1 = jnp.concatenate(
        [z, z_t[..., 0:1], x_t[..., 2:3], z2_t[..., 0:1], x2_t[..., 2:3]],
        axis=-1)
    d2 = jnp.concatenate(
        [z2, x_t[..., 1:2], z_t[..., 2:3], x2_t[..., 1:2], z2_t[..., 2:3]],
        axis=-1)
    return jnp.stack([d0, d1, d2], axis=-2).astype(jnp.int8)
