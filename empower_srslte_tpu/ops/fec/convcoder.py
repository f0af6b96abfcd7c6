"""K=7 tail-biting convolutional code, rate 1/3 (36.212 5.1.3.1).

Capability parity with lib/src/phy/fec/convcoder.c and viterbi.c (the
port/SSE/AVX2/NEON soft Viterbi decoders behind PBCH and PDCCH,
pbch.c:156,425 / pdcch.c:79,341).

Batched design: the decoder is a max-log Viterbi — a 64-state
add-compare-select lax.scan with survivor decisions stored per step and a
reverse traceback scan; tail-biting is handled with the standard
wrap-around trick (decode the circularly-extended sequence, keep the
middle copy), all fully batched over codewords (e.g. every PDCCH blind
decoding candidate at once).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

#: Generator polynomials G0=133, G1=171, G2=165 (octal), MSB = newest bit.
POLYS = (0o133, 0o171, 0o165)
NOF_STATES = 64
RATE = 3


@functools.lru_cache(maxsize=1)
def _tables():
    """Transition tables over state s = (u_{k-1}..u_{k-6}).

    next_state[s, u], out_bits[s, u, 3]; and the reverse view
    prev_state[s', b] (b = the shifted-out oldest bit hypothesis) with
    prev_u[s'] = newest input bit implied by s'.
    """
    ns = np.zeros((NOF_STATES, 2), np.int32)
    out = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for s in range(NOF_STATES):
        for u in (0, 1):
            reg = (u << 6) | s
            ns[s, u] = (u << 5) | (s >> 1)
            for j, g in enumerate(POLYS):
                out[s, u, j] = bin(reg & g).count("1") % 2
    ps = np.zeros((NOF_STATES, 2), np.int32)
    pu = np.zeros(NOF_STATES, np.int32)
    pout = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for sp in range(NOF_STATES):
        u = sp >> 5
        pu[sp] = u
        for b in (0, 1):
            s = ((sp & 31) << 1) | b
            ps[sp, b] = s
            pout[sp, b] = out[s, u]
    return ns, out, ps, pu, pout


def conv_encode_np(u: np.ndarray) -> np.ndarray:
    """Tail-biting encode u[..., K] 0/1 -> d[..., 3, K] (initial state =
    last 6 input bits, 36.212 5.1.3.1)."""
    u = np.atleast_2d(np.asarray(u, np.int8))
    ns, out, *_ = _tables()
    b, k = u.shape
    state = np.zeros(b, np.int32)
    for j in range(6):
        state |= u[:, k - 1 - j].astype(np.int32) << (5 - j)
    d = np.empty((b, RATE, k), np.int8)
    for i in range(k):
        ui = u[:, i].astype(np.int32)
        d[:, :, i] = out[state, ui]
        state = ns[state, ui]
    return d


def conv_encode(u):
    """jnp tail-biting encode u[..., K] -> d[..., 3, K]."""
    ns, out, *_ = _tables()
    ns_j, out_j = jnp.asarray(ns), jnp.asarray(out)
    k = u.shape[-1]
    u = u.astype(jnp.int32)
    state = jnp.zeros(u.shape[:-1], jnp.int32)
    for j in range(6):
        state = state | (u[..., k - 1 - j] << (5 - j))

    def step(state, ui):
        o = out_j[state, ui]
        return ns_j[state, ui], o

    _, outs = jax.lax.scan(step, state, jnp.moveaxis(u, -1, 0))
    return jnp.moveaxis(outs, 0, -1)  # [..., 3, K]


#: Circular-halo length for tail-biting convergence: ~6x the constraint
#: length (K=7), the standard truncation/training depth for Viterbi.
TRAIN_LEN = 40


def viterbi_decode(llr, wrap: int = 1, train: int | None = TRAIN_LEN,
                   impl: str = "auto"):
    """Batched tail-biting max-log Viterbi, plain-JAX formulation.

    llr [..., 3, K] soft values (positive <=> bit 0) -> bits [..., K].
    ``wrap``: number of extra circular passes prepended AND appended for
    tail-biting convergence (decisions taken from the middle copy).
    ``train``: when set, the circular extension is truncated to
    min(train, wrap*K) columns per side — a 40-step halo trains the
    border metrics / flushes the traceback as well as a full extra copy
    (>=5 constraint lengths, the classic truncation-depth rule; the
    scan time is proportional to the step count, so full copies cost
    K/40x more for identical decisions at any workable SNR). For K<=40
    this is exactly the full-copy path.

    Design (same playbook as the turbo NII kernel): the 64 trellis
    states ride the MAJOR axis so every trellis access is a
    constant-index row permute, and the survivor paths use REGISTER
    EXCHANGE — each state carries its last <=64 decisions packed in
    int32 registers, selected between two statically-permuted copies per
    step — so there is no stored-decision array and no dynamic-gather
    traceback (the reference's metric[:, ps] / take_along_axis shape,
    viterbi37_port.c structure, needs a per-step dynamic gather).

    The scan runs in THREE segments, exploiting that registers never
    influence metrics (decisions are identical to a single full scan):
    the prepended halo updates metrics only (its decisions are never
    read back — the registers stay zero and drop out of the program);
    the middle K steps run the full ACS + register exchange; the
    appended halo keeps selecting survivor registers along the winning
    branches but stops shifting new bits in (its decisions are unread
    too), so the middle decisions end the scan at fixed positions
    [0, K) and the register count is ceil(K/32) instead of
    ceil((K+halo)/32).
    """
    ns, out, ps, pu, pout = _tables()

    # On the GPU the Pallas kernel (viterbi_pallas.py) runs the same
    # three-segment recursion in one launch instead of one loop step per
    # trellis step; decisions are bit-identical (asserted in tests).
    # wrap == 1 is the only tail-biting configuration the kernel
    # implements (its halo is always circular); wrap=0 (terminated
    # input) and wrap>=2 stay on the scan path.
    if impl == "auto" and wrap == 1:
        from ...backend import platform

        if platform() == "gpu":
            from .viterbi_pallas import viterbi_decode_pallas

            return viterbi_decode_pallas(llr, train=train)

    *lead, three, k = llr.shape
    b = int(np.prod(lead)) if lead else 1
    x = jnp.moveaxis(llr.reshape(b, 3, k), -1, 0)          # [K, B, 3]
    halo = wrap * k
    if train is not None:
        halo = min(halo, train)
    if halo > k:
        # wrap >= 2 untruncated: the halo spans multiple circular copies
        x_ext = jnp.concatenate([x] * (-(-halo // k)), axis=0)
        x_pre, x_post = x_ext[-halo:], x_ext[:halo]
    else:
        x_pre = x[-halo:] if halo else x[:0]
        x_post = x[:halo]

    # static tables: predecessor row and branch-output combo index per
    # (next state, branch); input bit per (arrived-at) state
    psel = [jnp.asarray(ps[:, u]) for u in (0, 1)]          # [64] each
    pidx = [jnp.asarray((pout[:, u, 0] << 2) | (pout[:, u, 1] << 1)
                        | pout[:, u, 2]) for u in (0, 1)]
    pu_col = jnp.asarray(pu.astype(np.int32))[:, None]      # [64, 1]

    n_regs = (k - 1) // 32 + 1

    def metric_step(metric, llr_k):
        l0, l1, l2 = llr_k[:, 0], llr_k[:, 1], llr_k[:, 2]  # [B]
        # the 8 possible branch metrics (sign pattern = 3 output bits)
        p01, m01 = l0 + l1, l0 - l1
        comb = jnp.stack([p01 + l2, p01 - l2, m01 + l2, m01 - l2,
                          -m01 + l2, -m01 - l2, -p01 + l2, -p01 - l2],
                         axis=0) * 0.5                      # [8, B]
        cand0 = metric[psel[0]] + comb[pidx[0]]
        cand1 = metric[psel[1]] + comb[pidx[1]]
        best = cand1 > cand0                                # [64, B]
        new = jnp.where(best, cand1, cand0)
        # renormalize by state 0's metric — the SAME constant the Pallas
        # kernel subtracts (viterbi_pallas.py), so both paths round
        # identically and decisions are bit-identical, not just
        # tie-break-equal
        return new - new[0:1], best

    def acs_train(metric, llr_k):                           # halo: no regs
        new, _ = metric_step(metric, llr_k)
        return new, None

    def acs_full(carry, llr_k):                             # middle copy
        metric, regs = carry
        new, best = metric_step(metric, llr_k)
        # register exchange: survivor path follows the winning branch
        sel = [jnp.where(best, r[psel[1]], r[psel[0]]) for r in regs]
        out_regs = []
        carry_bit = jnp.broadcast_to(pu_col, best.shape)
        for r in sel:
            out_regs.append((r << 1) | carry_bit)
            carry_bit = (r >> 31) & 1
        return (new, out_regs), None

    def acs_flush(carry, llr_k):                            # halo: no shift
        metric, regs = carry
        new, best = metric_step(metric, llr_k)
        sel = [jnp.where(best, r[psel[1]], r[psel[0]]) for r in regs]
        return (new, sel), None

    metric0 = jnp.zeros((NOF_STATES, b), llr.dtype)
    regs0 = [jnp.zeros((NOF_STATES, b), jnp.int32) for _ in range(n_regs)]
    metric1, _ = jax.lax.scan(acs_train, metric0, x_pre, unroll=8)
    (metric2, regs2), _ = jax.lax.scan(acs_full, (metric1, regs0), x,
                                       unroll=8)
    (metric, regs), _ = jax.lax.scan(acs_flush, (metric2, regs2), x_post,
                                     unroll=8)

    win = jnp.argmax(metric, axis=0)                        # [B]
    win_regs = [jnp.take_along_axis(r, win[None, :], axis=0)[0]
                for r in regs]                              # [B] each

    # middle-copy decision t last shifted during the middle scan, so it
    # sits (k - 1 - t) bits from the newest
    cols = []
    for t in range(k):
        pos = k - 1 - t
        cols.append((win_regs[pos // 32] >> (pos % 32)) & 1)
    bits = jnp.stack(cols, axis=-1).astype(jnp.int8)        # [B, k]
    return bits.reshape(*lead, k)
