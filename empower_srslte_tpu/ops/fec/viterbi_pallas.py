"""Viterbi kernel for Hopper (K=7 tail-biting, rate 1/3), Pallas/Triton.

The XLA-scan Viterbi (convcoder.viterbi_decode) runs one loop iteration,
and on a GPU at least one kernel launch, per trellis step: about K + 80
serial steps per DCI size on the PDCCH blind-search path. This kernel
runs the whole trellis in one launch, each thread carrying its
codewords' 64 path metrics in registers.

* **State-unrolled**: the 64 trellis states are 64 Python variables of
  one (sub, lanes) block each, so the butterfly wiring
  (s' = u<<5 | s>>1) is variable renaming — no shuffles or gathers.
* **Stored decisions with a traceback**: each step's 64 survivor bits
  are packed into two int32 words and stored to a global-memory output
  (the caller discards it); a traceback from the winning state reads
  them back. Register exchange would hold ceil(K/32) words per state
  (64 more registers per word), which a thread cannot keep alongside
  the metrics.
* **Three segments** (as the scan): the circular training halo updates
  metrics only, the middle K steps and the flush halo store decisions;
  the traceback walks the flush halo without emitting and emits one bit
  per middle step. Decisions equal the scan's register exchange.
* Renormalization subtracts state 0's metric each step, the same
  constant the scan subtracts, so both round identically.

Reference analog: viterbi37_sse.c keeps metrics in SSE registers over
the whole trellis.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .convcoder import TRAIN_LEN, _tables

#: Codewords decoded by one program (one per thread): the metrics and
#: their candidates take ~130 registers a thread, so programs stay small.
TILE = 64


@functools.lru_cache(maxsize=64)
def _vit_kernel(halo: int, k: int):
    ns, out, ps, pu, pout = _tables()
    ps0 = ps[:, 0]
    ps1 = ps[:, 1]
    i0 = (pout[:, 0, 0].astype(np.int32) << 2) | \
        (pout[:, 0, 1].astype(np.int32) << 1) | pout[:, 0, 2]
    i1 = (pout[:, 1, 0].astype(np.int32) << 2) | \
        (pout[:, 1, 1].astype(np.int32) << 1) | pout[:, 1, 2]
    steps = 2 * halo + k

    def kernel(llr_ref, dec_ref, bits_ref):
        # llr_ref  [steps, 3, sub, lanes] f32
        # dec_ref  [steps, 2, sub, lanes] int32 packed survivor bits
        # bits_ref [k, sub, lanes] int8 decoded middle-copy bits
        half = jnp.float32(0.5)

        def metric_step(m, t):
            l0 = llr_ref[t, 0]
            l1 = llr_ref[t, 1]
            l2 = llr_ref[t, 2]
            p01, m01 = l0 + l1, l0 - l1
            c = [(p01 + l2) * half, (p01 - l2) * half,
                 (m01 + l2) * half, (m01 - l2) * half]
            comb = c + [-c[3], -c[2], -c[1], -c[0]]
            best, new = [], []
            for s in range(64):
                c0 = m[ps0[s]] + comb[i0[s]]
                c1 = m[ps1[s]] + comb[i1[s]]
                b = c1 > c0
                best.append(b)
                new.append(jnp.where(b, c1, c0))
            m0 = new[0]
            return tuple(v - m0 for v in new), best

        shape = llr_ref.shape[2:]
        m0 = tuple(jnp.zeros(shape, jnp.float32) for _ in range(64))

        # ---- circular training halo: metrics only ----------------------
        m1 = jax.lax.fori_loop(
            0, halo, lambda t, m: metric_step(m, t)[0], m0)

        # ---- middle copy + flush halo: metrics and decisions -----------
        def dec_body(t, m):
            new, best = metric_step(m, t)
            for word in range(2):
                w = jnp.zeros(shape, jnp.int32)
                for s in range(32):
                    w = w | (best[32 * word + s].astype(jnp.int32) << s)
                dec_ref[t, word] = w
            return new

        m3 = jax.lax.fori_loop(halo, steps, dec_body, m1)

        # ---- winner: first state of maximal metric ---------------------
        best_m = m3[0]
        state = jnp.zeros(shape, jnp.int32)
        for s in range(1, 64):
            upd = m3[s] > best_m
            best_m = jnp.where(upd, m3[s], best_m)
            state = jnp.where(upd, jnp.int32(s), state)

        def prev(s, t):
            w = jnp.where(s >= 32, dec_ref[t, 1], dec_ref[t, 0])
            return ((s & 31) << 1) | ((w >> (s & 31)) & 1)

        # ---- traceback: through the flush halo, then emit the middle ---
        s_mid = jax.lax.fori_loop(
            0, halo, lambda i, s: prev(s, steps - 1 - i), state)

        def emit(i, s):
            t = halo + k - 1 - i
            bits_ref[t - halo] = (s >> 5).astype(jnp.int8)
            return prev(s, t)

        jax.lax.fori_loop(0, k, emit, s_mid)

    return kernel


def viterbi_bits_pallas(llr_tiles, halo: int, k: int,
                        interpret: bool = False):
    """llr_tiles [T, halo+k+halo, 3, sub, lanes] f32 -> decoded bits
    [T, k, sub, lanes] int8."""
    t_tiles, steps, three, sub, lanes = llr_tiles.shape
    assert steps == 2 * halo + k and three == 3
    return pl.pallas_call(
        _vit_kernel(halo, k),
        out_shape=(
            jax.ShapeDtypeStruct((t_tiles, steps, 2, sub, lanes), jnp.int32),
            jax.ShapeDtypeStruct((t_tiles, k, sub, lanes), jnp.int8),
        ),
        grid=(t_tiles,),
        in_specs=[pl.BlockSpec((None, steps, 3, sub, lanes),
                               lambda t: (t, 0, 0, 0, 0))],
        out_specs=(
            pl.BlockSpec((None, steps, 2, sub, lanes),
                         lambda t: (t, 0, 0, 0, 0)),
            pl.BlockSpec((None, k, sub, lanes), lambda t: (t, 0, 0, 0)),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, sub * lanes // 32), num_stages=1),
        name="viterbi_k7",
        cost_estimate=pl.CostEstimate(
            flops=330 * steps * sub * lanes * t_tiles,
            bytes_accessed=(12 + 8) * steps * sub * lanes * t_tiles,
            transcendentals=0),
        interpret=interpret,
    )(llr_tiles)[1]


def viterbi_decode_pallas(llr, train: int = TRAIN_LEN,
                          interpret: bool = False):
    """Drop-in for convcoder.viterbi_decode (wrap=1) on the GPU.

    llr [..., 3, K] -> bits [..., K]. The flattened batch is padded to a
    whole number of tiles (pad codewords decode garbage and are dropped).
    """
    *lead, three, k = llr.shape
    b = int(np.prod(lead)) if lead else 1
    # train=None means an untruncated circular pass (wrap=1 full copy)
    halo = k if train is None else min(train, k)
    x = jnp.moveaxis(llr.reshape(b, 3, k).astype(jnp.float32), -1, 0)
    x = jnp.concatenate([x[-halo:], x, x[:halo]], axis=0)  # [steps, B, 3]
    steps = 2 * halo + k

    lanes = min(TILE, 1 << max(0, b - 1).bit_length())
    bp = -(-b // lanes) * lanes
    if bp != b:
        x = jnp.pad(x, ((0, 0), (0, bp - b), (0, 0)))
    t_tiles = bp // lanes
    xt = x.transpose(0, 2, 1).reshape(steps, 3, t_tiles, 1, lanes)
    xt = xt.transpose(2, 0, 1, 3, 4)        # [T, steps, 3, 1, lanes]

    bits = viterbi_bits_pallas(xt, halo, k, interpret=interpret)
    bits = bits.transpose(0, 2, 3, 1).reshape(bp, k)[:b]
    return bits.reshape(*lead, k)
