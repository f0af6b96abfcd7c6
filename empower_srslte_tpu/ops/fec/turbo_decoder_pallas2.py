"""NII max-log-MAP constituent decoder: a Pallas kernel for Hopper.

The constituent decode behind ``TurboDecoder.decode_tiles``
(ops/fec/turbo_decoder.py), written for the Triton route of Pallas.

* **Layout** ``[T, K, sub, lanes]``: T tiles of ``sub * lanes`` code
  blocks, trellis rows on the second axis. One program decodes one
  (tile, window) pair; every thread carries its code blocks' 8 state
  metrics in registers through the serial recursion, one launch per
  half-iteration instead of one XLA step per trellis row.
* **Next-iteration initialization (NII)** instead of overlap training:
  each window's starting alpha/beta come from the neighbouring windows'
  boundary metrics of the previous half-iteration of the same
  constituent, carried in small ``[T, W+1, 8, sub, lanes]`` arrays.
  Windows are independent within a half-iteration, so the grid
  ``(tiles, windows)`` maps onto parallel blocks as it stands.
* **Beta checkpoints**: the backward sweep stores only the beta entering
  each group of GROUP rows (to a global-memory output that the caller
  discards); the forward sweep recomputes the group's betas from its
  checkpoint into registers before emitting its extrinsics. The
  recomputation repeats the same operations on the same inputs, so the
  betas are bit-identical to a full store, at 1/GROUP of its bytes.
  Metrics are renormalized at group boundaries.
* **Fused extrinsic emission**: the kernel adds the a-priori rows at
  load and emits ``ext = llr - (u + apr)`` directly.

``map_decode_nii_ref`` is the plain-JAX reference with the same contract
(a ``lax.scan`` over window rows, vmapped over windows); in float32 the
kernel's outputs are bit-identical to it.

Tail handling: only the last window's beta needs the 3 termination
steps; they run inside that program from the exact terminated state
using small tail-row inputs, so payload arrays stay unpadded.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .turbo_encoder import trellis

NEG = -1e30

#: Rows between beta checkpoints (and metric renormalizations): 8 measured
#: faster than 16 on the H100 (PERF.md), and divides every window length
#: (sch._pick_window and turbo_sp._pick_window pick multiples of 16).
GROUP = 8

#: Code blocks decoded by one program: 4 warps of two code blocks per
#: thread at full width (measured fastest of 64, 128 and 256 at K=6144;
#: PERF.md).
TILE = 256


@functools.lru_cache(maxsize=1)
def _wiring():
    t = trellis()
    return (t.next_state, t.parity, t.prev_state)


def tile_width(n: int) -> int:
    """Power-of-two tile width for ``n`` code blocks, at most TILE."""
    return min(TILE, 1 << max(0, int(n) - 1).bit_length())


def _gammas(u, p, half):
    g00 = (u + p) * half
    g01 = (u - p) * half
    return {(0, 0): g00, (0, 1): g01, (1, 0): -g01, (1, 1): -g00}


def _beta_step(beta, g):
    ns, par, _ = _wiring()
    return [jnp.maximum(beta[ns[s, 0]] + g[(0, par[s, 0])],
                        beta[ns[s, 1]] + g[(1, par[s, 1])])
            for s in range(8)]


def _alpha_step(alpha, beta_next, g, u):
    """One forward row: (extrinsic, next alpha). The branch metrics
    br_u[s] = alpha[s] + gamma(s, u) serve both the LLR totals and the
    alpha update (alpha[ps[s,u]] + gamma(ps[s,u], u) is br_u[ps[s,u]])."""
    ns, par, ps = _wiring()
    br0 = [alpha[s] + g[(0, par[s, 0])] for s in range(8)]
    br1 = [alpha[s] + g[(1, par[s, 1])] for s in range(8)]
    tot0 = tot1 = None
    for s in range(8):
        t0 = br0[s] + beta_next[ns[s, 0]]
        t1 = br1[s] + beta_next[ns[s, 1]]
        tot0 = t0 if tot0 is None else jnp.maximum(tot0, t0)
        tot1 = t1 if tot1 is None else jnp.maximum(tot1, t1)
    new = [jnp.maximum(br0[ps[s, 0]], br1[ps[s, 1]]) for s in range(8)]
    return tot0 - tot1 - u, new


def _norm8(vs):
    m = vs[0]
    for v in vs[1:]:
        m = jnp.maximum(m, v)
    return [v - m for v in vs]


def _beta_tail(tail_u, tail_p, exact, half):
    """Beta at the end of the payload from the terminated state through
    the 3 tail rows (``tail_u(j)``/``tail_p(j)`` give row j)."""
    beta = exact
    for j in (2, 1, 0):
        beta = _beta_step(beta, _gammas(tail_u(j), tail_p(j), half))
    return _norm8(beta)


def _nii_kernel(l: int, dtype, apriori: bool):
    """Kernel body over grid (T, W); one program per (tile, window).

    Block refs (leading dims squeezed):
      u_ref, p_ref   [l, sub, lanes]           input / parity rows
      e_ref          [l, sub, lanes]           a-priori rows (apriori)
      bounds_ref     [2] int32                 globally first/last window
      ut_ref, pt_ref [8, sub, lanes]           tail rows (3 used)
      a_in, b_in     [8, sub, lanes]           boundary metric inits
      ext_ref        [l, sub, lanes]           extrinsic output
      a_out, b_out   [8, sub, lanes]           boundary metrics produced
      ck_ref         [l // GROUP, 8, sub, lanes] beta checkpoints
    """
    group = GROUP
    assert l % group == 0, (l, group)
    n_groups = l // group
    half = dtype.type(0.5)

    def kernel(u_ref, p_ref, *refs):
        if apriori:
            (e_ref, bounds_ref, ut_ref, pt_ref, a_in, b_in,
             ext_ref, a_out, b_out, ck_ref) = refs
            row = lambda i: u_ref[i] + e_ref[i]
        else:
            (bounds_ref, ut_ref, pt_ref, a_in, b_in,
             ext_ref, a_out, b_out, ck_ref) = refs
            row = lambda i: u_ref[i]
        w = pl.program_id(1)
        # ``bounds`` holds the ids of the globally first / last window: on
        # one card [0, W-1]; under the trellis-sharded path
        # (parallel/turbo_sp.py) only the edge shards carry them, and
        # interior shards take every boundary metric from a_in/b_in.
        is_first = w == bounds_ref[0]
        is_last = w == bounds_ref[1]

        shape = a_in.shape[1:]
        exact = ([jnp.zeros(shape, dtype)]
                 + [jnp.full(shape, dtype.type(NEG), dtype)] * 7)
        beta_tail = _beta_tail(lambda j: ut_ref[j], lambda j: pt_ref[j],
                               exact, half)
        beta0 = tuple(jnp.where(is_last, bt, b_in[s])
                      for s, bt in enumerate(beta_tail))

        # ---- backward sweep: store the beta entering each group --------
        def bgroup(gi, beta):
            g = n_groups - 1 - gi
            base = g * group
            for s in range(8):
                ck_ref[g, s] = beta[s]
            beta = list(beta)
            for j in range(group - 1, -1, -1):
                beta = _beta_step(
                    beta, _gammas(row(base + j), p_ref[base + j], half))
            return tuple(_norm8(beta))

        beta_end = jax.lax.fori_loop(0, n_groups, bgroup, beta0)
        for s in range(8):
            b_out[s] = beta_end[s]

        # ---- forward sweep: recompute the group's betas, emit ----------
        alpha0 = tuple(jnp.where(is_first, ex, a_in[s])
                       for s, ex in enumerate(exact))

        def agroup(g, alpha):
            base = g * group
            us = [row(base + j) for j in range(group)]
            gs = [_gammas(us[j], p_ref[base + j], half)
                  for j in range(group)]
            betas = [None] * group
            betas[-1] = [ck_ref[g, s] for s in range(8)]
            for j in range(group - 1, 0, -1):
                betas[j - 1] = _beta_step(betas[j], gs[j])
            alpha = list(alpha)
            for j in range(group):
                ext, alpha = _alpha_step(alpha, betas[j], gs[j], us[j])
                ext_ref[base + j] = ext
            return tuple(_norm8(alpha))

        alpha_end = jax.lax.fori_loop(0, n_groups, agroup, alpha0)
        for s in range(8):
            a_out[s] = alpha_end[s]

    return kernel


def _slots(a_raw, b_raw):
    """Next-iteration slots: window w's alpha init is the alpha produced
    at the END of window w-1 (a_raw[w-1]); its beta init is the beta
    produced at the START of window w+1 (b_raw[w+1]). The callers pass
    a_st[:, :W] / b_st[:, 1:], which applies the shifts, so the state
    arrays embed the raw outputs at +1 / 0."""
    zero = jnp.zeros_like(a_raw[:, :1])
    return (jnp.concatenate([zero, a_raw], axis=1),
            jnp.concatenate([b_raw, zero], axis=1))


def map_decode_nii(u, p, tail_u, tail_p, a_st, b_st, *, l: int,
                   apr=None, bounds=None, interpret: bool = False):
    """One NII constituent decode.

    u, p:            [T, K, sub, lanes] raw (unhalved) input / parity rows
    tail_u, tail_p:  [T, 8, sub, lanes] tail rows (first 3 rows used)
    a_st, b_st:      [T, W+1, 8, sub, lanes] boundary metrics from this
                     constituent's previous half-iteration: slot w holds
                     the alpha init / beta init for window w (slot W is
                     padding). Pass zeros on the first iteration.
    apr:             optional [T, K, sub, lanes] a-priori extrinsic rows,
                     added to ``u`` at load.
    bounds:          optional int32 [2] ids of the globally first /
                     globally last window (default [0, W-1], one card).
                     The trellis-sharded path passes per-shard values so
                     only edge shards run the exact-init / tail walk.

    Returns (ext [T, K, sub, lanes], a_next, b_next) in the same slot
    convention, ready to pass back on the next call. ``ext`` is relative
    to the summed input, llr - (u + apr).
    """
    t_tiles, k, sub, lanes = u.shape
    assert k % l == 0, (k, l)
    w_count = k // l
    n_groups = l // GROUP
    dtype = jnp.dtype(u.dtype)
    kernel = _nii_kernel(l, dtype, apriori=apr is not None)
    if bounds is None:
        bounds = jnp.asarray([0, w_count - 1], jnp.int32)

    row_spec = pl.BlockSpec((None, l, sub, lanes), lambda t, w: (t, w, 0, 0))
    tail_spec = pl.BlockSpec((None, 8, sub, lanes),
                             lambda t, w: (t, 0, 0, 0))
    st_spec = pl.BlockSpec((None, None, 8, sub, lanes),
                           lambda t, w: (t, w, 0, 0, 0))
    ck_spec = pl.BlockSpec((None, None, n_groups, 8, sub, lanes),
                           lambda t, w: (t, w, 0, 0, 0, 0))
    bounds_spec = pl.BlockSpec((2,), lambda t, w: (0,))
    in_specs = [row_spec, row_spec]
    inputs = [u, p]
    if apr is not None:
        in_specs.append(row_spec)
        inputs.append(apr)
    in_specs += [bounds_spec, tail_spec, tail_spec, st_spec, st_spec]
    inputs += [bounds, tail_u, tail_p, a_st[:, :w_count], b_st[:, 1:]]

    st_shape = jax.ShapeDtypeStruct((t_tiles, w_count, 8, sub, lanes), dtype)
    n_cb = t_tiles * sub * lanes
    ext, a_raw, b_raw, _ck = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((t_tiles, k, sub, lanes), dtype),
            st_shape,
            st_shape,
            jax.ShapeDtypeStruct(
                (t_tiles, w_count, n_groups, 8, sub, lanes), dtype),
        ),
        grid=(t_tiles, w_count),
        in_specs=in_specs,
        out_specs=(row_spec, st_spec, st_spec, ck_spec),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, min(4, sub * lanes // 64)), num_stages=1),
        name="turbo_nii",
        cost_estimate=pl.CostEstimate(
            flops=2 * 60 * k * n_cb,
            # u + p (+ apr) read twice, ext written once
            bytes_accessed=(dtype.itemsize * k * n_cb
                            * (7 if apr is not None else 5)),
            transcendentals=0),
        interpret=interpret,
    )(*inputs)
    return (ext, *_slots(a_raw, b_raw))


def map_decode_nii_ref(u, p, tail_u, tail_p, a_st, b_st, *, l: int,
                       apr=None, bounds=None):
    """Plain-JAX NII constituent decode with the contract of
    ``map_decode_nii``: a ``lax.scan`` over each window's rows, vmapped
    over windows, storing every beta, renormalizing at the same group
    boundaries. The reference the kernel is tested against."""
    t_tiles, k, sub, lanes = u.shape
    w_count = k // l
    dtype = jnp.dtype(u.dtype)
    half = dtype.type(0.5)
    if bounds is None:
        bounds = jnp.asarray([0, w_count - 1], jnp.int32)
    if apr is not None:
        u = u + apr

    # window-major rows [W, l, T, sub, lanes]; metrics [W, 8, T, sub, lanes]
    rows = lambda x: jnp.moveaxis(
        x.reshape(t_tiles, w_count, l, sub, lanes), 0, 2)
    states = lambda x: jnp.transpose(x, (1, 2, 0, 3, 4))
    shape = (t_tiles, sub, lanes)
    exact = ([jnp.zeros(shape, dtype)]
             + [jnp.full(shape, dtype.type(NEG), dtype)] * 7)
    beta_tail = jnp.stack(_beta_tail(lambda j: tail_u[:, j],
                                     lambda j: tail_p[:, j], exact, half))
    exact = jnp.stack(exact)

    def window(w, uw, pw, a0, b0):
        beta0 = jnp.where(w == bounds[1], beta_tail, b0)

        def bstep(beta, x):
            j, uj, pj = x
            new = _beta_step(list(beta), _gammas(uj, pj, half))
            new = jnp.where(j % GROUP == 0, jnp.stack(_norm8(new)),
                            jnp.stack(new))
            return new, beta                 # emits beta_{j+1}

        beta_end, betas = jax.lax.scan(
            bstep, beta0, (jnp.arange(l), uw, pw), reverse=True)

        def astep(alpha, x):
            j, uj, pj, bj = x
            ext, new = _alpha_step(list(alpha), list(bj),
                                   _gammas(uj, pj, half), uj)
            new = jnp.where((j + 1) % GROUP == 0, jnp.stack(_norm8(new)),
                            jnp.stack(new))
            return new, ext

        alpha0 = jnp.where(w == bounds[0], exact, a0)
        alpha_end, ext = jax.lax.scan(
            astep, alpha0, (jnp.arange(l), uw, pw, betas))
        return ext, alpha_end, beta_end

    ext, a_raw, b_raw = jax.vmap(window)(
        jnp.arange(w_count), rows(u), rows(p),
        states(a_st[:, :w_count]), states(b_st[:, 1:]))
    ext = jnp.moveaxis(ext, 2, 0).reshape(t_tiles, k, sub, lanes)
    unstate = lambda x: jnp.transpose(x, (2, 0, 1, 3, 4))
    return (ext, *_slots(unstate(a_raw), unstate(b_raw)))


def to_tiles(x, lanes: int, sub: int = 1):
    """[rows, B] -> [T, rows, sub, lanes] (B = T*sub*lanes), tile-major."""
    rows, b = x.shape
    assert b % (sub * lanes) == 0, (b, lanes, sub)
    t = b // (sub * lanes)
    return x.reshape(rows, t, sub, lanes).transpose(1, 0, 2, 3)


def from_tiles(x):
    """[T, rows, sub, lanes] -> [rows, B]."""
    t, rows, sub, lanes = x.shape
    return x.transpose(1, 0, 2, 3).reshape(rows, t * sub * lanes)
