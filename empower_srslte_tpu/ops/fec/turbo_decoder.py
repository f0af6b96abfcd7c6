"""Batched windowed max-log-MAP turbo decoder.

Capability parity with lib/src/phy/fec/turbodecoder*.c: the reference runs
max-log-MAP with a beta backward sweep then an alpha+LLR forward sweep
(turbodecoder_gen.c:59-198), SIMD lane-parallel windows with 40-step
overlap training (turbodecoder_win.h:58,92) and periodic renormalization.

Batched redesign (not a translation). On the GPU, ``impl="auto"`` runs
the NII Pallas kernel (turbo_decoder_pallas2.py) through
``decode_tiles``; the plain-JAX scan formulation below is the CPU path:

* The unit of work is a *batch* of equal-size code blocks ``[B, 3, K+4]``;
  throughput comes from batching, the analog of the reference's
  pipeline threading (SURVEY.md section 2.6 P2/P3).
* The trellis time axis is cut into W windows decoded in parallel with
  O-step overlap training exactly like the reference's windowed scheme;
  windows ride the minor axis next to the batch: the scan carry is an
  ``[8, B*W]`` array — 8 trellis states by batch x windows.
* State-metric recursions are ``lax.scan``s with static-index gathers for
  the trellis wiring; every step renormalizes by the running max (f32, so
  the reference's every-4-step i16 saturation dance is unnecessary).
* Extrinsic (de)interleaving is an XLA gather with the precomputed QPP
  tables (tables.py), matching rm/interleaver pregeneration in the
  reference (turbodecoder.c:263-271).

LLR convention: positive LLR <=> bit 0 (matches the soft demapper in
ops/modem.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .tables import qpp_deinterleaver, qpp_interleaver
from .turbo_encoder import trellis

NEG_INF = -1e30
#: Overlap training length, same choice as the reference
#: (turbodecoder_win.h: win_overlap_len 40).
DEFAULT_OVERLAP = 40


@functools.lru_cache(maxsize=8)
def _trellis_arrays():
    t = trellis()
    return (
        t.next_state.astype(np.int32),  # [8, 2]
        t.parity.astype(np.int32),      # [8, 2]
        t.prev_state.astype(np.int32),  # [8, 2]
        t.prev_parity.astype(np.int32), # [8, 2]
    )


def _half_branch(lsa, lp, u: int, p):
    """0.5 * ((1-2u) * lsa + (1-2p) * lp); p may be an array."""
    su = 1.0 - 2.0 * u
    sp = 1.0 - 2.0 * p
    return 0.5 * (su * lsa + sp * lp)


def _map_decode(lsa, lp, n_tail: int, init_alpha, init_beta):
    """One max-log-MAP constituent decode over a full trellis.

    Parameters
    ----------
    lsa:  [T, B] systematic + a-priori LLRs (tail positions: systematic only)
    lp:   [T, B] parity LLRs
    n_tail: number of trailing termination steps (no LLR output)
    init_alpha, init_beta: [8] initial state metrics

    Returns llr_out [T - n_tail, B] — total a-posteriori LLRs.
    """
    import jax
    import jax.numpy as jnp

    ns, par, ps, pp = _trellis_arrays()
    ns_j = jnp.asarray(ns)
    par_j = jnp.asarray(par)
    ps_j = jnp.asarray(ps)
    pp_j = jnp.asarray(pp)

    t_len, b = lsa.shape

    # ---- beta backward sweep (store all) ------------------------------------
    def beta_step(beta, inputs):
        lsa_k, lp_k = inputs  # [B]
        # cand[u][s] = beta[ns[s,u]] + gamma(s,u)
        cands = []
        for u in (0, 1):
            nxt = beta[ns_j[:, u], :]                       # [8, B]
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             par_j[:, u][:, None].astype(lsa.dtype))
            cands.append(nxt + g)
        new = jnp.maximum(cands[0], cands[1])
        new = new - jnp.max(new, axis=0, keepdims=True)
        return new, beta

    beta0 = jnp.broadcast_to(init_beta[:, None], (8, b)).astype(lsa.dtype)
    _, betas = jax.lax.scan(
        beta_step, beta0, (lsa, lp), reverse=True
    )  # betas[k] = beta at time k+1 (metric *after* consuming symbol k)... see note

    # note: with reverse=True, scan emits the carry *before* each step when
    # traversing k = T-1 .. 0; the emitted betas[k] is beta_{k+1}, which is
    # exactly what the alpha+LLR forward sweep needs.

    # ---- alpha forward sweep + LLR emit -------------------------------------
    def alpha_step(alpha, inputs):
        lsa_k, lp_k, beta_k1 = inputs
        # total metric per (state s, input u): alpha[s] + gamma + beta[ns]
        tot = []
        for u in (0, 1):
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             par_j[:, u][:, None].astype(lsa.dtype))
            tot.append(alpha + g + beta_k1[ns_j[:, u], :])
        llr_k = jnp.max(tot[0], axis=0) - jnp.max(tot[1], axis=0)  # [B]

        # alpha update: alpha'[s'] = max_u alpha[ps[s',u]] + gamma(ps,u)
        cands = []
        for u in (0, 1):
            prev = alpha[ps_j[:, u], :]
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             pp_j[:, u][:, None].astype(lsa.dtype))
            cands.append(prev + g)
        new = jnp.maximum(cands[0], cands[1])
        new = new - jnp.max(new, axis=0, keepdims=True)
        return new, llr_k

    alpha0 = jnp.broadcast_to(init_alpha[:, None], (8, b)).astype(lsa.dtype)
    _, llrs = jax.lax.scan(alpha_step, alpha0, (lsa, lp, betas))
    return llrs[: t_len - n_tail] if n_tail else llrs


#: Padding LLR for out-of-trellis training steps. A strong "bit 0" prior
#: makes the u=0 transition dominate; since the u=0 transition map is a
#: state permutation with 0 as its only fixed point, the terminated metric
#: {state 0: 0, others: -inf} is (effectively) invariant under padded
#: steps — so exact boundary knowledge survives the training region instead
#: of diffusing to uniform as it would with zero padding. Kept at 1e5 (far
#: above any real metric, far below f32 precision loss when normalization is
#: deferred a few steps).
PAD_LLR = 1e5


def _prepare_windows(lsa, lp, k: int, overlap: int, window: int,
                     halo=None):
    """Build the per-window gather arrays for the windowed sweeps.

    lsa/lp are [T, B] with T = K + 3 (or K + local rows when sharded).
    Returns time-major (lsa_a, lp_a [O+L, W*B], lsa_b, lp_b [L+O, W*B])
    with lane order w-major. Out-of-trellis positions are padded with
    PAD_LLR (see above) — unless ``halo`` provides real neighbor rows
    (sequence-parallel decode, parallel/turbo_sp.py):
    halo = (lead_lsa, lead_lp, trail_lsa, trail_lp), each [O+3, B].
    """
    import jax.numpy as jnp

    t_len, b = lsa.shape
    assert k % window == 0, (k, window)
    assert 3 <= overlap <= window
    w = k // window
    l = window
    o = overlap
    dt = lsa.dtype

    if halo is None:
        pad_s = jnp.full((o + 3, b), PAD_LLR, dt)
        pad_p = jnp.zeros((o + 3, b), dt)
        lead_s = trail_s = pad_s
        lead_p = trail_p = pad_p
    else:
        lead_s, lead_p, trail_s, trail_p = halo
    lsa_pd = jnp.concatenate([lead_s, lsa, trail_s], axis=0)  # shift +O+3
    lp_pd = jnp.concatenate([lead_p, lp, trail_p], axis=0)

    base = np.arange(w)[:, None] * l                          # [W, 1]
    idx_a = base + np.arange(-o, l)[None, :] + (o + 3)        # [W, O+L]
    idx_b = base + np.arange(0, l + o)[None, :] + (o + 3)     # [W, L+O]

    def gather_tm(x, idx):
        # x [Tp, B] -> [steps, W*B] time-major for scan
        g = x[jnp.asarray(idx.reshape(-1)), :].reshape(w, idx.shape[1], b)
        return jnp.moveaxis(g, 1, 0).reshape(idx.shape[1], w * b)

    return (gather_tm(lsa_pd, idx_a), gather_tm(lp_pd, idx_a),
            gather_tm(lsa_pd, idx_b), gather_tm(lp_pd, idx_b))


def _window_inits(k: int, window: int, b: int, init_alpha, init_beta, dt):
    """Per-lane initial metrics [8, W*B]: exact at the trellis boundaries
    (window 0 alpha / last window beta), uniform elsewhere."""
    import jax.numpy as jnp

    w = k // window
    uniform = jnp.zeros((8,), dt)
    a0 = jnp.concatenate(
        [jnp.broadcast_to(jnp.asarray(init_alpha, dt)[:, None, None], (8, 1, b)),
         jnp.broadcast_to(uniform[:, None, None], (8, w - 1, b))], axis=1
    ).reshape(8, w * b)
    b0 = jnp.concatenate(
        [jnp.broadcast_to(uniform[:, None, None], (8, w - 1, b)),
         jnp.broadcast_to(jnp.asarray(init_beta, dt)[:, None, None], (8, 1, b))],
        axis=1,
    ).reshape(8, w * b)
    return a0, b0


def _windowed_map_decode(lsa, lp, k: int, overlap: int, window: int,
                         init_alpha, init_beta, halo=None,
                         boundary=(True, True)):
    """Windowed max-log-MAP: parallel windows with overlap training.

    lsa/lp are [T, B] with T = K + 3 (payload + termination). The payload
    region [0, K) is cut into W = K / window windows riding the lane axis;
    each window's alpha (beta) recursion is trained over ``overlap`` extra
    leading (trailing) steps starting from uniform metrics, mirroring the
    reference's turbodecoder_win.h scheme. Window 0's alpha and the last
    window's beta use the exact boundary metrics, carried through their
    padded training steps by the PAD_LLR construction above; the last
    window's beta training region contains the 3 real termination steps.

    Returns llr_out [K, B].
    """
    import jax
    import jax.numpy as jnp

    ns, par, ps, pp = _trellis_arrays()
    ns_j = jnp.asarray(ns)
    par_j = jnp.asarray(par)
    ps_j = jnp.asarray(ps)
    pp_j = jnp.asarray(pp)

    t_len, b = lsa.shape
    w = k // window
    l = window
    o = overlap
    dt = lsa.dtype

    lsa_a, lp_a, lsa_b, lp_b = _prepare_windows(lsa, lp, k, o, l, halo=halo)

    # --- beta sweep over [L + O] steps, windows in lanes --------------------
    # Interior shards of a sequence-parallel decode train their first/last
    # windows from real halo rows instead of exact boundary metrics.
    uniform = jnp.zeros_like(jnp.asarray(init_alpha, dt))
    a_first = jnp.asarray(init_alpha, dt) if boundary[0] else uniform
    b_last = jnp.asarray(init_beta, dt) if boundary[1] else uniform
    alpha_init, beta_init = _window_inits(k, l, b, a_first, b_last, dt)

    def beta_step(beta, inputs):
        lsa_k, lp_k = inputs
        cands = []
        for u in (0, 1):
            nxt = beta[ns_j[:, u], :]
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             par_j[:, u][:, None].astype(dt))
            cands.append(nxt + g)
        new = jnp.maximum(cands[0], cands[1])
        new = new - jnp.max(new, axis=0, keepdims=True)
        return new, beta

    _, betas = jax.lax.scan(beta_step, beta_init, (lsa_b, lp_b), reverse=True)
    betas = betas[:l]  # betas[j] = beta at local position j+1

    # --- alpha sweep over [O + L] steps + LLR emit --------------------------
    def alpha_step(alpha, inputs):
        lsa_k, lp_k, beta_k1 = inputs
        tot = []
        for u in (0, 1):
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             par_j[:, u][:, None].astype(dt))
            tot.append(alpha + g + beta_k1[ns_j[:, u], :])
        llr_k = jnp.max(tot[0], axis=0) - jnp.max(tot[1], axis=0)
        cands = []
        for u in (0, 1):
            prev = alpha[ps_j[:, u], :]
            g = _half_branch(lsa_k[None, :], lp_k[None, :], u,
                             pp_j[:, u][:, None].astype(dt))
            cands.append(prev + g)
        new = jnp.maximum(cands[0], cands[1])
        new = new - jnp.max(new, axis=0, keepdims=True)
        return new, llr_k

    # alpha consumes O training steps then L emit steps; beta_k1 for the
    # training region is unused — feed zeros there to keep shapes aligned.
    beta_feed = jnp.concatenate([jnp.zeros((o, 8, w * b), dt), betas], axis=0)
    _, llrs = jax.lax.scan(alpha_step, alpha_init, (lsa_a, lp_a, beta_feed))
    llrs = llrs[o:]  # [L, W*B]
    return llrs.reshape(l, w, b).transpose(1, 0, 2).reshape(k, b)


@dataclass(frozen=True)
class TurboDecoder:
    """Iterative turbo decoder for one CB size K.

    Parameters mirror srslte_tdec_t usage: fixed ``iterations`` (the
    reference's CRC early stop is exposed via ``decode``'s per-iteration
    CRC hook in models/sch.py), optional windowing for the parallel-lane
    fast path.
    """

    k: int
    iterations: int = 5
    window: int | None = None          # None = exact full-length sweeps
    overlap: int = DEFAULT_OVERLAP
    #: "auto" = the NII Pallas kernel on the GPU, the lax.scan sweeps on
    #: the CPU (backend.platform()); "xla" = scan sweeps; "pallas2" = the
    #: NII kernel (turbo_decoder_pallas2.py); "pallas2_interpret" = the
    #: same kernel in the Pallas interpreter (CPU tests).
    impl: str = "auto"
    #: Metric dtype: "auto" = bfloat16 on the NII kernel path, float32 on
    #: the scan path; "float32"/"bfloat16" to force.
    dtype: str = "auto"

    def _split_streams(self, d_llr):
        """d_llr[..., 3, K+4] -> per-constituent (sys1, par1, sys2t, par2).

        Tail de-permutation per 36.212 5.1.3.2.2 (see turbo_encoder).
        Returns time-major-able [..., K+3] arrays.
        """
        import jax.numpy as jnp

        k = self.k
        d0, d1, d2 = d_llr[..., 0, :], d_llr[..., 1, :], d_llr[..., 2, :]
        sys1 = jnp.concatenate(
            [d0[..., :k], d0[..., k : k + 1], d2[..., k : k + 1], d1[..., k + 1 : k + 2]],
            axis=-1,
        )
        par1 = jnp.concatenate(
            [d1[..., :k], d1[..., k : k + 1], d0[..., k + 1 : k + 2], d2[..., k + 1 : k + 2]],
            axis=-1,
        )
        sys2_tail = jnp.concatenate(
            [d0[..., k + 2 : k + 3], d2[..., k + 2 : k + 3], d1[..., k + 3 : k + 4]],
            axis=-1,
        )
        par2 = jnp.concatenate(
            [d2[..., :k], d1[..., k + 2 : k + 3], d0[..., k + 3 : k + 4], d2[..., k + 3 : k + 4]],
            axis=-1,
        )
        return sys1, par1, sys2_tail, par2

    def decode_tiles(self, sys_t, par1_t, par2_t, ut1, pt1, ut2, pt2, *,
                     iterations: int | None = None, crc_check=None,
                     interpret: bool = False):
        """NII iteration driver operating purely in the kernel's
        batch-tile layout (turbo_decoder_pallas2.py).

        sys_t/par1_t/par2_t: [T, K, sub, lanes]; tails: [T, 8, sub, lanes]
        (rows 0-2 real). ``crc_check(llr_int) -> bool scalar`` is the
        early-stop predicate evaluated on the INTERLEAVED-domain
        a-posteriori LLR tiles (llr_int row q <-> natural bit pi[q]), so
        no per-iteration deinterleave gather or layout change is needed
        (the reference checks CRCs between iterations at sch.c:382; here
        the check is one contraction, see ops/fec/derm_tiles.py).

        Returns (llr_int [T, K, sub, lanes], n_iterations scalar int32);
        the natural-order LLRs are ``llr_int[:, qpp_deinterleaver(k)]``.
        """
        import jax
        import jax.numpy as jnp

        from .turbo_decoder_pallas2 import map_decode_nii

        iters = self.iterations if iterations is None else iterations
        k = self.k
        l = self.window
        pi = jnp.asarray(qpp_interleaver(k))
        t_tiles, _, sub, lanes = sys_t.shape
        dt = sys_t.dtype
        zst = jnp.zeros((t_tiles, k // l + 1, 8, sub, lanes), dt)

        dec = lambda u, p, ut, pt, a, bb, apr: map_decode_nii(
            u, p, ut, pt, a, bb, l=l, interpret=interpret, apr=apr)

        pinv = jnp.asarray(qpp_deinterleaver(k))
        # interleaved-domain systematic, computed once: constituent 2's
        # input rows are sys_int + ext1_int, with the sys+ext adds
        # executed INSIDE the kernel (apr input), saving a full pass
        # over the LLR rows per half-iteration
        sys_int = sys_t[:, pi]

        def iteration(state, with_llr=True):
            ext2, a1, b1, a2, b2 = state
            ext1, a1, b1 = dec(sys_t, par1_t, ut1, pt1, a1, b1, ext2)
            ext1_int = ext1[:, pi]
            ext2i, a2, b2 = dec(sys_int, par2_t, ut2, pt2, a2, b2,
                                ext1_int)
            # a-posteriori LLRs stay in the interleaved domain; they are
            # only materialized when the caller needs this iteration's
            # output (last fixed iteration, or every iteration under CRC
            # early stop) — the two adds fuse into the consumer
            llr_int = (sys_int + ext1_int + ext2i) if with_llr else None
            return (ext2i[:, pinv], a1, b1, a2, b2), llr_int

        state = (jnp.zeros_like(sys_t), zst, zst, zst, zst)
        if crc_check is None:
            # fixed iterations ride a lax.scan so XLA compiles ONE
            # iteration body (plus the final llr-emitting call) instead
            # of unrolling `iters` copies
            if iters > 1:
                def body(st, _):
                    st, _ = iteration(st, with_llr=False)
                    return st, None
                state, _ = jax.lax.scan(body, state, None, length=iters - 1)
            _, llr_int = iteration(state)
            n_it = jnp.asarray(iters, jnp.int32)
        else:
            def cond(carry):
                it, state, llr_int, done = carry
                return jnp.logical_and(it < iters, jnp.logical_not(done))

            def body(carry):
                it, state, _, _ = carry
                state, llr_int = iteration(state)
                return it + 1, state, llr_int, crc_check(llr_int)

            state, llr_1 = iteration(state)
            n_it, _, llr_int, _ = jax.lax.while_loop(
                cond, body,
                (jnp.ones((), jnp.int32), state, llr_1, crc_check(llr_1)))
        return llr_int, n_it

    def _decode_nii(self, d_llr, iterations: int | None = None, crc=None,
                    interpret: bool = False):
        """NII kernel path in the batch-tile layout
        (turbo_decoder_pallas2.py). Same contract as ``decode``."""
        import jax.numpy as jnp

        from .turbo_decoder_pallas2 import from_tiles, tile_width, to_tiles

        k = self.k
        pinv = jnp.asarray(qpp_deinterleaver(k))
        dt = jnp.bfloat16 if self.dtype == "auto" else jnp.dtype(self.dtype)
        if d_llr.dtype != dt:
            d_llr = d_llr.astype(dt)

        sys1, par1, sys2_tail, par2 = self._split_streams(d_llr)
        lead = sys1.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        tm = lambda x: jnp.moveaxis(x.reshape(b, x.shape[-1]), -1, 0)
        sys1_tm = tm(sys1)
        par1_tm = tm(par1)
        par2_tm = tm(par2)
        sys2_tail_tm = tm(sys2_tail)

        # tile geometry from the batch: one row of up to TILE code blocks
        lanes = tile_width(b)
        bp = (-b) % lanes
        cp = (lambda x: jnp.pad(x, ((0, 0), (0, bp)))) if bp \
            else (lambda x: x)
        pad8 = lambda x: jnp.pad(x, ((0, 8 - x.shape[0]), (0, 0)))
        tiles = lambda x: to_tiles(cp(x), lanes)

        crc_check = None
        if crc is not None:
            from .derm_tiles import parity_rows_interleaved

            p_int = jnp.asarray(parity_rows_interleaved(
                crc.poly, crc.order, k), jnp.float32)

            def crc_check(llr_int):
                bits = (llr_int < 0).astype(jnp.float32)
                snd = jnp.einsum("tksl,kc->tcsl", bits, p_int,
                                 preferred_element_type=jnp.float32)
                return jnp.all(jnp.mod(snd, 2.0) == 0.0)

        llr_full, _n_it = self.decode_tiles(
            tiles(sys1_tm[:k]), tiles(par1_tm[:k]), tiles(par2_tm[:k]),
            tiles(pad8(sys1_tm[k:])), tiles(pad8(par1_tm[k:])),
            tiles(pad8(sys2_tail_tm)), tiles(pad8(par2_tm[k:])),
            iterations=iterations, crc_check=crc_check, interpret=interpret,
        )
        llr_full = llr_full[:, pinv]

        llr2d = from_tiles(llr_full)
        if bp:
            llr2d = llr2d[:, :b]
        llr_out = jnp.moveaxis(llr2d, 0, -1).reshape(*lead, k)
        bits = (llr_out < 0).astype(jnp.int8)
        return bits, llr_out

    def decode(self, d_llr, iterations: int | None = None, crc=None):
        """Decode d_llr[..., 3, K+4] -> (bits[..., K] int8, llr[..., K]).

        jit-compatible; leading dims are batch. Runs (dec1, dec2)
        half-iteration pairs with extrinsic exchange — a fixed count, or,
        when a ``crc`` (utils.crc.Crc covering the K bits, e.g. CRC24B
        for segmented CBs) is given, until the whole batch passes.
        """
        import jax.numpy as jnp

        iters = self.iterations if iterations is None else iterations
        k = self.k
        pi = jnp.asarray(qpp_interleaver(k))
        pinv = jnp.asarray(qpp_deinterleaver(k))

        impl = self.impl
        if impl == "auto":
            from ...backend import platform

            impl = "pallas2" if platform() == "gpu" else "xla"
        if impl not in ("xla", "pallas2", "pallas2_interpret"):
            raise ValueError(f"unknown turbo decoder impl {impl!r}")
        if impl != "xla" and self.window is not None:
            return self._decode_nii(d_llr, iterations=iterations, crc=crc,
                                    interpret=impl.endswith("interpret"))
        dt = jnp.float32 if self.dtype == "auto" else jnp.dtype(self.dtype)
        if d_llr.dtype != dt:
            d_llr = d_llr.astype(dt)

        sys1, par1, sys2_tail, par2 = self._split_streams(d_llr)
        lead = sys1.shape[:-1]
        b = int(np.prod(lead)) if lead else 1

        # time-major [T, B]
        tm = lambda x: jnp.moveaxis(x.reshape(b, x.shape[-1]), -1, 0)
        sys1_tm = tm(sys1)
        par1_tm = tm(par1)
        par2_tm = tm(par2)
        sys2_tail_tm = tm(sys2_tail)
        sys1_pay = sys1_tm[:k]  # payload systematic, [K, B]

        init_a = np.full(8, NEG_INF, np.float32)
        init_a[0] = 0.0
        init_b = np.full(8, NEG_INF, np.float32)
        init_b[0] = 0.0
        init_a = jnp.asarray(init_a, sys1_tm.dtype)
        init_b = jnp.asarray(init_b, sys1_tm.dtype)

        def run_map(lsa_pay, tail_sys, par_tm):
            lsa = jnp.concatenate([lsa_pay, tail_sys], axis=0)
            if self.window is None:
                return _map_decode(lsa, par_tm, 3, init_a, init_b)
            return _windowed_map_decode(
                lsa, par_tm, k, self.overlap, self.window, init_a, init_b)

        def iteration(ext2):
            # decoder 1: a priori = ext2 (natural order)
            lsa1 = sys1_pay + ext2
            llr1 = run_map(lsa1, sys1_tm[k:], par1_tm)[:k]
            ext1 = llr1 - lsa1
            # decoder 2: systematic+a-priori = interleave(sys + ext1)
            lsa2 = (sys1_pay + ext1)[pi, :]
            llr2 = run_map(lsa2, sys2_tail_tm, par2_tm)[:k]
            return (llr2 - lsa2)[pinv, :], llr2[pinv, :]

        ext2 = jnp.zeros((k, b), sys1_tm.dtype)  # deinterleaved domain
        if crc is None:
            # scan over iterations: one compiled body, not `iters` unrolled
            # copies (the llr is a byproduct of the extrinsic update here,
            # so carrying it costs nothing)
            import jax

            def body(carry, _):
                e2, _ = carry
                e2, llr = iteration(e2)
                return (e2, llr), None

            llr0 = jnp.zeros((k, b), sys1_tm.dtype)
            (ext2, llr_full), _ = jax.lax.scan(
                body, (ext2, llr0), None, length=iters)
        else:
            # CRC early stop (the reference's per-CB stop, sch.c:382,
            # batched: iterate until every CB in the batch passes or the
            # iteration cap is reached)
            import jax

            def check(llr_full):
                bits = (jnp.moveaxis(llr_full, 0, -1) < 0).astype(jnp.int8)
                return jnp.all(crc.jnp_check(bits))

            def cond(state):
                it, ext2, llr_full, done = state
                return jnp.logical_and(it < iters, jnp.logical_not(done))

            def body(state):
                it, ext2, _, _ = state
                ext2, llr_full = iteration(ext2)
                return it + 1, ext2, llr_full, check(llr_full)

            ext2_1, llr_1 = iteration(ext2)
            _, _, llr_full, _ = jax.lax.while_loop(
                cond, body, (jnp.ones((), jnp.int32), ext2_1, llr_1,
                             check(llr_1)))

        llr_out = jnp.moveaxis(llr_full, 0, -1).reshape(*lead, k)
        bits = (llr_out < 0).astype(jnp.int8)
        return bits, llr_out
