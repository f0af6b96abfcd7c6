"""DL-SCH / UL-SCH transport-channel processing (36.212 5.3.2).

Capability parity with lib/src/phy/phch/sch.c: TB encode (CRC24A attach ->
segmentation -> per-CB CRC24B -> turbo encode -> rate matching ->
concatenation, sch.c:188-298) and decode_tb_cb (per-CB de-rate-matching
with HARQ soft combining -> iterative turbo decode with CRC check ->
reassembly -> TB CRC, sch.c:307-422).

Batched design: a frozen ``DlschPlan`` captures every static dimension
(segmentation, per-CB K/E/F, RV) so the whole TB decode is one compiled
program; code blocks are decoded as a flattened [batch*C] turbo batch per
K-group (the reference decodes CBs serially with per-CB early stop; here
the early stop is the batched CRC-select in the decoder driver).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.fec.cbsegm import CbSegm, cbsegm
from ..ops.fec.rate_matching import RateMatchTurbo
from ..ops.fec.turbo_decoder import TurboDecoder
from ..ops.fec.turbo_encoder import turbo_encode
from ..utils.crc import CRC24A, CRC24B


def _cb_e_sizes(g: int, c: int, qm: int, n_layers: int) -> tuple[int, ...]:
    """Per-CB rate-matching output size E (36.212 5.1.4.1.2)."""
    g_prime = g // (qm * n_layers)
    gamma = g_prime % c
    e_minus = qm * n_layers * (g_prime // c)
    e_plus = qm * n_layers * (-(-g_prime // c))
    return tuple(e_minus if i < c - gamma else e_plus for i in range(c))


def _pick_window(k: int) -> int | None:
    """Window length for the parallel turbo decoder: the divisor of K
    closest to 256 that is a multiple of 16 (a whole number of the NII
    kernel's checkpoint groups) and >= 48 (the scan path trains over a
    40-step overlap). None = full sweeps."""
    best = None
    for w in range(48, min(k, 769), 16):
        if k % w == 0 and (best is None or
                           abs(w - 256) < abs(best - 256)):
            best = w
    return best


@dataclass(frozen=True)
class DlschPlan:
    """Static per-grant transport channel plan (keys compiled pipelines)."""

    tbs: int                 # transport block payload bits
    g: int                   # total codeword bits after rate matching
    qm: int                  # modulation order (bits/symbol)
    rv: int = 0              # redundancy version
    n_layers: int = 1        # layers carrying this codeword
    max_iterations: int = 5
    decoder_impl: str = "auto"
    #: iterate only until every CB passes its CRC (sch.c:382 early stop,
    #: batched) — the reference's default behavior; False = fixed
    #: max_iterations (benchmarking at a fixed operating point)
    early_stop: bool = True

    @functools.cached_property
    def segm(self) -> CbSegm:
        return cbsegm(self.tbs)

    @functools.cached_property
    def e_sizes(self) -> tuple[int, ...]:
        return _cb_e_sizes(self.g, self.segm.c, self.qm, self.n_layers)

    @functools.cached_property
    def cb_plans(self):
        """Per-CB (k, e, f, offset_in_codeword)."""
        out = []
        off = 0
        for i, (k, e) in enumerate(zip(self.segm.cb_sizes, self.e_sizes)):
            f = self.segm.f if i == 0 else 0
            out.append((k, e, f, off))
            off += e
        assert off == self.g, (off, self.g)
        return tuple(out)

    def rm(self, k: int, f: int) -> RateMatchTurbo:
        return RateMatchTurbo(k, f=f)

    def decoder(self, k: int) -> TurboDecoder:
        return TurboDecoder(k=k, iterations=self.max_iterations,
                            window=_pick_window(k), impl=self.decoder_impl)


def dlsch_encode(tb_bits, plan: DlschPlan):
    """Encode tb_bits[..., tbs] -> codeword bits [..., G] (int8).

    Mirrors encode_tb_off (sch.c:188-298). jit-compatible; all sizes are
    static from the plan. The TB CRC is computed on device via the parity
    matrix (utils/crc.py).
    """
    segm = plan.segm
    lead = tb_bits.shape[:-1]

    # TB CRC24A
    tb_crc = CRC24A.jnp_compute(tb_bits).astype(jnp.int8)
    full = jnp.concatenate([tb_bits.astype(jnp.int8), tb_crc], axis=-1)

    # segmentation: K- blocks first, filler zeros lead the first block
    pieces = []
    pos = 0
    for i, k in enumerate(segm.cb_sizes):
        f = segm.f if i == 0 else 0
        payload = k - f - (24 if segm.c > 1 else 0)
        cb = full[..., pos : pos + payload]
        pos += payload
        if segm.c > 1:
            cb_crc = CRC24B.jnp_compute(
                jnp.concatenate(
                    [jnp.zeros((*lead, f), jnp.int8), cb], axis=-1)
                if f else cb).astype(jnp.int8)
            cb = jnp.concatenate([cb, cb_crc], axis=-1)
        if f:
            cb = jnp.concatenate([jnp.zeros((*lead, f), jnp.int8), cb], axis=-1)
        pieces.append(cb)
    assert pos == plan.tbs + 24

    # turbo encode + rate match per CB
    out = []
    for (k, e, f, _), cb in zip(plan.cb_plans, pieces):
        d = turbo_encode(cb)                     # [..., 3, K+4]
        out.append(plan.rm(k, f).tx(d, plan.rv, e))
    return jnp.concatenate(out, axis=-1)


def _fused_geometry(shape, plan: DlschPlan):
    """Fused-path eligibility from the LLR-array shape [..., lanes, R]:
    returns (lanes, sub, interpret) or None.

    The fused path (``_dlsch_decode_fused``) needs the NII Pallas kernel
    (on the GPU, or interpret mode for tests) and a window for every CB
    size. The kernel tile (``sub`` code-block slots by ``lanes`` batch
    elements, at most TILE code blocks) follows the shape: ``lanes`` is
    the largest power of two dividing the trailing batch axis, ``sub``
    covers the slots of one K group without padding past a power of two.
    """
    import os

    from ..ops.fec.turbo_decoder_pallas2 import TILE, tile_width

    if os.environ.get("SRSLTE_FUSED_RX", "1") == "0":
        return None
    if len(shape) < 2:
        return None
    impl = plan.decoder_impl
    if impl == "auto":
        from ..backend import platform

        if platform() != "gpu":
            return None
        interpret = False
    elif impl in ("pallas2", "pallas2_interpret"):
        interpret = impl.endswith("interpret")
    else:
        return None
    for k in set(plan.segm.cb_sizes):
        if _pick_window(k) is None:
            return None
    lanes_dim = shape[-2]
    lanes = min(lanes_dim & -lanes_dim, TILE)
    rest = int(np.prod(shape[:-2], dtype=np.int64)) * (lanes_dim // lanes)
    sub = min(TILE // lanes, tile_width(rest * plan.segm.c))
    return lanes, sub, interpret


def _derm_softbuffers(llrs, plan: DlschPlan):
    """First-transmission softbuffers via the classic de-rate-matching
    path (rate_matching.rx) — the fused decode path does not materialize
    the d-domain LLR buffer, so HARQ state is produced here instead; XLA
    dead-code-eliminates this whole graph when the caller discards it."""
    new_soft = [None] * plan.segm.c
    groups: dict = {}
    for idx, (k, e, f, off) in enumerate(plan.cb_plans):
        groups.setdefault((k, e, f), []).append((idx, off))
    for (k, e, f), members in groups.items():
        seg = jnp.stack([llrs[..., off : off + e] for _, off in members],
                        axis=-2)
        _d, ns = plan.rm(k, f).rx(seg, plan.rv)
        for j, (idx, _off) in enumerate(members):
            new_soft[idx] = ns[..., j, :]
    return new_soft


#: decoder input tile names, kernel argument order (decode_tiles)
_TILE_NAMES = ("sys", "par1", "par2", "ut1", "pt1", "ut2", "pt2")


def _tile_group_postprocess(llr_int, k: int, c: int, mem, rest: int,
                            lanes: int, n_tb_bits: int, starts, plens,
                            pieces: dict):
    """Per-CB CRC, zero-TB guard, TB-CRC24A syndrome contribution and
    natural-order payload extraction for ONE slot block of decoded
    tiles — the post-decode machinery shared by the v1 and v2 fused
    feeds (everything stays in the kernel's tile layout; CRCs are MXU
    contractions, see ops/fec/derm_tiles.py).

    llr_int [Tg, K, sub, lanes]: the block's interleaved-domain
    a-posteriori LLRs (v1 passes its whole same-K group, v2 one (K, F)
    subgroup's tile range). ``mem``: [(i_cb, e, f, off)] in TB order;
    slot q = r * len(mem) + j holds batch-fold r of mem[j]. Filler
    bits are handled per slot: with one nonzero F value in the block
    (mixed {0, F} slots, the v1 case — 36.212 only ever puts filler in
    the first CB, so two distinct nonzero Fs cannot occur and are
    asserted against) a mask adds the [f, k-24)-payload parity
    correction on the F slots; a uniform-F block (the v2 case) takes
    the [f, k-24) parity rows directly, one contraction.

    Returns (ok [rest, lanes], ones_count [rest, lanes],
    tb_syndrome [rest, 24, lanes] | None) and stores each CB's
    natural-order payload bits into ``pieces``.
    """
    import jax.numpy as jnp

    from ..ops.fec.derm_tiles import parity_rows_interleaved, shift_matrix
    from ..ops.fec.tables import qpp_deinterleaver, qpp_interleaver

    t_tiles, _k, sub, _lanes = llr_int.shape
    mg = len(mem)
    crc_poly = (CRC24B if c > 1 else CRC24A).poly
    p_int = jnp.asarray(parity_rows_interleaved(crc_poly, 24, k))
    bits_int = (llr_int < 0)
    bits_f = bits_int.astype(jnp.float32)

    # per-CB CRC
    s_cb = jnp.mod(jnp.einsum("tksl,kc->tcsl", bits_f, p_int,
                              preferred_element_type=jnp.float32), 2.0)
    okslot = jnp.all(s_cb == 0.0, axis=1)       # [T, sub, lanes]
    okm = okslot.reshape(-1, lanes)[: rest * mg]
    ok_part = jnp.all(okm.reshape(rest, mg, lanes), axis=1)

    # zero-TB guard: count of one-bits over the payload region
    paymask = np.zeros(k, np.float32)
    paymask[: (k - 24 if c > 1 else k)] = 1.0
    pm_int = jnp.asarray(paymask[qpp_interleaver(k)])
    cnts = jnp.einsum("tksl,k->tsl", bits_f, pm_int,
                      preferred_element_type=jnp.float32)
    cm = cnts.reshape(-1, lanes)[: rest * mg]
    cnt_part = jnp.sum(cm.reshape(rest, mg, lanes), axis=1)

    snd_part = None
    if c > 1:
        # TB CRC24A from per-CB local syndromes (payload [f, k-24) per
        # slot) + x^suffix shift matrices
        f_set = {f for _i, _e, f, _o in mem}
        assert len(f_set - {0}) <= 1, "mixed nonzero F within one block"
        if len(f_set) == 1:
            # uniform F (v2 subgroups, and v1 groups without filler):
            # the payload parity rows apply to every slot directly
            pf = parity_rows_interleaved(CRC24A.poly, 24, k,
                                         (f_set.pop(), k - 24))
            s_loc_raw = jnp.einsum("tksl,kc->tcsl", bits_f,
                                   jnp.asarray(pf),
                                   preferred_element_type=jnp.float32)
        else:
            # mixed {0, F}: base parity over [0, k-24) plus a masked
            # additive correction on the filler-bearing slots (exact:
            # the matrices are 0/1-valued)
            p0 = parity_rows_interleaved(CRC24A.poly, 24, k, (0, k - 24))
            s_loc_raw = jnp.einsum("tksl,kc->tcsl", bits_f,
                                   jnp.asarray(p0),
                                   preferred_element_type=jnp.float32)
            ff = max(f_set)
            pf = parity_rows_interleaved(CRC24A.poly, 24, k, (ff, k - 24))
            pd = jnp.asarray(pf - p0)
            mask = np.zeros((t_tiles, 1, sub, 1), np.float32)
            for q, (_i, _e, f, _o) in enumerate(
                    (m for _r in range(rest) for m in mem)):
                if f > 0:
                    mask[q // sub, 0, q % sub, 0] = 1.0
            s_loc_raw = s_loc_raw + jnp.asarray(mask) * jnp.einsum(
                "tksl,kc->tcsl", bits_f, pd,
                preferred_element_type=jnp.float32)
        s_loc = jnp.mod(s_loc_raw, 2.0)
        w_np = np.zeros((t_tiles, sub, 24, 24), np.float32)
        for q in range(rest * mg):
            i_cb = mem[q % mg][0]
            suffix = n_tb_bits - (starts[i_cb] + plens[i_cb])
            w_np[q // sub, q % sub] = shift_matrix(CRC24A.poly, 24, suffix)
        shifted = jnp.einsum("tcsl,tsdc->tdsl", s_loc, jnp.asarray(w_np),
                             preferred_element_type=jnp.float32)
        sm = jnp.moveaxis(shifted, 1, 2).reshape(-1, 24, lanes)
        sm = sm[: rest * mg].reshape(rest, mg, 24, lanes)
        snd_part = jnp.sum(sm, axis=1)

    # natural-order payload bits per CB (dead-code-eliminated when the
    # caller only consumes crc_ok)
    pinv = jnp.asarray(qpp_deinterleaver(k))
    bits_nat = bits_int.astype(jnp.int8)[:, pinv]
    arr = jnp.moveaxis(bits_nat, 1, 0).reshape(k, -1, lanes)
    arr = arr[:, : rest * mg].reshape(k, rest, mg, lanes)
    for j, (i_cb, _e, f, _off) in enumerate(mem):
        pieces[i_cb] = arr[f : f + plens[i_cb], :, j]
    return ok_part, cnt_part, snd_part


def _feed_group_tiles_v2(x, k: int, f: int, mem, rest: int, sub: int,
                         lanes: int, dt, strong, rv: int, int8_lane: bool):
    """One (K, F) group of the v2 feed: stack member slices of the
    codeword-ordered LLR array x [rest, lanes, G] into a
    [T, e_max+2, sub, lanes] source, then gather the decoder input tiles
    with the group's SHARED index tables (build_tile_plan_shared).
    Returns (tg, {name: tiles})."""
    import jax
    import jax.numpy as jnp

    from ..ops.fec.derm_tiles import build_tile_plan_shared

    slots = [(r, i, e, off) for r in range(rest) for (i, e, off) in mem]
    n_slots = len(slots)
    tg = -(-n_slots // sub)
    e_max = max(e for _r, _i, e, _o in slots)
    tplan = build_tile_plan_shared(k, f, rv, e_max)

    segs = []
    for (r, _i, e, off) in slots:
        seg = jax.lax.slice_in_dim(x[r], off, off + e, axis=-1)
        if e < e_max:
            seg = jnp.pad(seg, ((0, 0), (0, e_max - e)))
        segs.append(seg)
    segs += [jnp.zeros((lanes, e_max), dt)] * (tg * sub - n_slots)
    st = jnp.stack(segs, 0).reshape(tg, sub, lanes, e_max)
    st = jnp.transpose(st, (0, 3, 1, 2))       # [T, e_max, sub, lanes]
    src_g = jnp.concatenate(
        [st, jnp.zeros((tg, 1, sub, lanes), dt),
         jnp.broadcast_to(strong.astype(dt), (tg, 1, sub, lanes))],
        axis=1)                                # [T, e_max+2, sub, lanes]

    out = {}
    for name in _TILE_NAMES:
        idx = tplan[name]
        o = jnp.take(src_g, jnp.asarray(idx[0]), axis=1)
        for rix in range(1, idx.shape[0]):
            o = o + jnp.take(src_g, jnp.asarray(idx[rix]), axis=1)
        if int8_lane and idx.shape[0] > 1:
            # saturating repetition combining (rm_turbo.c:378 8-bit)
            o = jnp.clip(o, -127, 127)
        out[name] = o
    return tg, out


def _dlsch_decode_fused(llrs, plan: DlschPlan, lanes: int, sub: int,
                        interpret: bool, g_map=None, iters_out=None,
                        pos_major: bool = False):
    """TB decode with the fused receiver feed.

    Default (SRSLTE_FEED=v1, the deployed path): per-slot row gathers
    from a flat [rest*r_len, lanes] source (v1 below). SRSLTE_FEED=v2
    selects a shared-index restructuring kept as a cross-check:

      1. RE extraction (grid path) as ONE minor-axis gather applying the
         full g_map, giving a codeword-ordered array per codeword.
      2. Per (K, F) group, the members' codeword slices stack into a
         [T, e_max + 2, sub, lanes] source (members ride the sub axis;
         the last two rows are the reserved zero / strong-prior rows).
      3. The de-rate-match -> sub-block deinterleave -> stream split ->
         tail depermutation composition as a SHARED index per decoder
         row (build_tile_plan_shared): equal-K/F/rv members map codeword
         position to d position identically, and shorter members read
         their zero padding where longer members read data; whole
         [sub, lanes]-row gathers feed the kernel tiles.

    Neither has been timed on the GPU (PERF.md open questions). Both
    paths are behaviorally identical to the classic de-rate-matching
    path (tests/test_fused_rx.py); reference semantics mirrored:
    decode_tb_cb + srslte_crc checks (lib/src/phy/phch/sch.c:307-437).
    """
    import os

    if pos_major or os.environ.get("SRSLTE_FEED", "v1") == "v1":
        # (the v2 cross-check path only implements batch-major input)
        return _dlsch_decode_fused_v1(llrs, plan, lanes, sub, interpret,
                                      g_map=g_map, iters_out=iters_out,
                                      pos_major=pos_major)

    import jax
    import jax.numpy as jnp

    from ..ops.fec.derm_tiles import parity_rows_interleaved

    segm = plan.segm
    c = segm.c
    lead = llrs.shape[:-1]
    r_len = llrs.shape[-1]
    folds = lead[-1] // lanes
    rest = int(np.prod(lead[:-1], dtype=np.int64)) * folds
    n_tb_bits = plan.tbs + 24
    dt = jnp.bfloat16
    int8_lane = llrs.dtype == jnp.int8

    x = llrs.reshape(rest, lanes, r_len).astype(dt)
    # Materialize the LLR array BEFORE any gather touches it: gathers
    # fuse their operand chain, and the upstream pipeline (equalize/
    # demod, or the in-loop encoder of loopback benches) recomputed
    # inside a gather's per-index read path is far slower than one
    # dense pass + a gather of materialized data.
    x = jax.lax.optimization_barrier(x)
    if g_map is not None:
        # grid path: RE extraction as one minor-axis gather composing
        # the whole grid->codeword map (models/pdsch.py _grid_maps)
        x = jnp.take(x, jnp.asarray(g_map), axis=-1)
        # pin again: the member slices below each consume this gather
        x = jax.lax.optimization_barrier(x)

    # Filler-bit prior, scaled to the data (see v1 note: a hard 1e4 pin
    # destroys bf16 precision in the kernel's renormalization groups)
    f_max = max((fv for _k, _e, fv, _o in plan.cb_plans), default=0)
    c_f = min(8.0, 128.0 / f_max) if f_max else 8.0
    if int8_lane:
        strong = jnp.float32(127.0)
    elif f_max == 0:
        strong = jnp.float32(0.0)   # no filler rows reference this
    else:
        strong = c_f * jnp.mean(jnp.abs(x).astype(jnp.float32))

    # cb bookkeeping in TB order: payload spans per CB
    plens, starts = [], []
    pos = 0
    for i, (k, e, f, off) in enumerate(plan.cb_plans):
        plen = k - f - (24 if c > 1 else 0)
        starts.append(pos)
        plens.append(plen)
        pos += plen
    assert pos == n_tb_bits, (pos, n_tb_bits)

    # K -> {F -> [(i_cb, e, off)]}: one kernel call per K, one feed
    # sub-group per (K, F) (the shared index needs uniform F)
    kgroups: dict = {}
    for i, (k, e, f, off) in enumerate(plan.cb_plans):
        kgroups.setdefault(k, {}).setdefault(f, []).append((i, e, off))

    stop = plan.early_stop
    ok_parts, cnt_parts, tb_snd_parts = [], [], []
    pieces: dict = {}
    for k, by_f in kgroups.items():
        sub_groups = []                       # (f, mem, t0, tg)
        tiles_parts = {n: [] for n in _TILE_NAMES}
        t_off = 0
        for f, mem in by_f.items():
            tg, gtiles = _feed_group_tiles_v2(
                x, k, f, mem, rest, sub, lanes, dt, strong, plan.rv,
                int8_lane)
            for name in _TILE_NAMES:
                tiles_parts[name].append(gtiles[name])
            sub_groups.append((f, mem, t_off, tg))
            t_off += tg
        tiles = [tiles_parts[n][0] if len(tiles_parts[n]) == 1
                 else jnp.concatenate(tiles_parts[n], axis=0)
                 for n in _TILE_NAMES]

        crc_poly = (CRC24B if c > 1 else CRC24A).poly
        p_int = jnp.asarray(parity_rows_interleaved(crc_poly, 24, k))

        def synd(llr_int, p):
            bits = (llr_int < 0).astype(jnp.float32)
            return jnp.mod(
                jnp.einsum("tksl,kc->tcsl", bits, p,
                           preferred_element_type=jnp.float32), 2.0)

        crc_check = ((lambda li, p=p_int: jnp.all(synd(li, p) == 0.0))
                     if stop else None)
        dec = plan.decoder(k)
        llr_int, n_it = dec.decode_tiles(*tiles, crc_check=crc_check,
                                         interpret=interpret)
        if iters_out is not None:
            # traced per-group iteration counts (sch.c:382 early-stop
            # depth), surfaced for the bench's operating-point report
            iters_out.append(n_it)

        for f, mem, t0, tg in sub_groups:
            mem4 = [(i, e, f, off) for (i, e, off) in mem]
            ok_p, cnt_p, snd_p = _tile_group_postprocess(
                llr_int[t0 : t0 + tg], k, c, mem4, rest, lanes,
                n_tb_bits, starts, plens, pieces)
            ok_parts.append(ok_p)
            cnt_parts.append(cnt_p)
            if snd_p is not None:
                tb_snd_parts.append(snd_p)

    tb_ok = ok_parts[0]
    for okp in ok_parts[1:]:
        tb_ok = jnp.logical_and(tb_ok, okp)
    cnt = cnt_parts[0]
    for cp in cnt_parts[1:]:
        cnt = cnt + cp
    tb_ok = jnp.logical_and(tb_ok, cnt > 0)
    if c > 1:
        snd = tb_snd_parts[0]
        for sp in tb_snd_parts[1:]:
            snd = snd + sp
        tb_ok = jnp.logical_and(
            tb_ok, jnp.all(jnp.mod(snd, 2.0) == 0.0, axis=-2))

    full_bits = jnp.concatenate([pieces[i] for i in range(c)], axis=0)
    tb_bits = jnp.moveaxis(full_bits, 0, -1).reshape(*lead, n_tb_bits)
    llrs_g = (llrs if g_map is None
              else jnp.take(llrs, jnp.asarray(g_map), axis=-1))
    return (tb_bits[..., : plan.tbs], tb_ok.reshape(*lead),
            _derm_softbuffers(llrs_g, plan))


def _dlsch_decode_fused_v1(llrs, plan: DlschPlan, lanes: int, sub: int,
                           interpret: bool, g_map=None, iters_out=None,
                           pos_major: bool = False):
    """v1 fused feed — the DEFAULT deployed path: per-slot
    single-[lanes]-row gathers from a flat [rest*r_len, lanes] source.
    See _dlsch_decode_fused's docstring.

    ``pos_major``: llrs arrive as [*outer, r_len, lanes] (positions on
    the second-to-last axis, batch minor) — the layout the feed's
    source rows want, produced natively by the grid path's transposed
    demodulator (models/pdsch.py). Skips a fused swapaxes with
    transposed writes.
    """
    import jax.numpy as jnp

    from ..ops.fec.derm_tiles import build_tile_plan, parity_rows_interleaved

    segm = plan.segm
    c = segm.c
    if pos_major:
        *outer, r_len, lanes_dim = llrs.shape
        folds = lanes_dim // lanes
        lead = (*outer, lanes_dim)
        rest0 = int(np.prod(outer, dtype=np.int64)) if outer else 1
        rest = rest0 * folds
    else:
        lead = llrs.shape[:-1]
        # source rows per TB: the extracted codeword (r_len == plan.g)
        # or a wider layout reached through g_map (e.g. the un-extracted
        # resource grid, models/pdsch.py grid path)
        r_len = llrs.shape[-1]
        folds = lead[-1] // lanes
        rest = int(np.prod(lead[:-1], dtype=np.int64)) * folds
    g_map_key = (None if g_map is None
                 else np.ascontiguousarray(g_map, np.int64).tobytes())
    n_tb_bits = plan.tbs + 24
    dt = jnp.bfloat16
    int8_lane = llrs.dtype == jnp.int8

    # Materialize the LLR array exactly once: the seven decoder-feed
    # gathers below fuse their operand chain, and XLA *duplicates* fused
    # producers into every consumer — without this barrier the whole
    # upstream pipeline (equalize/demod, or the encoder in loopback
    # benches) is recomputed per gather. The transpose/pad still fuse
    # into the gathers; only `x` is pinned.
    import jax

    if pos_major:
        x = llrs.reshape(rest0, r_len, folds, lanes).astype(dt)
        if folds > 1:
            # fold the lane split out to its own leading axis (one
            # relayout copy; folds == 1 — the common case — is free)
            x = jnp.moveaxis(x, -2, -3)
        x = jax.lax.optimization_barrier(x)
        src = x.reshape(rest * r_len, lanes)
    else:
        x = llrs.reshape(rest, lanes, r_len).astype(dt)
        x = jax.lax.optimization_barrier(x)
        src = jnp.swapaxes(x, -1, -2).reshape(rest * r_len, lanes)
    zero_row, strong_row = rest * r_len, rest * r_len + 1
    # Filler-bit prior, scaled to the data: the classic path pins 1e4
    # (rate_matching.rx), which is exact in f32 but destroys bf16
    # precision inside the kernel's 16-step renormalization groups — the
    # alpha metrics carry a ~prior*f/2 common offset whose bf16 ulp
    # swamps the real LLRs (bits right after the filler region decode
    # wrong). A prior of a few mean-|LLR|, capped so offset/256 stays
    # well under the LLR scale even for the max filler count, conveys
    # the same known-zero information without the precision cliff.
    f_max = max((f for _k, _e, f, _o in plan.cb_plans), default=0)
    c_f = min(8.0, 128.0 / f_max) if f_max else 8.0
    if int8_lane:
        strong = jnp.float32(127.0)
    elif f_max == 0:
        strong = jnp.float32(0.0)   # no filler rows reference this
    elif g_map is None:
        strong = c_f * jnp.mean(jnp.abs(llrs).astype(jnp.float32))
    else:
        # grid-domain source: average only the mapped (PDSCH) rows
        strong = c_f * jnp.mean(jnp.abs(
            jnp.take(llrs, jnp.asarray(g_map),
                     axis=-2 if pos_major else -1)
        ).astype(jnp.float32))
    src = jnp.concatenate(
        [src, jnp.zeros((1, lanes), dt),
         jnp.broadcast_to(strong.astype(dt), (1, lanes))], axis=0)

    # cb bookkeeping in TB order: payload spans and CRC-shift suffixes
    plens, starts = [], []
    pos = 0
    for i, (k, e, f, off) in enumerate(plan.cb_plans):
        plen = k - f - (24 if c > 1 else 0)
        starts.append(pos)
        plens.append(plen)
        pos += plen
    assert pos == n_tb_bits, (pos, n_tb_bits)

    groups: dict = {}
    for i, (k, e, f, off) in enumerate(plan.cb_plans):
        groups.setdefault(k, []).append((i, e, f, off))

    stop = plan.early_stop
    ok_parts, cnt_parts, tb_snd_parts = [], [], []
    pieces: dict = {}
    for k, mem in groups.items():
        members = tuple((e, f, off, r * r_len)
                        for r in range(rest) for (_i, e, f, off) in mem)
        tplan = build_tile_plan(k, members, plan.rv, sub,
                                zero_row, strong_row, g_map_key=g_map_key)

        def take(name):
            idx = jnp.asarray(tplan[name])
            outr = jnp.take(src, idx, axis=0)  # [reps, T, rows, sub, lanes]
            out = outr[0] if idx.shape[0] == 1 else jnp.sum(outr, axis=0)
            if int8_lane and idx.shape[0] > 1:
                # saturating repetition combining (rm_turbo.c:378 8-bit)
                out = jnp.clip(out, -127, 127)
            return out

        tiles = [take(n) for n in
                 ("sys", "par1", "par2", "ut1", "pt1", "ut2", "pt2")]

        crc_poly = (CRC24B if c > 1 else CRC24A).poly
        p_int = jnp.asarray(parity_rows_interleaved(crc_poly, 24, k))

        def synd(llr_int, p):
            bits = (llr_int < 0).astype(jnp.float32)
            return jnp.mod(
                jnp.einsum("tksl,kc->tcsl", bits, p,
                           preferred_element_type=jnp.float32), 2.0)

        crc_check = ((lambda li, p=p_int: jnp.all(synd(li, p) == 0.0))
                     if stop else None)
        dec = plan.decoder(k)
        llr_int, n_it = dec.decode_tiles(*tiles, crc_check=crc_check,
                                         interpret=interpret)
        if iters_out is not None:
            # traced per-group iteration counts (sch.c:382 early-stop
            # depth), surfaced for the bench's operating-point report
            iters_out.append(n_it)

        ok_p, cnt_p, snd_p = _tile_group_postprocess(
            llr_int, k, c, mem, rest, lanes, n_tb_bits, starts, plens,
            pieces)
        ok_parts.append(ok_p)
        cnt_parts.append(cnt_p)
        if snd_p is not None:
            tb_snd_parts.append(snd_p)

    tb_ok = ok_parts[0]
    for okp in ok_parts[1:]:
        tb_ok = jnp.logical_and(tb_ok, okp)
    cnt = cnt_parts[0]
    for cp in cnt_parts[1:]:
        cnt = cnt + cp
    tb_ok = jnp.logical_and(tb_ok, cnt > 0)
    if c > 1:
        snd = tb_snd_parts[0]
        for sp in tb_snd_parts[1:]:
            snd = snd + sp
        tb_ok = jnp.logical_and(
            tb_ok, jnp.all(jnp.mod(snd, 2.0) == 0.0, axis=-2))

    full_bits = jnp.concatenate([pieces[i] for i in range(c)], axis=0)
    tb_bits = jnp.moveaxis(full_bits, 0, -1).reshape(*lead, n_tb_bits)
    if pos_major:
        # _derm_softbuffers wants batch-major [..., G] (dead-code-
        # eliminated whenever the caller discards the HARQ state)
        llrs_g = jnp.swapaxes(
            jnp.take(llrs, jnp.asarray(g_map), axis=-2)
            if g_map is not None else llrs, -1, -2)
    else:
        llrs_g = (llrs if g_map is None
                  else jnp.take(llrs, jnp.asarray(g_map), axis=-1))
    return (tb_bits[..., : plan.tbs], tb_ok.reshape(*lead),
            _derm_softbuffers(llrs_g, plan))


def dlsch_decode(llrs, plan: DlschPlan, softbuffers=None, iters_out=None):
    """Decode llrs[..., G] -> (tb_bits[..., tbs], crc_ok[...], softbuffers).

    Mirrors decode_tb / decode_tb_cb (sch.c:307-437): per-CB de-rate-match
    with HARQ combining into ``softbuffers`` (list of per-CB arrays or
    None), batched turbo decode, CB CRC checks, reassembly, TB CRC.

    On the GPU (the NII Pallas decoder) with no incoming HARQ state, the
    fused feed path (_dlsch_decode_fused) is used instead — identical
    results, one HBM materialization instead of six.
    """
    if softbuffers is None:
        geo = _fused_geometry(llrs.shape, plan)
        if geo is not None:
            return _dlsch_decode_fused(llrs, plan, *geo, iters_out=iters_out)
    segm = plan.segm
    stop_crc = (CRC24B if segm.c > 1 else CRC24A) if plan.early_stop else None

    # Group code blocks by (K, E, F) for de-rate-matching, then merge
    # same-K groups into ONE batched turbo decode — the reference decodes
    # CBs serially (sch.c:307-422); stacking them multiplies the kernel
    # batch, and merging across E/F variants (the first CB's filler, the
    # +Qm last-CB rate-match size) avoids a second, mostly-padding kernel
    # launch for the odd CB out.
    groups: dict = {}
    for idx, (k, e, f, off) in enumerate(plan.cb_plans):
        groups.setdefault((k, e, f), []).append((idx, off))

    derm: dict = {}
    for (k, e, f), members in groups.items():
        seg = jnp.stack([llrs[..., off : off + e] for _, off in members],
                        axis=-2)                       # [..., n_cb, E]
        sb = (jnp.stack([softbuffers[idx] for idx, _ in members], axis=-2)
              if softbuffers is not None else None)
        d_llr, ns = plan.rm(k, f).rx(seg, plan.rv, softbuffer=sb)
        derm.setdefault(k, []).append((f, members, d_llr, ns))

    new_soft = [None] * segm.c
    cb_bits = [None] * segm.c
    cb_ok = [None] * segm.c
    for k, items in derm.items():
        d_all = (jnp.concatenate([d for _f, _m, d, _n in items], axis=-3)
                 if len(items) > 1 else items[0][2])
        bits, _ = plan.decoder(k).decode(d_all, crc=stop_crc)
        slot = 0
        for f, members, _d, ns in items:
            for j, (idx, _off) in enumerate(members):
                new_soft[idx] = ns[..., j, :]
                b = bits[..., slot, :]
                slot += 1
                if segm.c > 1:
                    cb_ok[idx] = CRC24B.jnp_check(b)
                    cb_bits[idx] = b[..., f : k - 24]
                else:
                    cb_bits[idx] = b[..., f:]
    cb_ok = [ok for ok in cb_ok if ok is not None]

    full = jnp.concatenate(cb_bits, axis=-1)     # [..., tbs + 24]
    tb_ok = CRC24A.jnp_check(full)
    # the all-zero word is a valid turbo codeword whose CRC trivially
    # passes; a decoder collapsing to it (e.g. wrong descrambling) must
    # not report success
    tb_ok = jnp.logical_and(tb_ok, jnp.any(full != 0, axis=-1))
    if cb_ok:
        all_cb = cb_ok[0]
        for ok in cb_ok[1:]:
            all_cb = jnp.logical_and(all_cb, ok)
        tb_ok = jnp.logical_and(tb_ok, all_cb)
    return full[..., : plan.tbs], tb_ok, new_soft
