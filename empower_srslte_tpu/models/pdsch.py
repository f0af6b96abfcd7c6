"""PDSCH: physical downlink shared channel processor.

Capability parity with lib/src/phy/phch/pdsch.c: RE mapping that skips
CRS/sync/PBCH regions (pdsch_cp, pdsch.c:95-214), per-RNTI scrambling
(pdsch.c:616-632), codeword encode/decode (pdsch.c:634-835) with
CSI-weighted LLRs (csi_correction, pdsch.c:676-776), and the MIMO
dispatch to single/SFBC/spatial-multiplexing paths.

Batched design: the RE map is a precomputed flat index table per
(cell, sf_idx, cfi, allocation) — one gather/scatter instead of the
reference's per-symbol copy loops; everything below it is batched jnp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.equalizer import (
    MimoType,
    codebook_2x2,
    effective_channel_cdd,
    effective_channel_mux,
    eq_mux_2x2,
    eq_sfbc,
    eq_single,
    layerdemap,
    layermap,
    precode_cdd_2layer,
    precode_mux_2x2,
    precode_sfbc,
)
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..utils.cell import Cell
from ..utils.sequence import cinit_pdsch
from .refsignal import crs_mask
from .sch import DlschPlan, dlsch_decode, dlsch_encode

#: Central subcarriers reserved for PSS/SSS (72 = 6 PRB around DC).
SYNC_RE = 72


@functools.lru_cache(maxsize=1024)
def pdsch_re_indices(cell: Cell, sf_idx: int, cfi: int,
                     prb_mask: tuple[bool, ...] | None = None,
                     prb_mask_slot1: tuple[bool, ...] | None = None
                     ) -> np.ndarray:
    """Flat indices (s * nof_re + k) of PDSCH REs, in 36.211 6.3.5 mapping
    order (k ascending within each symbol, symbols ascending, skipping the
    control region, CRS, and the PSS/SSS/PBCH reservations of subframes
    0 and 5). Equivalent to the index arithmetic of pdsch_cp
    (lib/src/phy/phch/pdsch.c:95-214).
    """
    nre = cell.nof_re
    usable = np.ones((cell.nsymb_sf, nre), dtype=bool)
    from .regs import nof_ctrl_symbols
    usable[:nof_ctrl_symbols(cell, cfi), :] = False   # control region
    usable[crs_mask(cell, sf_idx)] = False        # CRS of all cell ports

    mid = nre // 2
    sync_cols = slice(mid - SYNC_RE // 2, mid + SYNC_RE // 2)
    nsym_slot = cell.nsymb_slot
    if sf_idx == 0 or sf_idx == 5:
        # PSS (last symbol of slot 0) and SSS (the one before), FDD
        usable[nsym_slot - 1, sync_cols] = False
        usable[nsym_slot - 2, sync_cols] = False
    if sf_idx == 0:
        # PBCH: first 4 symbols of slot 1, central 6 PRB (CRS holes counted
        # as PBCH region too — they are excluded already)
        for s in range(nsym_slot, nsym_slot + 4):
            usable[s, sync_cols] = False

    if prb_mask is not None:
        col = np.repeat(np.asarray(prb_mask, dtype=bool), 12)
        if prb_mask_slot1 is not None:
            # distributed VRB allocations hop between slots (ra.c:353-420)
            col1 = np.repeat(np.asarray(prb_mask_slot1, dtype=bool), 12)
            usable[: cell.nsymb_slot] &= col[None, :]
            usable[cell.nsymb_slot :] &= col1[None, :]
        else:
            usable &= col[None, :]

    sym_idx, k_idx = np.nonzero(usable)
    order = np.lexsort((k_idx, sym_idx))          # symbol-major, k fastest
    return (sym_idx[order] * nre + k_idx[order]).astype(np.int32)


@dataclass(frozen=True)
class PdschConfig:
    """Static PDSCH configuration for one (cell, grant) combination."""

    cell: Cell
    sf_idx: int = 0
    cfi: int = 1
    rnti: int = 0x1234
    mod: Mod = Mod.QPSK
    mimo: MimoType = MimoType.SINGLE
    nof_layers: int = 1
    nof_codewords: int = 1
    pmi: int = 0
    prb_mask: tuple[bool, ...] | None = None
    prb_mask_slot1: tuple[bool, ...] | None = None   # distributed VRB hop
    #: 8-bit quantized LLR lane (demod_soft.c byte scales + rm_turbo.c
    #: int8 combining): quantize after CSI weighting, descramble/de-RM/
    #: HARQ-combine in int8, decode in bf16
    llr_int8: bool = False

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return pdsch_re_indices(self.cell, self.sf_idx, self.cfi,
                                self.prb_mask, self.prb_mask_slot1)

    @functools.cached_property
    def extract_plan(self):
        return _symbol_extract_plan(self.cell, self.sf_idx, self.cfi,
                                    self.prb_mask, self.prb_mask_slot1)

    @property
    def nof_re(self) -> int:
        """REs per antenna port available to this allocation."""
        return len(self.re_indices)

    @property
    def nof_symbols(self) -> int:
        """Modulation symbols per codeword."""
        if self.mimo is MimoType.SINGLE:
            return self.nof_re
        if self.mimo is MimoType.DIVERSITY:
            # SFBC needs RE pairs (2-port) or quads (4-port SFBC-FSTD)
            group = 4 if self.cell.nof_ports == 4 else 2
            return self.nof_re - (self.nof_re % group)
        # spatial multiplexing: every RE carries nof_layers symbols,
        # split across nof_codewords codewords
        return self.nof_re * self.nof_layers // self.nof_codewords

    @property
    def g(self) -> int:
        """Codeword bits carried (per codeword)."""
        return self.nof_symbols * self.mod.bits_per_symbol

    def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
             decoder_impl: str = "auto") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         rv=rv, max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self, codeword: int = 0) -> int:
        return cinit_pdsch(self.rnti, codeword, 2 * self.sf_idx, self.cell.id)


# --- encode (eNB side) ------------------------------------------------------


def pdsch_encode(tb_bits, cfg: PdschConfig, plan: DlschPlan, tb_bits2=None,
                 plan2: DlschPlan | None = None):
    """tb_bits[..., tbs] -> per-port grid [..., ports, nsymb, nre].

    DL-SCH encode -> scramble -> modulate -> layer map -> precode -> RE
    scatter (srslte_pdsch_encode, pdsch.c:1048).
    """
    cws = []
    for cw, (bits, pl) in enumerate(
            [(tb_bits, plan)] + ([(tb_bits2, plan2)] if tb_bits2 is not None else [])):
        coded = dlsch_encode(bits, pl)
        scr = scramble_bits(coded, cfg.cinit(cw))
        cws.append(modulate(scr, cfg.mod))

    if cfg.mimo is MimoType.SINGLE:
        ports = cws[0][..., None, :]                       # [..., 1, M]
    elif cfg.mimo is MimoType.DIVERSITY:
        if cfg.cell.nof_ports == 4:
            from ..ops.equalizer import precode_sfbc_fstd

            layers = layermap(cws, 4)
            ports = precode_sfbc_fstd(layers)              # [..., 4, M_re]
        else:
            layers = layermap(cws, 2)
            ports = precode_sfbc(layers)                   # [..., 2, M_re]
    elif cfg.mimo is MimoType.SPATIAL_MUX:
        layers = layermap(cws, cfg.nof_layers, cfg.nof_codewords)
        ports = precode_mux_2x2(layers, cfg.pmi)
    elif cfg.mimo is MimoType.CDD:
        layers = layermap(cws, cfg.nof_layers, cfg.nof_codewords)
        ports = precode_cdd_2layer(layers)
    else:
        raise NotImplementedError(cfg.mimo)

    from ..utils.scatter import place

    n_ports = ports.shape[-2]
    lead = ports.shape[:-2]
    flat_len = cfg.cell.nsymb_sf * cfg.cell.nof_re
    grid = place(ports, cfg.re_indices[: ports.shape[-1]], flat_len)
    return grid.reshape(*lead, n_ports, cfg.cell.nsymb_sf, cfg.cell.nof_re)


# --- decode (UE side) -------------------------------------------------------


def _runs(mask: np.ndarray) -> list[tuple[int, int]]:
    """Maximal runs of True as (start, stop) pairs."""
    idx = np.nonzero(mask)[0]
    if len(idx) == 0:
        return []
    cuts = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate([[idx[0]], idx[cuts + 1]])
    stops = np.concatenate([idx[cuts] + 1, [idx[-1] + 1]])
    return list(zip(starts.tolist(), stops.tolist()))


def _symbol_extract_plan(cell: Cell, sf_idx: int, cfi: int,
                         prb_mask, prb_mask_slot1):
    """Per-symbol slice recipes for the structured RE extraction.

    The PDSCH usable-RE mask of every symbol factors as
    (PRB-row mask) x (common 12-subcarrier pattern): CRS holes repeat
    per PRB, the sync/PBCH reservation removes whole central PRBs, and
    allocations mask whole PRBs. Each symbol therefore extracts with
    static PRB-run slices + a reshape + static column-run slices — no
    gather along the minor axis, as the naive ``flat[..., idx]``
    formulation needs. Falls back to a gather for any symbol
    whose mask does not factor (none do in practice).
    """
    nre = cell.nof_re
    usable = np.ones((cell.nsymb_sf, nre), dtype=bool)
    from .regs import nof_ctrl_symbols
    usable[:nof_ctrl_symbols(cell, cfi), :] = False
    usable[crs_mask(cell, sf_idx)] = False
    mid = nre // 2
    sync_cols = slice(mid - SYNC_RE // 2, mid + SYNC_RE // 2)
    nsym_slot = cell.nsymb_slot
    if sf_idx == 0 or sf_idx == 5:
        usable[nsym_slot - 1, sync_cols] = False
        usable[nsym_slot - 2, sync_cols] = False
    if sf_idx == 0:
        for s in range(nsym_slot, nsym_slot + 4):
            usable[s, sync_cols] = False
    if prb_mask is not None:
        col = np.repeat(np.asarray(prb_mask, dtype=bool), 12)
        if prb_mask_slot1 is not None:
            col1 = np.repeat(np.asarray(prb_mask_slot1, dtype=bool), 12)
            usable[:nsym_slot] &= col[None, :]
            usable[nsym_slot:] &= col1[None, :]
        else:
            usable &= col[None, :]

    nprb = nre // 12
    plan = []
    for s in range(cell.nsymb_sf):
        m = usable[s]
        if not m.any():
            continue
        per_prb = m.reshape(nprb, 12)
        rows_used = per_prb.any(axis=1)
        pattern = per_prb[rows_used][0]
        if np.all(per_prb[rows_used] == pattern[None, :]):
            prb_runs = _runs(rows_used)
            col_runs = _runs(pattern)
            plan.append(("factored", s, tuple(prb_runs), tuple(col_runs)))
        else:  # pragma: no cover - defensive fallback
            plan.append(("gather", s, np.nonzero(m)[0].astype(np.int32)))
    return tuple(plan)


def pdsch_extract(grid, cfg: PdschConfig):
    """Extract PDSCH REs: [..., nsymb, nre] -> [..., M] in 36.211 6.3.5
    mapping order (pdsch_get / pdsch_cp, pdsch.c:95-214).

    Structured slice/reshape extraction (see _symbol_extract_plan);
    output order matches ``cfg.re_indices`` exactly.
    """
    nprb = cfg.cell.nof_re // 12
    pieces = []
    for entry in cfg.extract_plan:
        if entry[0] == "factored":
            _, s, prb_runs, col_runs = entry
            sym = grid[..., s, :]
            prbs = sym.reshape(*sym.shape[:-1], nprb, 12)
            if len(prb_runs) != 1 or prb_runs[0] != (0, nprb):
                prbs = jnp.concatenate(
                    [prbs[..., a:b, :] for a, b in prb_runs], axis=-2)
            if len(col_runs) == 1 and col_runs[0] == (0, 12):
                out = prbs
            else:
                out = jnp.concatenate(
                    [prbs[..., a:b] for a, b in col_runs], axis=-1)
            pieces.append(out.reshape(*out.shape[:-2], -1))
        else:
            _, s, idx = entry
            pieces.append(grid[..., s, :][..., jnp.asarray(idx)])
    return jnp.concatenate(pieces, axis=-1)


@functools.lru_cache(maxsize=1024)
def _grid_maps(cfg: PdschConfig):
    """Static tables for the grid-domain fused path.

    g_map [G]: codeword-bit position -> flat row of the per-codeword
    grid-LLR layout [nsymb*nof_re*bps] (bit j of the RE at flat grid
    position cfg.re_indices[i] lives at row re_indices[i]*bps + j).
    signs [ncw, R]: descrambling +-1 scattered to those rows (+1 on
    never-read rows).
    """
    bps = cfg.mod.bits_per_symbol
    m = cfg.nof_symbols
    sk = cfg.cell.nsymb_sf * cfg.cell.nof_re
    re_idx = cfg.re_indices[:m].astype(np.int64)
    # PLANE-MAJOR rows (bit plane j in [0, bps) is a contiguous [SK]
    # block): the demapper then never interleaves bits per symbol — the
    # planes stack along a major axis, which is free, and the decoder
    # feed's gather absorbs the layout.
    rows = (np.arange(bps)[None, :] * sk + re_idx[:, None]).reshape(-1)
    r_len = sk * bps

    from ..utils.sequence import gold_sequence

    signs = np.ones((cfg.nof_codewords, r_len), np.float32)
    for cw in range(cfg.nof_codewords):
        c = gold_sequence(cfg.cinit(cw), m * bps)
        signs[cw, rows] = 1.0 - 2.0 * c
    return rows, signs.reshape(cfg.nof_codewords, bps, sk)


def _pdsch_decode_fused_grid(grid, h, cfg: PdschConfig, plan: DlschPlan,
                             noise_est, geo, iters_out=None):
    """Grid-domain fused receive path.

    The RE extraction (pdsch_extract's per-symbol slice/concat plans) was
    a set of strided copies for every CRS comb. This path never
    extracts: equalization, soft demapping, CSI weighting and
    descrambling run ELEMENTWISE over the full resource grid (compute on
    the ~15% non-PDSCH REs is wasted but free next to the copies), and
    the RE selection folds into the fused decoder feed's gather tables
    via ``g_map`` (ops/fec/derm_tiles.py). One HBM materialization
    between the antenna grids and the turbo kernel tiles.

    Supported: SINGLE, and SPATIAL_MUX with nof_codewords == nof_layers
    == 2 (the codeword<->layer maps that stay aligned with the grid);
    other configs (SFBC pairs, CDD whose D(i) cycles over the extracted
    RE index) use the classic extracted path.
    """
    import jax.numpy as jnp

    from ..ops.equalizer import eq_mux_2x2_components
    from ..ops.modem import demod_planes
    from .sch import _dlsch_decode_fused

    cell = cfg.cell
    sk = cell.nsymb_sf * cell.nof_re
    bps = cfg.mod.bits_per_symbol
    flat = lambda a: a.reshape(*a.shape[:-2], sk)
    if cfg.mimo is MimoType.SINGLE:
        # MRC across rx antennas, component form (no stacked axes)
        n_ant = grid.shape[-3]
        num = den = None
        for a in range(n_ant):
            ya = flat(grid[..., a, :, :])
            ha = flat(h[..., a, 0, :, :])
            t_num = jnp.conj(ha) * ya
            t_den = jnp.abs(ha) ** 2
            num = t_num if num is None else num + t_num
            den = t_den if den is None else den + t_den
        den = den + noise_est
        x0 = num / jnp.maximum(den, 1e-20)
        layers = [(x0, den)]
    else:
        # fold the TM4 precoder into per-component effective channels
        w = codebook_2x2(cfg.pmi)
        hc = [[flat(h[..., a, p, :, :]) for p in range(2)] for a in range(2)]
        e00 = w[0, 0] * hc[0][0] + w[1, 0] * hc[0][1]
        e01 = w[0, 1] * hc[0][0] + w[1, 1] * hc[0][1]
        e10 = w[0, 0] * hc[1][0] + w[1, 0] * hc[1][1]
        e11 = w[0, 1] * hc[1][0] + w[1, 1] * hc[1][1]
        x0, x1, csi0, csi1 = eq_mux_2x2_components(
            flat(grid[..., 0, :, :]), flat(grid[..., 1, :, :]),
            e00, e01, e10, e11, noise_est)
        layers = [(x0, csi0), (x1, csi1)]

    rows, signs = _grid_maps(cfg)
    cw_rows = []
    for cw, (syms, wgt) in enumerate(layers):
        # ONE explicit transpose at the eq->demod boundary (grid
        # positions to the major axis, batch minor), then the whole
        # demod/CSI/descramble runs natively in the decoder feed's
        # positions-major layout. The previous batch-major demod let
        # XLA fuse the transpose into the plane fusions, whose
        # transposed writes profiled at ~4x their theoretical bytes
        # (docs/BENCHMARKS.md round-5 notes).
        re_t = jnp.moveaxis(jnp.real(syms), -1, -2)     # [..., SK, B]
        im_t = jnp.moveaxis(jnp.imag(syms), -1, -2)
        wgt_t = jnp.moveaxis(wgt, -1, -2)
        planes = demod_planes(re_t, im_t, cfg.mod)
        sgn_np = signs[cw]                              # [bps, SK]
        outs = []
        for j, p in enumerate(planes):
            pj = p * wgt_t
            sgn_col = sgn_np[j][:, None]                # [SK, 1]
            if cfg.llr_int8:
                from ..ops.modem import quantize_llr_int8

                pj = quantize_llr_int8(pj, cfg.mod)
                outs.append(pj * jnp.asarray(sgn_col.astype(np.int8)))
            else:
                outs.append(pj * jnp.asarray(sgn_col))
        # plane-major stack: rows j*SK + pos, batch minor — a free
        # reshape (bps and SK axes adjacent, batch stays minor)
        llr = jnp.stack(outs, axis=-3).reshape(
            *syms.shape[:-2], bps * sk, syms.shape[-2])
        cw_rows.append(llr)
    llr_rows = (jnp.stack(cw_rows, axis=0) if len(cw_rows) > 1
                else cw_rows[0])

    outs = _dlsch_decode_fused(llr_rows, plan, *geo, g_map=rows,
                               iters_out=iters_out, pos_major=True)
    if len(cw_rows) == 1:
        return outs
    bits, ok, soft = outs
    per_cw = [(bits[i], ok[i], [s[i] for s in soft]) for i in range(2)]
    return tuple(zip(*per_cw))


def pdsch_decode(grid, h, cfg: PdschConfig, plan: DlschPlan, noise_est=0.0,
                 softbuffers=None, plan2: DlschPlan | None = None,
                 softbuffers2=None, iters_out=None):
    """Full PDSCH decode (srslte_pdsch_decode, pdsch.c:837-1007).

    grid: [..., A, nsymb, nre] received resource grids per rx antenna
    h:    [..., A, P, nsymb, nre] channel estimates per (rx, tx port)
    Returns (tb_bits, crc_ok, softbuffers) — tuples per codeword when a
    second plan is given.
    """
    batch_shape = grid.shape[:-3]
    if (softbuffers is None and softbuffers2 is None and len(batch_shape)
            and (cfg.mimo is MimoType.SINGLE and plan2 is None
                 or (cfg.mimo is MimoType.SPATIAL_MUX
                     and cfg.nof_layers == 2 and cfg.nof_codewords == 2
                     and plan2 == plan))):
        from .sch import _fused_geometry

        ncw = 1 if plan2 is None else 2
        rows_shape = (ncw, *batch_shape, 1) if ncw == 2 \
            else (*batch_shape, 1)
        geo = _fused_geometry(rows_shape, plan)
        if geo is not None:
            return _pdsch_decode_fused_grid(grid, h, cfg, plan,
                                            noise_est, geo,
                                            iters_out=iters_out)
    y = pdsch_extract(grid, cfg)                          # [..., A, M]
    m = cfg.nof_symbols

    if cfg.mimo is MimoType.SINGLE:
        hh = pdsch_extract(h[..., :, 0, :, :], cfg)
        x, csi = eq_single(y, hh, noise_est)
        cw_syms = [x[..., :m]]
        csis = [csi[..., :m]]
    elif cfg.mimo is MimoType.DIVERSITY:
        if cfg.cell.nof_ports == 4:
            from ..ops.equalizer import eq_sfbc_fstd

            hp = [pdsch_extract(h[..., :, p, :, :], cfg)[..., :m]
                  for p in range(4)]
            x, csi = eq_sfbc_fstd(y[..., :m], *hp)
        else:
            h0 = pdsch_extract(h[..., :, 0, :, :], cfg)
            h1 = pdsch_extract(h[..., :, 1, :, :], cfg)
            x, csi = eq_sfbc(y[..., :m], h0[..., :m], h1[..., :m])
        cw_syms = [x]
        csis = [csi]
    elif cfg.mimo in (MimoType.SPATIAL_MUX, MimoType.CDD):
        hp = jnp.stack([pdsch_extract(h[..., :, p, :, :], cfg)
                        for p in range(2)], axis=-2)      # [..., A, 2, M]
        if cfg.mimo is MimoType.SPATIAL_MUX:
            h_eff = effective_channel_mux(hp, cfg.pmi)
        else:
            h_eff = effective_channel_cdd(hp)
        x, csi = eq_mux_2x2(y, h_eff, noise_est)          # [..., 2, M]
        cw_syms = layerdemap(x, cfg.nof_codewords)
        csis = layerdemap(csi, cfg.nof_codewords)
    else:
        raise NotImplementedError(cfg.mimo)

    all_soft = [softbuffers, softbuffers2]
    plans = [plan] + ([plan2] if plan2 is not None else [])
    cw_llrs = []
    for cw, (syms, csi) in enumerate(zip(cw_syms, csis)):
        # CSI-weighted max-log LLRs (csi_correction, pdsch.c:676-776)
        llr = demod_soft(syms, cfg.mod)
        w = jnp.repeat(csi, cfg.mod.bits_per_symbol, axis=-1)
        llr = llr * w
        if cfg.llr_int8:
            from ..ops.modem import quantize_llr_int8

            llr = quantize_llr_int8(llr, cfg.mod)
        cw_llrs.append(descramble_llrs(llr, cfg.cinit(cw)))

    # Two codewords with the same plan and no HARQ state decode as ONE
    # dlsch call with a leading codeword axis — doubling the turbo-kernel
    # batch instead of dispatching two half-full (lane-padded) decodes
    # (the batched analog of the reference's TB0-coworker-thread split,
    # pdsch.c:837-1007).
    if (len(plans) == 2 and plans[0] == plans[1]
            and softbuffers is None and softbuffers2 is None):
        bits, ok, soft = dlsch_decode(jnp.stack(cw_llrs, axis=0), plan)
        outs = [(bits[0], ok[0], [s[0] for s in soft]),
                (bits[1], ok[1], [s[1] for s in soft])]
    else:
        outs = [dlsch_decode(llr, pl, softbuffers=all_soft[cw])
                for cw, (llr, pl) in enumerate(zip(cw_llrs, plans))]
    if plan2 is None:
        return outs[0]
    return tuple(zip(*outs))
