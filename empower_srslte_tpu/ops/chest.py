"""Downlink channel estimation from CRS pilots.

Capability parity with lib/src/phy/ch_estimation/chest_dl.c: LS estimates
at pilot REs (chest_dl.c:641-663), frequency-domain smoothing, linear
frequency interpolation and linear time interpolation with edge
extrapolation (interpolate_pilots, chest_dl.c:365-446), plus noise /
RSRP / RSSI estimators (chest_dl.c:268-361, 741-840).

Batched design: pilot gathers and interpolation are static index maps
precomputed per (cell, sf_idx, port); everything runs batched over
subframes and rx antennas as pure jnp ops under jit.
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from ..models.refsignal import crs_pilots
from ..utils.cell import Cell


@functools.lru_cache(maxsize=512)
def _interp_plan(cell: Cell, sf_idx: int, port: int):
    """Static plan: pilot gather indices + freq/time interpolation weights.

    Returns dict of numpy arrays:
      re_idx [P, M]   pilot subcarrier per pilot-symbol-row
      syms [P]        subframe symbol index per row
      vals [P, M]     conj pilot values (for LS by multiply)
      wf [P, NRE, 2]  (left index, right index, frac) encoded for freq
                      interpolation per row -> (idx0, idx1, w)
      tw [nsymb, P]   time interpolation weights row->symbol
    """
    re_idx, syms, vals = crs_pilots(cell, sf_idx, port)
    p, m = re_idx.shape
    nre = cell.nof_re
    nsymb = cell.nsymb_sf

    # frequency interpolation: for each subcarrier, linear between the two
    # nearest pilots of the row (extrapolating at the edges)
    idx0 = np.zeros((p, nre), np.int32)
    idx1 = np.zeros((p, nre), np.int32)
    wgt = np.zeros((p, nre), np.float32)
    for r in range(p):
        k = re_idx[r].astype(np.float64)  # ascending pilot positions
        for sc in range(nre):
            j = np.searchsorted(k, sc) - 1
            j = min(max(j, 0), m - 2)
            idx0[r, sc] = j
            idx1[r, sc] = j + 1
            wgt[r, sc] = (sc - k[j]) / (k[j + 1] - k[j])

    # time interpolation: for each subframe symbol, linear between the two
    # nearest pilot symbols (extrapolating at the edges)
    tsy = syms.astype(np.float64)
    order = np.argsort(tsy)
    tsy_sorted = tsy[order]
    tw = np.zeros((nsymb, p), np.float32)
    for s in range(nsymb):
        j = np.searchsorted(tsy_sorted, s) - 1
        j = min(max(j, 0), p - 2)
        t0, t1 = tsy_sorted[j], tsy_sorted[j + 1]
        w = (s - t0) / (t1 - t0)
        tw[s, order[j]] = 1.0 - w
        tw[s, order[j + 1]] = w
    # regular 6-subcarrier comb detection (always true for CRS): allows
    # strided-slice extraction and periodic-phase interpolation
    combs = None
    if all(np.all(np.diff(re_idx[r]) == 6) for r in range(p)):
        combs = tuple(int(re_idx[r][0]) for r in range(p))
    return dict(re_idx=re_idx, syms=syms, conj_vals=np.conj(vals),
                idx0=idx0, idx1=idx1, wgt=wgt, tw=tw, comb_offsets=combs)



def _ls_pilots(grid, plan):
    """LS pilot estimates h_p [..., P, M] = y(pilot) * conj(r).

    CRS pilots sit on a regular 6-subcarrier comb per row, so extraction
    is a strided SLICE per pilot-symbol row; the take_along_axis
    formulation (a gather along the minor axis) is kept as a fallback.
    """
    re_idx = plan["re_idx"]
    syms = plan["syms"]
    cvals = plan["conj_vals"]
    if plan.get("comb_offsets") is not None:
        rows = []
        for r, (sy, off) in enumerate(zip(syms, plan["comb_offsets"])):
            rows.append(grid[..., int(sy), int(off) :: 6]
                        * jnp.asarray(cvals[r]))
        return jnp.stack(rows, axis=-2)
    rows = grid[..., jnp.asarray(syms), :]
    h_p = jnp.take_along_axis(
        rows, jnp.broadcast_to(jnp.asarray(re_idx),
                               rows.shape[:-1] + re_idx.shape[-1:]),
        axis=-1)
    return h_p * jnp.asarray(cvals)


def _freq_interp_row(h_p_row, off: int, nre: int):
    """Linear pilot->subcarrier interpolation for one comb row (pilots
    at off + 6m): periodic-phase reshape instead of two lane gathers.
    Identical weights to the generic searchsorted plan (asserted by the
    chest tests): interior phases d/6, linear extrapolation at edges."""
    m = h_p_row.shape[-1]
    d = jnp.arange(6, dtype=jnp.float32) / 6.0
    hl = h_p_row[..., :-1, None]
    hr = h_p_row[..., 1:, None]
    interior = hl * (1.0 - d) + hr * d
    interior = interior.reshape(*h_p_row.shape[:-1], 6 * (m - 1))
    parts = []
    if off:
        wl = (jnp.arange(off, dtype=jnp.float32) - off) / 6.0
        parts.append(h_p_row[..., 0:1] * (1.0 - wl)
                     + h_p_row[..., 1:2] * wl)
    parts.append(interior)
    n_r = nre - off - 6 * (m - 1)
    if n_r:
        wr = (jnp.arange(n_r, dtype=jnp.float32) + 6 * (m - 1)) / 6.0 \
            - (m - 2)
        parts.append(h_p_row[..., m - 2 : m - 1] * (1.0 - wr)
                     + h_p_row[..., m - 1 : m] * wr)
    return jnp.concatenate(parts, axis=-1)


#: 3-tap frequency smoothing filter (chest_dl.c default smooth filter).
SMOOTH_3TAP = np.array([0.3333, 0.3334, 0.3333], np.float32)


def gauss_taps(std_dev: float, order: int = 4) -> np.ndarray:
    """Gaussian frequency-smoothing taps, sum-normalized
    (chest_dl.c:475-494 set_smooth_filter_gauss)."""
    std_dev = max(float(std_dev), 1e-4)
    n = order + 1
    center = (n - 1) // 2
    taps = np.exp(-((np.arange(n) - center) ** 2) / (2.0 * std_dev ** 2))
    return (taps / taps.sum()).astype(np.float32)


def auto_gauss_std(noise_est: float) -> float:
    """SNR-adaptive Gaussian bandwidth: std = N0 * 200 (the reference's
    feedback rule at chest_dl.c:616-618 — narrower smoothing at high
    SNR, wider at low SNR; fed from the previous subframe's estimate)."""
    return float(noise_est) * 200.0


def _smooth_taps(h_p, taps: np.ndarray):
    """Edge-replicated FIR along the pilot axis with static taps."""
    n = len(taps)
    half = (n - 1) // 2
    padded = jnp.concatenate([jnp.repeat(h_p[..., :1], half, axis=-1),
                              h_p,
                              jnp.repeat(h_p[..., -1:], n - 1 - half,
                                         axis=-1)], axis=-1)
    acc = None
    for i, w in enumerate(taps):
        term = float(w) * padded[..., i : i + h_p.shape[-1]]
        acc = term if acc is None else acc + term
    return acc


def chest_dl(grid, cell: Cell, sf_idx: int, port: int = 0,
             smooth: bool = True, gauss_std: float | None = None):
    """Estimate h for one TX port: grid [..., nsymb, nre] -> same shape.

    LS at pilots, 3-tap freq smoothing (or an SNR-adaptive Gaussian when
    ``gauss_std`` is given — chest_dl.c:616 smooth_filter_auto, fed from
    the previous subframe's noise estimate via :func:`auto_gauss_std`),
    then freq + time linear interpolation. Batched over all leading dims
    (subframes, rx antennas).
    """
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan)                    # [..., P, M]

    if gauss_std is not None:
        h_p = _smooth_taps(h_p, gauss_taps(gauss_std))
    elif smooth:
        # 3-tap moving average along pilot axis with edge replication
        h_p = _smooth_taps(h_p, SMOOTH_3TAP)

    # frequency interpolation to all subcarriers
    nre = cell.nof_re
    if plan.get("comb_offsets") is not None:
        h_f = jnp.stack(
            [_freq_interp_row(h_p[..., r, :], off, nre)
             for r, off in enumerate(plan["comb_offsets"])], axis=-2)
    else:
        h0 = jnp.take_along_axis(
            h_p, jnp.broadcast_to(
                plan["idx0"], h_p.shape[:-1] + plan["idx0"].shape[-1:]),
            axis=-1)
        h1 = jnp.take_along_axis(
            h_p, jnp.broadcast_to(
                plan["idx1"], h_p.shape[:-1] + plan["idx1"].shape[-1:]),
            axis=-1)
        w = jnp.asarray(plan["wgt"])
        h_f = h0 * (1.0 - w) + h1 * w                # [..., P, nre]

    # time interpolation to all symbols: per-symbol static 2-term lerp
    # (elementwise, no tiny batched matrix products)
    return time_interp_apply(plan["tw"], h_f)


def time_interp_apply(tw, h_f):
    """Apply a static [nsymb, P] time-interpolation weight matrix to
    per-pilot-symbol estimates h_f[..., P, k] as per-symbol scaled sums
    (each row has <= 2 nonzeros: linear interpolation between adjacent
    pilot symbols, interpolate_pilots chest_dl.c:365-446)."""
    import numpy as np

    tw = np.asarray(tw)
    outs = []
    for srow in tw:
        nz = np.nonzero(srow)[0]
        acc = None
        for pcol in nz:
            term = float(srow[pcol]) * h_f[..., pcol, :]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None
                    else jnp.zeros_like(h_f[..., 0, :]))
    return jnp.stack(outs, axis=-2)


def noise_est_pilots(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Noise power from pilot residuals after 3-tap smoothing
    (chest_dl.c:268-329 estimate_noise_pilots): E|h_ls - smooth(h_ls)|^2.

    Returns [...] per batch element. The 3-tap average keeps ~2/3 noise-
    free signal, so the residual power is scaled to unbiased N0 like the
    reference does.
    """
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan)
    left = h_p[..., :1]
    right = h_p[..., -1:]
    padded = jnp.concatenate([left, h_p, right], axis=-1)
    sm = (SMOOTH_3TAP[0] * padded[..., :-2] + SMOOTH_3TAP[1] * padded[..., 1:-1]
          + SMOOTH_3TAP[2] * padded[..., 2:])
    resid = h_p - sm
    # var(resid) = N0 * (1 - 1/3 - ...): residual of a 3-tap mean keeps
    # 2/3 of the noise power -> unbias by 3/2
    return jnp.mean(jnp.abs(resid) ** 2, axis=(-1, -2)) * 1.5


def noise_est_pss(grid, ce, cell: Cell):
    """Noise power from the PSS residual (chest_dl.c:331-348
    estimate_noise_pss): reconstruct the known PSS through the channel
    estimate and measure the residual against the received symbols.

    grid/ce [..., nsymb, nre] (subframe 0 or 5); returns [...].
    """
    from .sync import pss_freq

    sym = cell.nsymb_slot - 1                 # last symbol of slot 0
    k0 = cell.nof_re // 2 - 31
    rx = grid[..., sym, k0 : k0 + 62]
    h = ce[..., sym, k0 : k0 + 62]
    pss = jnp.asarray(pss_freq(cell.id % 3))
    resid = h * pss - rx
    power = jnp.mean(jnp.abs(resid) ** 2, axis=-1)
    return cell.nof_ports * power / np.sqrt(2.0)


def rsrp(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Reference-signal received power (chest_dl.c:741-: mean |h_ls|^2)."""
    plan = _interp_plan(cell, sf_idx, port)
    re_idx = jnp.asarray(plan["re_idx"])
    syms = jnp.asarray(plan["syms"])
    rows = grid[..., syms, :]
    pil = jnp.take_along_axis(
        rows, jnp.broadcast_to(re_idx, rows.shape[:-1] + re_idx.shape[-1:]),
        axis=-1)
    return jnp.abs(jnp.mean(pil * jnp.asarray(plan["conj_vals"]),
                            axis=(-1, -2))) ** 2


def rssi(grid):
    """Total received power over the grid (chest_dl.c rssi)."""
    return jnp.mean(jnp.abs(grid) ** 2, axis=(-1, -2))


def noise_est_empty_sc(grid, cell: Cell):
    """Noise from the empty guard-adjacent subcarriers is not available in
    the DC-skipped grid; the reference's third estimator uses REs adjacent
    to the sync signals left empty (chest_dl.c:351-361). Here: the 5
    unused REs on each side of the 62-RE sync band in PSS/SSS symbols.
    Apply only to subframes 0/5. Returns [...] noise power.
    """
    nsym = cell.nsymb_slot
    mid = cell.nof_re // 2
    edge = np.concatenate([np.arange(mid - 36, mid - 31),
                           np.arange(mid + 31, mid + 36)])
    re = grid[..., nsym - 1, :][..., jnp.asarray(edge)]
    return jnp.mean(jnp.abs(re) ** 2, axis=-1)


def rsrq(grid, cell: Cell, sf_idx: int, port: int = 0):
    """RSRQ = N * RSRP / RSSI over the measurement bandwidth
    (chest_dl.c:790-840)."""
    return cell.nof_prb * rsrp(grid, cell, sf_idx, port) / jnp.maximum(
        rssi(grid) * cell.nof_re, 1e-20)


def cfo_est_pilots(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Residual CFO from the phase drift between the two CRS symbols of
    each slot (chest_dl.c:583-603). Returns CFO in subcarrier units [...].
    """
    plan = _interp_plan(cell, sf_idx, port)
    re_idx = jnp.asarray(plan["re_idx"])
    syms = plan["syms"]
    cvals = jnp.asarray(plan["conj_vals"])
    rows = grid[..., jnp.asarray(syms), :]
    h_p = jnp.take_along_axis(
        rows, jnp.broadcast_to(re_idx, rows.shape[:-1] + re_idx.shape[-1:]),
        axis=-1) * cvals
    # pairs within each slot: rows (0,1) and (2,3) for 2 CRS symbols/slot
    corr = (jnp.sum(h_p[..., 1, :] * jnp.conj(h_p[..., 0, :]), axis=-1)
            + jnp.sum(h_p[..., 3, :] * jnp.conj(h_p[..., 2, :]), axis=-1))
    dsym = int(syms[1] - syms[0])  # symbols between CRS pilots in a slot
    fft = cell.fft_size
    cp = cell.cp_len_slot[1]
    return jnp.angle(corr) / (2 * np.pi) * fft / ((fft + cp) * dsym)
