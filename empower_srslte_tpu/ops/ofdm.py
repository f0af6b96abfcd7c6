"""Batched OFDM modulation/demodulation with cyclic prefix.

Capability parity with lib/src/phy/dft/ofdm.c (srslte_ofdm_rx_sf /
srslte_ofdm_tx_sf): per-slot FFTs with unequal first-symbol CP, DC
subcarrier skipping (the reference's dft_plan_set_dc, ofdm.c:121,409-415),
and optional +-0.5-subcarrier frequency shift (ofdm.c:363-381).

Batched design: the reference batches 7 symbols per FFTW "guru" call
(dft_fftw.c:141); here the whole subframe across the full batch is one
``jnp.fft`` transform (cuFFT on the GPU) over a [batch, nsymb_sf, fft]
tensor. CP handling is per-symbol static slices (RX) / concatenation of
slices (TX) — no dynamic shapes under jit.
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from ..utils.cell import CP, Cell


def _sf_fft(sym, inverse: bool = False):
    """Whole-subframe transform along the last axis."""
    return jnp.fft.ifft(sym, axis=-1) if inverse \
        else jnp.fft.fft(sym, axis=-1)


@functools.lru_cache(maxsize=64)
def _symbol_starts(nof_prb: int, cp: CP,
                   reduced: bool = False) -> np.ndarray:
    """Sample index of each symbol's data region (after its CP) in a sf."""
    from ..utils.cell import cp_lengths, symbol_sz

    fft = symbol_sz(nof_prb, reduced)
    cps = cp_lengths(nof_prb, cp, reduced)
    starts = []
    pos = 0
    for _slot in range(2):
        for cp_len in cps:
            pos += cp_len
            starts.append(pos)
            pos += fft
    return np.asarray(starts, dtype=np.int32)


@functools.lru_cache(maxsize=16)
def _symbol_starts_mbsfn(nof_prb: int, non_mbsfn_region: int,
                         reduced: bool = False) -> np.ndarray:
    """Symbol data-region starts for an MBSFN subframe: the first
    ``non_mbsfn_region`` symbols keep normal-CP lengths, a guard gap
    re-aligns the timeline, the rest are extended CP
    (srslte_ofdm_rx_slot_mbsfn, ofdm.c:427-440;
    SRSLTE_NON_MBSFN_REGION_GUARD_LENGTH, phy_common.h:140)."""
    from ..utils.cell import symbol_sz

    fft = symbol_sz(nof_prb, reduced)
    cp_norm = lambda i: (160 if i == 0 else 144) * fft // 2048
    cp_ext = 512 * fft // 2048
    guard = (non_mbsfn_region * cp_ext
             - sum(cp_norm(i) for i in range(non_mbsfn_region)))
    starts = []
    pos = 0
    for i in range(6):                  # slot 0: mixed-CP MBSFN slot
        if i == non_mbsfn_region:
            pos += guard
        pos += cp_norm(i) if i < non_mbsfn_region else cp_ext
        starts.append(pos)
        pos += fft
    for _i in range(6):                 # slot 1: plain extended CP
        pos += cp_ext
        starts.append(pos)
        pos += fft
    return np.asarray(starts, dtype=np.int32)


def ofdm_rx_sf_mbsfn(samples, cell: Cell, non_mbsfn_region: int = 2,
                     *, normalize: bool = False):
    """MBSFN subframe demodulation: [..., sf_sample_len] ->
    grid [..., 12, nre] (srslte_ofdm_rx_sf with the mbsfn plan)."""
    fft = cell.fft_size
    starts = _symbol_starts_mbsfn(cell.nof_prb, non_mbsfn_region,
                                  cell.reduced_rates)
    sym = _cp_strip(samples, starts, fft)
    spec = _sf_fft(sym)
    if normalize:
        spec = spec / np.float32(np.sqrt(fft))
    return _bins_extract(spec, cell.nof_prb, cell.reduced_rates)


@functools.lru_cache(maxsize=64)
def _grid_to_bins(nof_prb: int, dc_empty: bool = True,
                  reduced: bool = False) -> np.ndarray:
    """Map grid subcarrier g in [0, nre) -> FFT bin (DC at bin 0).

    Negative half first (ofdm.c:414): g < nre/2 -> fft - nre/2 + g;
    positive half skips the DC bin when dc_empty.
    """
    from ..utils.cell import symbol_sz

    fft = symbol_sz(nof_prb, reduced)
    nre = nof_prb * 12
    g = np.arange(nre, dtype=np.int32)
    dc = 1 if dc_empty else 0
    return np.where(g < nre // 2, fft - nre // 2 + g, g - nre // 2 + dc)


def _cp_strip(samples, starts: np.ndarray, fft: int):
    """CP removal as per-symbol STATIC slices + stack.

    Contiguous static slices lower to plain copies, where the
    index-table formulation (samples[..., idx] with idx [nsymb, fft])
    is a gather along the minor axis.
    """
    return jnp.stack([samples[..., int(s) : int(s) + fft] for s in starts],
                     axis=-2)                               # [..., nsymb, fft]


def _bins_extract(spec, nof_prb: int, reduced: bool, dc_empty: bool = True):
    """FFT bins -> grid subcarriers as TWO contiguous slices (negative
    half at the spectrum top, positive half after the DC bin) instead of
    a 1200-wide lane gather — same order as _grid_to_bins (ofdm.c:414).
    """
    from ..utils.cell import symbol_sz

    fft = symbol_sz(nof_prb, reduced)
    half = nof_prb * 12 // 2
    dc = 1 if dc_empty else 0
    return jnp.concatenate([spec[..., fft - half :],
                            spec[..., dc : dc + half]], axis=-1)


def ofdm_rx_sf(samples, cell: Cell, *, normalize: bool = False):
    """Subframe demodulation: [..., sf_sample_len] -> grid [..., nsymb, nre].

    CP-strip via static slices, one batched FFT, DC-skipping subcarrier
    extraction as two contiguous slices. Equivalent of srslte_ofdm_rx_sf
    (ofdm.c:456).
    """
    fft = cell.fft_size
    starts = _symbol_starts(cell.nof_prb, cell.cp, cell.reduced_rates)
    sym = _cp_strip(samples, starts, fft)                   # [..., nsymb, fft]
    spec = _sf_fft(sym)
    if normalize:
        spec = spec / np.float32(np.sqrt(fft))
    return _bins_extract(spec, cell.nof_prb, cell.reduced_rates)


def ofdm_tx_sf(grid, cell: Cell, *, normalize: bool = False):
    """Subframe modulation: grid [..., nsymb, nre] -> [..., sf_sample_len].

    Equivalent of srslte_ofdm_tx_sf (ofdm.c:583): scatter subcarriers
    around DC, IFFT, insert per-symbol CP.
    """
    from ..utils.scatter import place

    fft = cell.fft_size
    nsymb = cell.nsymb_sf
    bins = _grid_to_bins(cell.nof_prb, reduced=cell.reduced_rates)
    spec = place(grid, bins, fft)
    sym = _sf_fft(spec, inverse=True)                       # [..., nsymb, fft]
    if normalize:
        sym = sym * np.float32(np.sqrt(fft))

    cps = cell.cp_len_slot
    pieces = []
    for i in range(nsymb):
        cp_len = cps[i % cell.nsymb_slot]
        s = sym[..., i, :]
        pieces.append(s[..., fft - cp_len :])
        pieces.append(s)
    return jnp.concatenate(pieces, axis=-1)


def ofdm_tx_sf_mbsfn(grid, cell: Cell, non_mbsfn_region: int = 2,
                     *, normalize: bool = False):
    """MBSFN subframe modulation: grid [..., 12, nre] -> samples.

    Inverse of ofdm_rx_sf_mbsfn (srslte_ofdm_tx_slot_mbsfn): the first
    ``non_mbsfn_region`` symbols keep normal-CP lengths, the guard gap
    extends the first extended-CP symbol's cyclic prefix, the remaining
    symbols use extended CP. Total length = 12*(fft+cp_ext) =
    sf_sample_len.
    """
    from ..utils.scatter import place

    fft = cell.fft_size
    bins = _grid_to_bins(cell.nof_prb, reduced=cell.reduced_rates)
    spec = place(grid, bins, fft)
    sym = _sf_fft(spec, inverse=True)                       # [..., 12, fft]
    if normalize:
        sym = sym * np.float32(np.sqrt(fft))
    cp_norm = lambda i: (160 if i == 0 else 144) * fft // 2048
    cp_ext = 512 * fft // 2048
    guard = (non_mbsfn_region * cp_ext
             - sum(cp_norm(i) for i in range(non_mbsfn_region)))
    pieces = []
    for i in range(12):
        s = sym[..., i, :]
        if i < non_mbsfn_region:
            cp = cp_norm(i)
        elif i == non_mbsfn_region:
            cp = cp_ext + guard     # guard filled cyclically
        else:
            cp = cp_ext
        pieces.append(s[..., fft - cp :])
        pieces.append(s)
    return jnp.concatenate(pieces, axis=-1)


def freq_shift_half_subcarrier(samples, cell: Cell, direction: int = 1):
    """Multiply by exp(j*2*pi*0.5*n/fft): the UL half-subcarrier shift
    (ofdm.c:363-381). direction=+1 TX, -1 RX."""
    n = samples.shape[-1]
    ph = np.exp(direction * 2j * np.pi * 0.5 * np.arange(n) / cell.fft_size)
    return samples * jnp.asarray(ph.astype(np.complex64))
