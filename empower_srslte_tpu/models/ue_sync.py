"""UE synchronization driver: file-mode subframe alignment and cell search.

Capability parity with lib/src/phy/ue/ue_sync.c (the FIND->TRACK state
machine, file mode at ue_sync.c:675-707) and ue_cell_search.c (scan all 3
N_id_2, vote, return the strongest cell).

Batched design: instead of a real-time state machine, a recorded (or
streamed) IQ buffer is aligned in one shot — batched PSS correlation over
the whole capture, SSS hypothesis matmul for identity/frame timing, CFO
estimate/correct — then reshaped into a [nof_sf, sf_len] subframe batch
for the downstream batched pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.ofdm import ofdm_rx_sf
from ..ops.sync import (
    cfo_correct,
    pss_cfo_estimate,
    pss_find,
    sss_detect,
    sync_re_indices,
)
from ..utils.cell import Cell

#: jitted stage cache (compiled graphs embed the PSS/SSS complex
#: constants)
_jit_cache: dict = {}


def _jit(key, make):
    if key not in _jit_cache:
        import jax

        _jit_cache[key] = jax.jit(make())
    return _jit_cache[key]


@dataclass
class SyncResult:
    """Outcome of cell search + alignment on a capture."""

    cell_id: int
    n_id_2: int
    sf0_offset: int          # sample index where subframe 0 starts
    cfo: float               # subcarrier-normalized CFO estimate
    metric: float            # SSS correlation metric
    subframes: object        # [nof_sf, sf_sample_len] aligned, CFO-corrected


def pss_start_to_sf_start(peak_start: int, cell: Cell) -> int:
    """The PSS data region ends the last symbol of slot 0: the subframe
    starts one slot length before that end."""
    slot_len = cell.sf_sample_len // 2
    return peak_start + cell.fft_size - slot_len


def sync_and_align(samples, cell_prb: int, max_id2_scan: int = 3,
                   exclude_id2: tuple = ()) -> SyncResult:
    """Find the cell in a raw capture and return aligned subframes.

    ``samples``: 1-D complex64 at the standard rate for ``cell_prb``.
    Searches PSS over the first 10 ms for each N_id_2 hypothesis, picks
    the strongest (ue_cell_search.c:249's vote collapses to an argmax over
    batched correlations here), estimates CFO from the PSS symbol,
    corrects it, decodes SSS to fix N_id_1 and half-frame timing.
    ``exclude_id2``: N_id_2 roots to skip — cells found earlier but
    rejected by PLMN / S-criterion checks (srsue rrc.cc plmn_search walks
    on to the next candidate the same way).
    """
    cell_probe = Cell(nof_prb=cell_prb, id=0)
    fft = cell_probe.fft_size
    sf_len = cell_probe.sf_sample_len
    frame = 10 * sf_len
    assert samples.shape[-1] >= frame + sf_len, "need > 1 frame of samples"

    from ..utils import device_complex

    samples = device_complex(samples)
    window = samples[: frame + fft]
    find = _jit(("pss_find", fft, int(window.shape[-1])),
                lambda: lambda w: pss_find(w[None], fft))
    mag, peak, psr = find(window)                        # [1, 3, N]
    psr_np = np.asarray(psr[0]).copy()
    for i in exclude_id2:
        psr_np[int(i)] = -np.inf
    n_id_2 = int(np.argmax(psr_np))
    peak_start = int(np.asarray(peak[0, n_id_2]))

    est = _jit(("pss_cfo", fft, n_id_2, int(window.shape[-1])),
               lambda: lambda w, p: pss_cfo_estimate(w[None], p, n_id_2,
                                                     fft)[0])
    cfo = float(np.asarray(est(window, jnp.asarray([peak_start]))))
    corr = _jit(("cfo_corr", fft, int(samples.shape[-1])),
                lambda: lambda s, c: cfo_correct(s, c, fft))
    corrected = corr(samples, cfo)

    # tentative subframe start (could be sf 0 or sf 5)
    start = pss_start_to_sf_start(peak_start, cell_probe)
    if start < 0:
        start += sf_len * 5
    # demodulate that subframe, read the SSS symbol
    sf = corrected[start : start + sf_len]

    def _make_sss():
        from ..ops.sync import pss_freq

        def f(sf):
            grid = ofdm_rx_sf(sf[None], cell_probe)[0]
            k = jnp.asarray(sync_re_indices(cell_probe))
            nsym = cell_probe.nsymb_slot
            # equalize SSS against the PSS-derived channel: both share
            # the 62 REs; coherent detection with PSS as phase reference
            pss_re = grid[nsym - 1, k]
            h = pss_re * jnp.conj(jnp.asarray(pss_freq(n_id_2)))
            sss_re = grid[nsym - 2, k] * jnp.conj(h)                 / jnp.maximum(jnp.abs(h) ** 2, 1e-12)
            return sss_detect(sss_re[None], n_id_2)

        return f

    n_id_1, is_sf5, metric = _jit(
        ("sss", repr(cell_probe), n_id_2), _make_sss)(sf)
    n_id_1 = int(np.asarray(n_id_1[0]))
    sf0 = start + (5 * sf_len if bool(np.asarray(is_sf5[0])) else 0)
    sf0 = sf0 % frame

    nof = (samples.shape[-1] - sf0) // sf_len
    sub = corrected[sf0 : sf0 + nof * sf_len].reshape(nof, sf_len)
    return SyncResult(
        cell_id=3 * n_id_1 + n_id_2,
        n_id_2=n_id_2,
        sf0_offset=sf0,
        cfo=cfo,
        metric=float(np.asarray(metric[0])),
        subframes=sub,
    )


def sfo_estimate(samples, n_id_2: int, cell_prb: int,
                 max_windows: int = 16) -> dict:
    """Sample-frequency-offset estimate from PSS peak drift.

    Parity with sfo.c (srslte_sfo_estimate: least-squares slope of the
    PSS timing offsets t0 over successive half-frames) and the SFO
    feedback in ue_sync.c's TRACK loop. Batched: the capture is cut
    into 5 ms windows, one batched PSS correlation finds every peak at
    once, and the slope comes from a closed-form least-squares fit.

    Returns dict(sfo_hz, drift_samples_per_frame, positions).
    sfo_hz is the sampling-clock offset: +1 Hz means the transmitter
    clock runs 1 sample/second faster than the receiver's.
    """
    from ..ops.sync import pss_find
    from ..utils import device_complex

    cell = Cell(nof_prb=cell_prb, id=0)
    half_frame = 5 * cell.sf_sample_len
    n_win = min(max_windows, samples.shape[-1] // half_frame)
    assert n_win >= 2, "need >= 2 half-frames for a drift estimate"
    wins = np.stack([np.asarray(samples[i * half_frame:(i + 1) * half_frame])
                     for i in range(n_win)])
    find = _jit(("sfo_pss", cell.fft_size, n_win, half_frame),
                lambda: lambda w: pss_find(w, cell.fft_size))
    _mag, peaks, _psr = find(device_complex(wins))
    pos = np.asarray(peaks)[:, n_id_2].astype(np.float64)
    # unwrap window-relative positions: a peak drifting past the window
    # edge wraps by half_frame
    pos = np.unwrap(pos * 2 * np.pi / half_frame) * half_frame / (2 * np.pi)
    # least squares slope: samples of drift per half-frame (sfo.c:34-55)
    x = np.arange(n_win)
    slope = (np.mean(x * pos) - np.mean(x) * np.mean(pos)) / \
        (np.mean(x * x) - np.mean(x) ** 2)
    srate = cell.srate_hz if hasattr(cell, "srate_hz") else \
        cell.sf_sample_len * 1000.0
    sfo_hz = slope / 5e-3          # samples per second of clock drift
    return dict(sfo_hz=sfo_hz,
                drift_samples_per_frame=2 * slope,
                positions=pos,
                srate_hz=srate)


def cell_search_vote(samples, cell_prb: int = 6, max_frames: int = 3):
    """Scan all 3 N_id_2 over several frames and vote for the strongest
    cell (srslte_ue_cellsearch_scan, ue_cell_search.c:249).

    Returns (n_id_2, votes dict, mean peak-to-sidelobe per root).
    """
    cell = Cell(nof_prb=cell_prb, id=0)
    frame = 10 * cell.sf_sample_len
    n_frames = min(max_frames, samples.shape[-1] // frame)
    assert n_frames >= 1, "need at least one frame"
    wins = jnp.asarray(
        np.stack([samples[i * frame : (i + 1) * frame]
                  for i in range(n_frames)]))
    _, peaks, psr = pss_find(wins, cell.fft_size)       # [F, 3]
    psr_np = np.asarray(psr)
    votes: dict[int, int] = {0: 0, 1: 0, 2: 0}
    for f in range(n_frames):
        votes[int(np.argmax(psr_np[f]))] += 1
    best = max(votes, key=votes.get)
    return best, votes, psr_np.mean(axis=0)
