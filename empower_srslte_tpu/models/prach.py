"""PRACH: random access preambles (36.211 5.7), formats 0-4 with
unrestricted and restricted (high-speed) cyclic-shift sets.

Capability parity with lib/src/phy/phch/prach.c: the T_cp/T_seq format
tables (prach.c:56-61), N_cs tables for unrestricted/restricted/format-4
sets (prach.c:63-71), Zadoff-Chu root sequence orders for formats 0-3
and format 4 (prach.c:74-167, binary spec data in data/), the
restricted-set shift layout d_u -> (N_shift, d_start, N_group,
N_neg_shift) (prach.c:266-330 gen_seqs), preamble generation
(prach.c:519), and frequency-domain detection — N_zc-point correlation
against candidate roots, IDFT, peak search over the per-preamble shift
zones returning preamble index and timing offset (prach_detect_offset,
prach.c:575-677).

Batched shape: generation is a host-side table build (one IFFT); the
hot path is detection, expressed as batched FFT -> gather -> conj-mul ->
IFFT -> zone max over the whole subframe batch.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

import jax.numpy as jnp

from ..utils.cell import Cell

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"

#: ZC sequence length, preamble formats 0-3 / format 4.
NZC = 839
NZC_F4 = 139
#: Reference sample period: 30.72 Msps.
TS_RATE = 30_720_000
#: T_cp per preamble format, in Ts units (36.211 Table 5.7.1-1).
TCP_TS = (3168, 21024, 6240, 21024, 448)
#: T_seq per preamble format, in Ts units.
TSEQ_TS = (24576, 24576, 2 * 24576, 2 * 24576, 4096)
#: N_cs, unrestricted sets (36.211 Table 5.7.2-2, zeroCorrelationZoneConfig).
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                    167, 279, 419)
#: N_cs, restricted sets (36.211 Table 5.7.2-2 high-speed column).
NCS_RESTRICTED = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158,
                  202, 237)
#: N_cs for preamble format 4 (36.211 Table 5.7.2-3).
NCS_FORMAT4 = (2, 4, 6, 8, 10, 12, 15)
#: Sequence duration for format 0 (0.8 ms) as a fraction of a subframe.
SEQ_DURATION = 0.0008


def preamble_format(config_idx: int) -> int:
    """prach-ConfigIndex -> preamble format (36.211 Table 5.7.1-2;
    prach.c srslte_prach_get_preamble_format)."""
    return config_idx // 16


@functools.lru_cache(maxsize=2)
def root_table(fmt: int = 0) -> np.ndarray:
    """Logical -> physical root sequence index (36.211 Table 5.7.2-4,
    Table 5.7.2-5 for format 4)."""
    if fmt == 4:
        return np.load(_DATA / "prach_root_seq_f4.npy")
    return np.load(_DATA / "prach_root_seq.npy")


def _nzc(fmt: int) -> int:
    return NZC_F4 if fmt == 4 else NZC


def n_cs(zcz: int, fmt: int = 0, high_speed: bool = False) -> int:
    if fmt == 4:
        return NCS_FORMAT4[zcz]
    return (NCS_RESTRICTED[zcz] if high_speed
            else NCS_UNRESTRICTED[zcz])


@functools.lru_cache(maxsize=2048)
def zc_root(u: int, nzc: int = NZC) -> np.ndarray:
    """x_u(n) = exp(-j pi u n (n+1) / nzc)."""
    n = np.arange(nzc)
    return np.exp(-1j * np.pi * u * n * (n + 1) / nzc).astype(np.complex64)


@functools.lru_cache(maxsize=256)
def restricted_params(u: int, ncs: int, nzc: int = NZC):
    """Restricted-set shift layout for root u (36.211 5.7.2;
    prach.c:266-305): -> (n_shift, d_start, n_group, n_neg_shift,
    v_max)."""
    p_ = pow(u, -1, nzc)                    # u * p == 1 mod nzc
    d_u = p_ if p_ < nzc // 2 else nzc - p_
    if ncs <= d_u < nzc // 3:
        n_shift = d_u // ncs
        d_start = 2 * d_u + n_shift * ncs
        n_group = nzc // d_start
        n_neg = max(0, (nzc - 2 * d_u - n_group * d_start) // ncs) \
            if nzc > 2 * d_u + n_group * d_start else 0
    elif nzc // 3 <= d_u <= (nzc - ncs) // 2:
        n_shift = (nzc - 2 * d_u) // ncs
        d_start = nzc - 2 * d_u + n_shift * ncs
        n_group = d_u // d_start
        n_neg = min(n_shift,
                    max(0, (d_u - n_group * d_start) // ncs)
                    if d_u > n_group * d_start else 0)
    else:
        return 0, 0, 0, 0, 0
    v_max = max(0, n_shift * n_group + n_neg - 1)
    return n_shift, d_start, n_group, n_neg, v_max


@functools.lru_cache(maxsize=512)
def preamble_table(rsi: int, zcz: int, fmt: int = 0,
                   high_speed: bool = False) -> tuple:
    """The 64 preambles as ((u, C_v) ...), walking logical roots and
    their shifts exactly like the reference's gen_seqs loop
    (prach.c:235-330)."""
    nzc = _nzc(fmt)
    ncs = n_cs(zcz, fmt, high_speed)
    table = []
    roots = root_table(fmt)
    nroots = len(roots)
    r = 0
    while len(table) < 64 and r < nroots:
        u = int(roots[(rsi + r) % nroots])
        if high_speed and fmt != 4:
            n_shift, d_start, _, _, v_max = restricted_params(u, ncs, nzc)
            for v in range(v_max + 1):
                cv = 0 if n_shift == 0 else (
                    d_start * (v // n_shift) + (v % n_shift) * ncs)
                table.append((u, cv))
                if len(table) == 64:
                    break
        else:
            v_max = (nzc // ncs - 1) if ncs else 0
            for v in range(v_max + 1):
                table.append((u, v * ncs))
                if len(table) == 64:
                    break
        r += 1
    return tuple(table)


def preamble_freq(rsi: int, preamble_idx: int, zcz: int = 1, fmt: int = 0,
                  high_speed: bool = False) -> np.ndarray:
    """Frequency-domain preamble (N_zc bins) for (root-seq index, index).

    ``rsi``: logical root sequence index (cell config); ``zcz``:
    zero-correlation-zone config -> N_cs. Preambles first sweep cyclic
    shifts of a root, then consecutive roots (36.211 5.7.2); restricted
    sets use the d_u-dependent shift layout.
    """
    nzc = _nzc(fmt)
    u, cv = preamble_table(rsi, zcz, fmt, high_speed)[preamble_idx]
    xv = np.roll(zc_root(u, nzc), -cv)
    return np.fft.fft(xv).astype(np.complex64) / np.sqrt(nzc)


def prach_seq_len(cell: Cell, fmt: int = 0) -> int:
    """Samples in one sequence period at the cell rate (0.8 ms for
    formats 0-3; 133.3 us for format 4)."""
    period_ts = 24576 if fmt != 4 else 4096
    return int(round(cell.srate * period_ts / TS_RATE))


def prach_cp_len(cell: Cell, fmt: int = 0) -> int:
    return int(round(cell.srate * TCP_TS[fmt] / TS_RATE))


def prach_total_len(cell: Cell, fmt: int = 0) -> int:
    """CP + full sequence (with repetition for formats 2/3)."""
    reps = 2 if fmt in (2, 3) else 1
    return prach_cp_len(cell, fmt) + reps * prach_seq_len(cell, fmt)


def prach_freq_bins(cell: Cell, freq_offset_prb: int = 0,
                    fmt: int = 0) -> np.ndarray:
    """Bins of the length-(seq_len) DFT carrying the N_zc ZC subcarriers.

    Formats 0-3: 1.25 kHz spacing (K=12), phi=7 guard bins; format 4:
    7.5 kHz spacing (K=2), phi=2 (36.211 5.7.3).
    """
    seq_len = prach_seq_len(cell, fmt)
    nzc = _nzc(fmt)
    k_ratio, phi = (2, 2) if fmt == 4 else (12, 7)
    sc_from_dc = 12 * freq_offset_prb - cell.nof_re // 2
    first = k_ratio * sc_from_dc + phi
    return (np.arange(nzc) + first) % seq_len


def prach_gen(cell: Cell, rsi: int, preamble_idx: int, zcz: int = 1,
              freq_offset_prb: int = 0, cp_len: int | None = None,
              fmt: int = 0, high_speed: bool = False) -> np.ndarray:
    """Time-domain preamble at the cell sampling rate: CP + sequence
    (repeated twice for formats 2/3)."""
    seq_len = prach_seq_len(cell, fmt)
    spec = np.zeros(seq_len, np.complex64)
    spec[prach_freq_bins(cell, freq_offset_prb, fmt)] = preamble_freq(
        rsi, preamble_idx, zcz, fmt, high_speed)
    t = np.fft.ifft(spec).astype(np.complex64) * np.sqrt(seq_len)
    if fmt in (2, 3):
        t = np.concatenate([t, t])
    if cp_len is None:
        cp_len = prach_cp_len(cell, fmt)
    return np.concatenate([t[-cp_len:], t])


def _detect_zones(rsi: int, zcz: int, fmt: int, high_speed: bool):
    """Per-preamble (root u, peak window start, window length) in the
    delay domain: preamble with shift C_v peaks at lag (N_zc - C_v)."""
    nzc = _nzc(fmt)
    ncs = n_cs(zcz, fmt, high_speed)
    zone_len = ncs if ncs else nzc
    out = []
    for u, cv in preamble_table(rsi, zcz, fmt, high_speed):
        out.append((u, (nzc - cv) % nzc, zone_len))
    return out


def prach_detect(samples, cell: Cell, rsi: int, zcz: int = 1,
                 freq_offset_prb: int = 0, nof_roots: int | None = None,
                 threshold: float = 13.0, fmt: int = 0,
                 high_speed: bool = False):
    """Detect preambles in a window starting at the sequence position.

    samples [..., >= seq_len] -> (detected [..., 64] bool,
    offsets [..., 64] samples, metric [..., 64]). Correlates against the
    candidate roots, IFFTs to the delay domain, and takes peaks per
    shift zone (prach_detect_offset analog). Formats 2/3 coherently
    average the two sequence repetitions before correlating.

    ``threshold`` is peak-to-profile-mean: noise-only bins are ~Exp(mean),
    so over N_zc delay bins the false-alarm rate is ~N_zc*exp(-t); t=13
    keeps it < 0.2% per root while a real preamble's coherent gain
    (~N_zc) clears it by an order of magnitude.
    """
    nzc = _nzc(fmt)
    seq_len = prach_seq_len(cell, fmt)
    win = samples[..., :seq_len]
    if fmt in (2, 3) and samples.shape[-1] >= 2 * seq_len:
        # average the repetition: +3 dB coherent gain
        win = 0.5 * (win + samples[..., seq_len : 2 * seq_len])
    spec = jnp.fft.fft(win, axis=-1)
    bins = jnp.asarray(prach_freq_bins(cell, freq_offset_prb, fmt))
    x = spec[..., bins] / np.sqrt(seq_len)

    zones = _detect_zones(rsi, zcz, fmt, high_speed)
    # delay profile per distinct root (batched conj-mul + IFFT)
    dets, offs, mets = [], [], []
    profiles: dict[int, tuple] = {}
    for u, start, zone_len in zones:
        if u not in profiles:
            zf = jnp.asarray(np.conj(
                np.fft.fft(zc_root(u, nzc)) / np.sqrt(nzc)))
            corr = jnp.fft.ifft(x * zf, axis=-1)
            p = jnp.abs(corr) ** 2
            profiles[u] = (p, jnp.mean(p, axis=-1, keepdims=True))
        p, mean = profiles[u]
        zidx = jnp.asarray((start + np.arange(zone_len)) % nzc)
        zone = p[..., zidx]
        pk = jnp.max(zone, axis=-1)
        delay = jnp.argmax(zone, axis=-1)
        m = pk / jnp.maximum(mean[..., 0], 1e-20)
        dets.append(m > threshold)
        offs.append(delay * seq_len // nzc)
        mets.append(m)
    return (jnp.stack(dets, axis=-1), jnp.stack(offs, axis=-1),
            jnp.stack(mets, axis=-1))
