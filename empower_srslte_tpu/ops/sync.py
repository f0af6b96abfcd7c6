"""Synchronization signals and estimators: PSS, SSS, CFO.

Capability parity with lib/src/phy/sync/: Zadoff-Chu PSS generation and
FFT-convolution detection (pss.c:354,457-541), SSS m0/m1 m-sequence
generation and detection (gen_sss.c:115-162, find_sss.c:91-178,
sss.c:132-152), CFO estimation from PSS half-symbol correlation
(pss.c:614-627) and CP autocorrelation (cp.c:66), CFO correction by
complex-exponential multiply (cfo.c:97).

Batched design: PSS search is one batched FFT convolution over
subframe windows; SSS detection is a single [hypotheses x 62] matmul over
all 336 (N_id_1, subframe) candidates instead of the reference's
three-stage partial correlations.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.cell import CP as _CP, Cell

CP_NORM = _CP.NORM
CP_EXT = _CP.EXT

#: PSS Zadoff-Chu root per N_id_2 (36.211 Table 6.11.1.1-1).
PSS_ROOTS = (25, 29, 34)
#: PSS/SSS occupy 62 subcarriers around DC.
SYNC_LEN = 62


# --- PSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def pss_freq(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 (36.211 6.11.1.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    top = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    bot = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return np.concatenate([top, bot]).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def pss_time(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica: 62 subcarriers around DC -> IFFT
    (pss.c srslte_pss_generate + ifft; used as the matched filter)."""
    spec = np.zeros(fft_size, np.complex64)
    d = pss_freq(n_id_2)
    spec[fft_size - 31 : fft_size] = d[:31]
    spec[1:32] = d[31:]
    t = np.fft.ifft(spec).astype(np.complex64)
    return t / np.linalg.norm(t)


def pss_find(samples, fft_size: int = 128):
    """Batched PSS search over all 3 roots.

    samples [..., N] -> (corr_mag [..., 3, N], peak_pos [..., 3],
    peak_to_sidelobe [..., 3]). Cross-correlation via the frequency
    domain like srslte_pss_find_pss (pss.c:457-541); the peak index is
    the START of the PSS data region (its FFT portion, after the CP).
    """
    n = samples.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(n + fft_size)))
    filt = np.stack([
        np.conj(np.fft.fft(pss_time(r, fft_size), nfft)) for r in range(3)
    ])                                                   # [3, nfft]
    spec = jnp.fft.fft(samples, nfft, axis=-1)[..., None, :]
    corr = jnp.fft.ifft(spec * jnp.asarray(filt), axis=-1)[..., :n]
    mag = jnp.abs(corr)
    peak = jnp.argmax(mag, axis=-1)
    pk = jnp.max(mag, axis=-1)
    mean = jnp.mean(mag, axis=-1)
    psr = pk / jnp.maximum(mean, 1e-12)
    return mag, peak, psr


def pss_cfo_estimate(samples, peak_start, n_id_2, fft_size: int = 128,
                     srate: float | None = None):
    """CFO from the phase between the two PSS half-symbol correlations
    (pss.c:614-627). ``peak_start`` = index of the first PSS data sample.

    Returns CFO normalized to subcarrier spacing (multiply by 15e3 for Hz).
    """
    half = fft_size // 2
    idx = peak_start[..., None] + np.arange(fft_size)
    seg = jnp.take_along_axis(samples, idx, axis=-1)
    replica = jnp.asarray(pss_time(n_id_2, fft_size))
    prod = seg * jnp.conj(replica)
    c0 = jnp.sum(prod[..., :half], axis=-1)
    c1 = jnp.sum(prod[..., half:], axis=-1)
    # phase drift over half a symbol = pi * cfo (in subcarrier units)
    return jnp.angle(c1 * jnp.conj(c0)) / jnp.pi


def cfo_correct(samples, cfo, fft_size: int):
    """Multiply by exp(-j 2 pi cfo n / fft) (srslte_cfo_correct, cfo.c:97).

    cfo in subcarrier-spacing units; broadcasts over leading dims.
    """
    n = np.arange(samples.shape[-1])
    ph = jnp.exp(-2j * np.pi * jnp.asarray(cfo)[..., None] * n / fft_size)
    return samples * ph.astype(samples.dtype)


def cp_cfo_estimate(samples, cell: Cell):
    """Coarse CFO from CP autocorrelation r(t) r*(t+N) (cp.c:66,
    sync.c:474-481). Returns subcarrier-normalized CFO [...]."""
    fft = cell.fft_size
    cps = cell.cp_len_slot
    acc = None
    pos = 0
    for rep in range(2 * cell.nsymb_slot):
        cp_len = cps[rep % cell.nsymb_slot]
        a = samples[..., pos : pos + cp_len]
        b = samples[..., pos + fft : pos + fft + cp_len]
        c = jnp.sum(a * jnp.conj(b), axis=-1)
        acc = c if acc is None else acc + c
        pos += cp_len + fft
    return -jnp.angle(jnp.conj(acc)) / (2 * np.pi)


# --- SSS --------------------------------------------------------------------


def _mseq(taps: tuple[int, ...]) -> np.ndarray:
    """Length-31 m-sequence ±1 from x(i+5) = sum(taps) with x=...00001."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = np.sum(x[np.array(taps) + i]) % 2
    return (1 - 2 * x).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _sss_bases():
    s_t = _mseq((2, 0))      # s~: x5 = x2 + x0
    c_t = _mseq((3, 0))      # c~: x5 = x3 + x0
    z_t = _mseq((4, 2, 1, 0))  # z~: x5 = x4 + x2 + x1 + x0
    return s_t, c_t, z_t


def _m0m1(n_id_1: int) -> tuple[int, int]:
    """m0/m1 from N_id_1 (36.211 Table 6.11.2.1-1 generation rule)."""
    q_prime = n_id_1 // 30
    q = (n_id_1 + q_prime * (q_prime + 1) // 2) // 30
    m_prime = n_id_1 + q * (q + 1) // 2
    m0 = m_prime % 31
    m1 = (m0 + m_prime // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=2048)
def sss_freq(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """SSS d(n), length 62, for subframe 0 or 5 (36.211 6.11.2.1)."""
    assert sf_idx in (0, 5)
    s_t, c_t, z_t = _sss_bases()
    m0, m1 = _m0m1(n_id_1)
    if sf_idx == 5:
        m0, m1 = m1, m0
    n = np.arange(31)
    s0 = s_t[(n + m0) % 31]
    s1 = s_t[(n + m1) % 31]
    c0 = c_t[(n + n_id_2) % 31]
    c1 = c_t[(n + n_id_2 + 3) % 31]
    z1 = z_t[(n + (m0 % 8)) % 31]
    d = np.empty(62, np.float32)
    d[0::2] = s0 * c0
    d[1::2] = s1 * c1 * z1
    return d.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _sss_table(n_id_2: int) -> np.ndarray:
    """[2*168, 62] hypothesis matrix: rows = (sf in {0,5}) x N_id_1."""
    rows = []
    for sf in (0, 5):
        for nid1 in range(168):
            rows.append(sss_freq(nid1, n_id_2, sf))
    return np.stack(rows).astype(np.complex64)


def sss_detect(sss_re, n_id_2: int):
    """Detect N_id_1 and frame half from the equalized 62-RE SSS symbol.

    sss_re [..., 62] -> (n_id_1 [...], sf_is_5 [...], metric [...]).
    One correlation matmul against all 336 hypotheses (replacing
    find_sss.c's partial correlation stages), at full float32 precision
    (a GPU would otherwise take it in TF32).
    """
    table = jnp.asarray(_sss_table(n_id_2))              # [336, 62]
    corr = jnp.einsum("...k,hk->...h", sss_re, jnp.conj(table),
                      precision=jax.lax.Precision.HIGHEST)
    mag = jnp.abs(corr)
    best = jnp.argmax(mag, axis=-1)
    power = jnp.sum(jnp.abs(sss_re) ** 2, axis=-1) * SYNC_LEN
    metric = jnp.max(mag, axis=-1) / jnp.maximum(jnp.sqrt(power), 1e-12)
    return best % 168, best >= 168, metric


def sync_re_indices(cell: Cell) -> np.ndarray:
    """Subcarrier indices of the central 62 sync REs in the cell grid."""
    mid = cell.nof_re // 2
    return np.arange(mid - 31, mid + 31)


def detect_cp(samples, nof_prb: int):
    """Detect normal vs extended CP from one subframe of aligned samples
    (the Kim et al. correlation test, sync.c:377-432): compare the CP
    autocorrelation energy under both hypotheses.

    Returns (is_normal [...], metric_norm [...], metric_ext [...]).
    """
    norm = Cell(nof_prb=nof_prb, id=0, cp=CP_NORM)
    ext = Cell(nof_prb=nof_prb, id=0, cp=CP_EXT)

    def energy(cell):
        fft = cell.fft_size
        cps = cell.cp_len_slot
        acc = None
        pos = 0
        for rep in range(2 * cell.nsymb_slot):
            cp_len = cps[rep % cell.nsymb_slot]
            a = samples[..., pos : pos + cp_len]
            b = samples[..., pos + fft : pos + fft + cp_len]
            c = jnp.abs(jnp.sum(a * jnp.conj(b), axis=-1))
            acc = c if acc is None else acc + c
            pos += cp_len + fft
        return acc

    m_norm = energy(norm)
    m_ext = energy(ext)
    return m_norm >= m_ext, m_norm, m_ext


def sfo_estimate(peak_positions, frame_len: int):
    """Sampling frequency offset from PSS peak drift across frames
    (sfo.c analog): peaks [..., n_frames] -> SFO in samples/frame."""
    n = peak_positions.shape[-1]
    x = jnp.arange(n, dtype=jnp.float32)
    y = (peak_positions - peak_positions[..., :1]).astype(jnp.float32)
    y = y - jnp.round(y / frame_len) * frame_len  # unwrap frame jumps
    xm = x - jnp.mean(x)
    return jnp.sum(xm * y, axis=-1) / jnp.maximum(jnp.sum(xm * xm), 1e-9)
