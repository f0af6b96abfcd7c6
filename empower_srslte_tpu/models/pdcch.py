"""PDCCH: downlink control channel with blind decoding (36.211 6.8,
36.212 5.3.3, 36.213 9.1.1).

Capability parity with lib/src/phy/phch/pdcch.c: DCI CRC16-RNTI masking,
tail-biting convolutional coding, rate matching to the CCE aggregation,
control-region scrambling, REG mapping (via models/regs.py), LLR
extraction of the whole region once (srslte_pdcch_extract_llr_multi) and
blind search over candidate locations/formats (pdcch.c:341) — here every
candidate of an aggregation level decodes as one Viterbi batch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.fec.convcoder import conv_encode, viterbi_decode
from ..ops.fec.rm_conv import rm_conv_rx, rm_conv_tx
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs
from ..utils.bits import uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.sequence import cinit_pdcch
from .regs import RE_PER_CCE, pdcch_nof_cces, pdcch_reg_map

#: Bits per CCE (36 QPSK REs).
BITS_PER_CCE = 2 * RE_PER_CCE


def _region_re_indices(cell: Cell, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Flat RE indices of the PDCCH region, quadruplet order, [n_regs*4]."""
    return pdcch_reg_map(cell, cfi, ng).reshape(-1)


def ue_search_candidates(rnti: int, sf_idx: int, n_cce: int):
    """(L, cce) candidates: common + UE-specific (36.213 9.1.1)."""
    out = []
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            cce = m * l
            if cce + l <= n_cce:
                out.append((l, cce))
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce // l == 0:
            continue
        for m in range(m_max):
            cce = l * ((y + m) % (n_cce // l))
            if cce + l <= n_cce:
                out.append((l, cce))
    # dedupe preserving order
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def pdcch_encode(dci_bits, rnti: int, cce: int, l: int, cell: Cell,
                 cfi: int, sf_idx: int, ng: float = 1.0):
    """One DCI -> grid contribution [..., P, nsymb, nre] on port 0.

    The region scrambling sequence offset follows the CCE position so
    independent PDCCHs compose additively.
    """
    e = l * BITS_PER_CCE
    crc = CRC16.jnp_compute(dci_bits).astype(jnp.int8)
    mask = jnp.asarray(uint_to_bits(rnti & 0xFFFF, 16))
    payload = jnp.concatenate(
        [dci_bits.astype(jnp.int8), jnp.bitwise_xor(crc, mask)], axis=-1)
    d = conv_encode(payload)
    coded = rm_conv_tx(d, e)

    # scramble with the region sequence at this candidate's bit offset
    from ..utils.sequence import gold_sequence

    seq = gold_sequence(cinit_pdcch(2 * sf_idx, cell.id),
                        (cce + l) * BITS_PER_CCE)[cce * BITS_PER_CCE:]
    coded = jnp.bitwise_xor(coded, jnp.asarray(seq))
    syms = modulate(coded, Mod.QPSK)

    from ..utils.scatter import place

    idx_all = _region_re_indices(cell, cfi, ng)
    idx = idx_all[cce * RE_PER_CCE : (cce + l) * RE_PER_CCE]
    lead = syms.shape[:-1]
    flat_len = cell.nsymb_sf * cell.nof_re
    if cell.nof_ports >= 2:
        # 2-port SFBC over the candidate's REs (pdcch.c layer map +
        # diversity precoding; REG quadruplets pair cleanly)
        from ..ops.equalizer import precode_sfbc

        layers = jnp.stack([syms[..., 0::2], syms[..., 1::2]], axis=-2)
        ps = precode_sfbc(layers)
        planes = [place(ps[..., 0, :], idx, flat_len)[..., None, :],
                  place(ps[..., 1, :], idx, flat_len)[..., None, :]]
        if cell.nof_ports > 2:
            planes.append(jnp.zeros(
                (*lead, cell.nof_ports - 2, flat_len), jnp.complex64))
        grid = jnp.concatenate(planes, axis=-2)
    else:
        grid = place(syms, idx, flat_len)[..., None, :]
    return grid.reshape(*lead, cell.nof_ports, cell.nsymb_sf, cell.nof_re)


def pdcch_extract_llr(grid, h, cell: Cell, cfi: int, sf_idx: int,
                      noise_est=0.0, ng: float = 1.0):
    """Equalize + demap + descramble the whole region once
    (srslte_pdcch_extract_llr_multi): -> llr [..., n_cce*72].

    ``h``: [..., nsymb, nre] single-port or [..., P, nsymb, nre] for
    SFBC diversity cells."""
    idx = jnp.asarray(_region_re_indices(cell, cfi, ng))
    flat = grid.reshape(*grid.shape[:-2], -1)
    y = flat[..., idx]
    if h.ndim == grid.ndim + 1 and h.shape[-3] >= 2:
        from ..ops.equalizer import eq_sfbc

        hf = h.reshape(*h.shape[:-2], -1)
        h0 = hf[..., 0, :][..., idx]
        h1 = hf[..., 1, :][..., idx]
        x, csi = eq_sfbc(y[..., None, :], h0[..., None, :],
                         h1[..., None, :])
        llr = demod_soft(x, Mod.QPSK) * jnp.repeat(csi, 2, axis=-1)
    else:
        if h.ndim == grid.ndim + 1:
            h = h[..., 0, :, :]
        hf = h.reshape(*h.shape[:-2], -1)
        hh = hf[..., idx]
        x = y * jnp.conj(hh) / jnp.maximum(jnp.abs(hh) ** 2 + noise_est,
                                           1e-12)
        llr = demod_soft(x, Mod.QPSK) \
            * jnp.repeat(jnp.abs(hh) ** 2, 2, axis=-1)
    return descramble_llrs(llr, cinit_pdcch(2 * sf_idx, cell.id))


def pdcch_blind_bits(llr, cands, size: int):
    """Decode EVERY (L, cce) candidate for one DCI size as ONE Viterbi
    batch. De-rate-matching maps each candidate's e = L*72 segment to the
    common [3, k] trellis shape (k = size + 16), so candidates of every
    aggregation level concatenate along one batch axis and a single
    64-state register-exchange Viterbi decodes all of them.

    The reference loops candidate-by-candidate (pdcch.c:341
    dci_blind_search); one Viterbi per (L, size) pair would be 8
    sequential 165-step trellis decodes per subframe. One decode over a
    [n_cand * batch] axis does the same work in ~1/4 the steps.

    llr [..., n_cce*72] -> bits [..., n_cand, k], candidate order =
    ``cands`` order (grouped by L internally but restored).
    """
    k = size + 16
    by_l: dict[int, list[int]] = {}
    for l, cce in cands:
        by_l.setdefault(l, []).append(cce)
    parts, order = [], []
    for l, cces in by_l.items():
        e = l * BITS_PER_CCE
        seg = jnp.stack(
            [llr[..., c * BITS_PER_CCE : c * BITS_PER_CCE + e]
             for c in cces], axis=-2)                 # [..., nc_l, e]
        parts.append(rm_conv_rx(seg, k))              # [..., nc_l, 3, k]
        order.extend((l, c) for c in cces)
    x = jnp.concatenate(parts, axis=-3)               # [..., n_cand, 3, k]
    bits = viterbi_decode(x, wrap=1)                  # [..., n_cand, k]
    # restore caller's candidate order
    perm = [order.index(c) for c in cands]
    if perm != list(range(len(cands))):
        bits = bits[..., jnp.asarray(np.asarray(perm, np.int32)), :]
    return bits


@functools.lru_cache(maxsize=None)
def _blind_bits_jit(cands: tuple, size: int):
    """Cached jitted one-call-per-size blind decode (re-traced programs
    per (search space, size) would otherwise re-lower every TTI)."""
    import jax

    @jax.jit
    def f(llr):
        return pdcch_blind_bits(llr, list(cands), size)

    return f


@dataclass
class DciHit:
    payload: np.ndarray
    l: int
    cce: int
    rnti: int


def pdcch_blind_decode(grid, h, cell: Cell, cfi: int, sf_idx: int,
                       rnti: int, dci_sizes: tuple[int, ...],
                       noise_est=0.0, ng: float = 1.0,
                       llr=None) -> list[DciHit]:
    """Blind search for one RNTI over its search space.

    grid/h [nsymb, nre] (single subframe, single rx antenna). All
    candidates of one (L, size) pair decode as a single Viterbi batch.
    Returns every CRC-passing candidate.
    """
    n_cce = pdcch_nof_cces(cell, cfi, ng)
    if llr is None:
        llr = pdcch_extract_llr(grid, h, cell, cfi, sf_idx, noise_est, ng)
    cands = ue_search_candidates(rnti, sf_idx, n_cce)
    mask = uint_to_bits(rnti & 0xFFFF, 16)
    hits: list[DciHit] = []
    for size in dci_sizes:
        bits = np.asarray(_blind_bits_jit(tuple(cands), size)(llr))
        for row, (l, cce) in enumerate(cands):
            b = bits[row]
            unmasked = np.concatenate([b[:size], b[size:] ^ mask])
            if not np.any(CRC16.compute(unmasked)):
                hits.append(DciHit(b[:size].astype(np.int8), l, cce, rnti))
    # dedupe identical payloads found at nested aggregations
    seen, uniq = set(), []
    for hitem in hits:
        key = hitem.payload.tobytes()
        if key not in seen:
            seen.add(key)
            uniq.append(hitem)
    return uniq
