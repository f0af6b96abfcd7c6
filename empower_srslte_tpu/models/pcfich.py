"""PCFICH: control format indicator channel (36.211 6.7, 36.212 5.3.4).

Capability parity with lib/src/phy/phch/pcfich.c: the 3 fixed 32-bit CFI
codewords, scrambling, QPSK, mapping to 4 quarter-spaced REGs of symbol 0;
decoding by correlating the received soft bits against the 3 codewords
(pcfich.c decode).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..utils.cell import Cell
from ..utils.sequence import cinit_pcfich
from .regs import pcfich_regs, symbol_regs

#: CFI codewords (36.212 Table 5.3.4-1): periodic 011/101/110 patterns.
CFI_CODEWORDS = np.array(
    [np.tile([0, 1, 1], 11)[:32], np.tile([1, 0, 1], 11)[:32],
     np.tile([1, 1, 0], 11)[:32]], dtype=np.int8)


def _re_indices(cell: Cell) -> np.ndarray:
    regs0 = symbol_regs(cell, 0)
    idx = []
    for r in pcfich_regs(cell):
        idx.extend(regs0[r])       # symbol 0 -> flat index = subcarrier
    return np.asarray(idx, np.int32)


def pcfich_put(grid, cfi: int, cell: Cell, sf_idx: int):
    """Insert the CFI codeword into the grid [..., P, nsymb, nre] —
    single port, 2-port SFBC or 4-port SFBC-FSTD per the cell
    (srslte_pcfich_encode applies layer map + diversity precoding)."""
    from ..ops.equalizer import precode_sfbc, precode_sfbc_fstd
    from ..utils.scatter import overlay

    bits = jnp.asarray(CFI_CODEWORDS[cfi - 1])
    scr = scramble_bits(bits, cinit_pcfich(2 * sf_idx, cell.id))
    syms = modulate(scr, Mod.QPSK)
    p = cell.nof_ports
    if p == 1:
        port_syms = [syms]
    elif p == 2:
        layers = jnp.stack([syms[0::2], syms[1::2]], axis=-2)
        ps = precode_sfbc(layers)
        port_syms = [ps[..., 0, :], ps[..., 1, :]]
    else:
        layers = jnp.stack([syms[0::4], syms[1::4], syms[2::4],
                            syms[3::4]], axis=-2)
        ps = precode_sfbc_fstd(layers)
        port_syms = [ps[..., i, :] for i in range(4)]
    idx = _re_indices(cell)  # symbol-0 REs: flat index == subcarrier
    lead = grid.shape[:-3]
    flat = grid.reshape(*lead, grid.shape[-3], -1)
    planes = [overlay(flat[..., i, :], port_syms[i], idx)[..., None, :]
              if i < len(port_syms) else flat[..., i : i + 1, :]
              for i in range(grid.shape[-3])]
    flat = jnp.concatenate(planes, axis=-2)
    return flat.reshape(grid.shape)


def pcfich_decode(grid, h, cell: Cell, sf_idx: int, noise_est=0.0):
    """Decode CFI -> (cfi [...], corr [...]).

    grid [..., nsymb, nre]; h [..., nsymb, nre] (single port) or
    [..., P, nsymb, nre] (diversity cells). MRC / SFBC combining then
    correlation against the 3 codewords (srslte_pcfich_decode)."""
    from ..ops.equalizer import eq_sfbc, eq_sfbc_fstd

    idx = jnp.asarray(_re_indices(cell))
    y = grid[..., 0, :][..., idx]
    has_ports = h.ndim == grid.ndim + 1
    if not has_ports or h.shape[-3] == 1:
        hh = (h[..., 0, 0, :] if has_ports else h[..., 0, :])[..., idx]
        x = y * jnp.conj(hh) / jnp.maximum(jnp.abs(hh) ** 2 + noise_est,
                                           1e-12)
    else:
        hp = [h[..., p, 0, :][..., idx] for p in range(h.shape[-3])]
        if h.shape[-3] == 2:
            x, _csi = eq_sfbc(y[..., None, :], hp[0][..., None, :],
                              hp[1][..., None, :])
        else:
            x, _csi = eq_sfbc_fstd(y[..., None, :],
                                   *(a[..., None, :] for a in hp))
    llr = demod_soft(x, Mod.QPSK)
    llr = descramble_llrs(llr, cinit_pcfich(2 * sf_idx, cell.id))
    # correlate: bit 0 <-> +1
    signs = jnp.asarray(1.0 - 2.0 * CFI_CODEWORDS.astype(np.float32))
    # full float32 precision (a GPU would otherwise take it in TF32)
    corr = jnp.einsum("...k,ck->...c", llr, signs,
                      precision=jax.lax.Precision.HIGHEST)
    cfi = jnp.argmax(corr, axis=-1) + 1
    return cfi, jnp.max(corr, axis=-1) / jnp.sum(jnp.abs(llr), axis=-1)
