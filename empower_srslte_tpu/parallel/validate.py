"""Sharding-validation pipelines shared by the driver dryrun and the
multi-process (multi-host) dryrun.

``build_uedl_mini`` returns the complete no-genie UE downlink chain —
time samples -> OFDM FFT -> LS channel
estimation off the CRS -> pilot noise estimate -> PCFICH decode ->
blind-candidate PDCCH (Viterbi + CRC16-RNTI) -> PDSCH decode with the
estimated channel — as a per-shard local step suitable for shard_map
over any mesh. This is the chain the framework actually ships at the
receiver (reference analog: lib/examples/pdsch_ue.c main loop), built
at 6 PRB so CPU-mesh compiles stay fast.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def build_uedl_mini(seed: int = 0):
    """-> (local_step, tbs): ``local_step(tb_bits[..., tbs]) ->
    (bits[..., tbs], ok[...])`` runs eNB compose -> UE full receive per
    shard; deterministic in ``seed`` so every process builds identical
    closures."""
    from ..models.dci import format0_1a_size
    from ..models.enb_dl import enb_dl_base_grid, enb_dl_gen_signal
    from ..models.pcfich import pcfich_decode, pcfich_put
    from ..models.pdcch import (BITS_PER_CCE, pdcch_encode,
                                pdcch_extract_llr, ue_search_candidates)
    from ..models.pdsch import PdschConfig, pdsch_decode, pdsch_encode
    from ..models.regs import pdcch_nof_cces
    from ..ops.chest import chest_dl, noise_est_pilots
    from ..ops.fec.convcoder import viterbi_decode
    from ..ops.fec.rm_conv import rm_conv_rx
    from ..ops.modem import Mod
    from ..ops.ofdm import ofdm_rx_sf
    from ..utils.bits import uint_to_bits
    from ..utils.cell import Cell
    from ..utils.crc import CRC16

    rng = np.random.default_rng(seed)
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    sf_idx, cfi, rnti = 1, 1, 0x5A5A
    cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                      mod=Mod.QPSK)
    tbs = 136                        # K=160 (windowed decoder eligible)
    plan = cfg.plan(tbs, decoder_impl="xla")
    size1a = format0_1a_size(6)
    dci_bits = jnp.asarray(rng.integers(0, 2, size1a).astype(np.int8))
    n_cce = pdcch_nof_cces(cell, cfi)
    cands = ue_search_candidates(rnti, sf_idx, n_cce)
    mask16 = jnp.asarray(uint_to_bits(rnti & 0xFFFF, 16))
    dci_l, dci_cce = cands[0]

    def local_step(tb_bits):
        grid = enb_dl_base_grid(cell, sf_idx,
                                batch_shape=tb_bits.shape[:-1])
        grid = pcfich_put(grid, cfi, cell, sf_idx)
        grid = grid + pdcch_encode(dci_bits, rnti, dci_cce, dci_l,
                                   cell, cfi, sf_idx)
        grid = grid + pdsch_encode(tb_bits, cfg, plan)
        samples = enb_dl_gen_signal(grid, cell)[..., 0, :]
        rx = ofdm_rx_sf(samples, cell)
        h = chest_dl(rx, cell, sf_idx, port=0)
        n0 = jnp.maximum(noise_est_pilots(rx, cell, sf_idx), 1e-6)
        cfi_hat, _ = pcfich_decode(rx, h, cell, sf_idx,
                                   noise_est=n0[..., None])
        llr_c = pdcch_extract_llr(rx, h, cell, cfi, sf_idx,
                                  noise_est=n0[..., None])
        e = dci_l * BITS_PER_CCE
        seg = llr_c[..., dci_cce * BITS_PER_CCE :
                    dci_cce * BITS_PER_CCE + e]
        dbits = viterbi_decode(rm_conv_rx(seg, size1a + 16), wrap=1)
        unmasked = jnp.concatenate(
            [dbits[..., :size1a],
             jnp.bitwise_xor(dbits[..., size1a:], mask16)], axis=-1)
        dci_ok = CRC16.jnp_check(unmasked)
        bits, ok, _ = pdsch_decode(rx[..., None, :, :],
                                   h[..., None, None, :, :], cfg, plan,
                                   noise_est=n0[..., None])
        return bits, jnp.logical_and(
            ok, jnp.logical_and(cfi_hat == cfi, dci_ok))

    return local_step, tbs
