"""UE downlink subframe pipeline: FFT -> chest -> PCFICH -> PDCCH blind
search -> grant -> PDSCH decode.

Capability parity with lib/src/phy/ue/ue_dl.c (srslte_ue_dl_decode_rnti,
ue_dl.c:467-618) and ue_mib.c: the complete receive path from time-domain
subframe samples to decoded transport blocks. Control decisions (CFI, DCI
grants) are resolved host-side per subframe — the compiled pieces are
keyed by the resulting static grant configs, mirroring the reference's
plan-per-configuration design.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.chest import chest_dl, noise_est_pilots
from ..ops.equalizer import MimoType
from ..ops.modem import Mod
from ..ops.ofdm import ofdm_rx_sf
from ..utils.cell import Cell
from . import dci as dci_mod
from . import ra
from .pbch import pbch_decode
from .pcfich import pcfich_decode
from .pdcch import pdcch_blind_decode
from .pdsch import PdschConfig, pdsch_decode


@dataclass
class UeDlResult:
    """One subframe's decode outcome (per decoded grant)."""

    cfi: int
    dci: object | None = None
    tb_bits: np.ndarray | None = None
    crc_ok: bool = False
    noise_est: float = 0.0
    snr_db: float = 0.0          # wideband chest SNR (feeds CQI reports)
    cce: int = 0                 # first CCE of the grant's PDCCH (36.213
                                 # 10.1 ACK resource: n_pucch = n_cce + N1)
    phich_ack: bool | None = None  # UL HARQ indicator when one was
                                   # expected this subframe (ul_harq.cc)
    cw: int = 0                    # codeword index (format 2 grants)


def estimate_channel(grid, cell: Cell, sf_idx: int):
    """Per-port channel estimates: grid [..., nsymb, nre] ->
    h [..., P, nsymb, nre] and scalar noise estimate."""
    hs = [chest_dl(grid, cell, sf_idx, port=p) for p in range(cell.nof_ports)]
    h = jnp.stack(hs, axis=-3)
    n0 = noise_est_pilots(grid, cell, sf_idx)
    return h, n0


#: jitted pipeline stages, cached per static configuration (eager
#: execution would re-trace per call); compiled graphs embed the complex
#: constants.
_front_cache: dict = {}
_pdsch_cache: dict = {}
_pdcch_llr_cache: dict = {}
_phich_cache: dict = {}


def _front_fn(cell: Cell, sf_idx: int):
    key = (repr(cell), sf_idx)
    if key not in _front_cache:
        import jax

        def f(samples):
            grid = ofdm_rx_sf(samples[None], cell)[0]
            h, n0 = estimate_channel(grid[None], cell, sf_idx)
            cfi_arr, _ = pcfich_decode(grid[None], h[0][None],
                                       cell, sf_idx, noise_est=n0[0])
            hpow = jnp.mean(jnp.abs(h[0]) ** 2)
            return grid, h[0], n0[0], cfi_arr[0], hpow

        _front_cache[key] = jax.jit(f)
    return _front_cache[key]


def _pdsch_fn2(cfg: PdschConfig, plan, plan2):
    """2-codeword decode (format 2 grants): returns per-cw tuples."""
    key = (repr(cfg), repr(plan), repr(plan2), "cw2")
    if key not in _pdsch_cache:
        import jax

        def f(grid, h, noise):
            return pdsch_decode(grid[None, None], h[None, None], cfg,
                                plan, noise_est=noise, plan2=plan2)

        _pdsch_cache[key] = jax.jit(f)
    return _pdsch_cache[key]


def _pdsch_fn(cfg: PdschConfig, plan, with_soft: bool = False):
    key = (repr(cfg), repr(plan), with_soft)
    if key not in _pdsch_cache:
        import jax

        if with_soft:
            def f(grid, h, noise, *soft):
                return pdsch_decode(grid[None, None], h[None, None], cfg,
                                    plan, noise_est=noise,
                                    softbuffers=list(soft))
        else:
            def f(grid, h, noise):
                return pdsch_decode(grid[None, None], h[None, None], cfg,
                                    plan, noise_est=noise)

        _pdsch_cache[key] = jax.jit(f)
    return _pdsch_cache[key]


def ue_dl_decode(samples, cell: Cell, sf_idx: int, rnti: int,
                 mimo: MimoType = MimoType.SINGLE,
                 max_iterations: int = 5,
                 harq_state: dict | None = None,
                 phich: tuple[int, int] | None = None,
                 llr_int8: bool = False) -> list[UeDlResult]:
    """Decode one subframe for one RNTI (single rx antenna).

    samples [sf_sample_len] complex64 -> list of per-grant results.

    ``harq_state``: caller-owned dict pid -> {"ndi", "soft"} carrying
    per-process softbuffers across retransmissions (srsue dl_harq.cc +
    softbuffer.c): an un-toggled NDI reuses the combined LLRs, a CRC
    failure stores them back.
    ``phich``: (group, seq) of an expected UL HARQ indicator
    (srslte_ue_dl_decode_phich, ue_dl.c:934) -> results carry phich_ack.
    ``llr_int8``: run the PDSCH pipelines on the 8-bit quantized LLR
    lane (demod byte scales, int8 de-RM + softbuffers).
    """
    from ..utils import device_complex

    grid, h, n0, cfi_arr, hpow = _front_fn(cell, sf_idx)(
        device_complex(samples))
    noise = float(np.asarray(n0))
    cfi = int(np.asarray(cfi_arr))
    snr_db = float(10.0 * np.log10(max(float(np.asarray(hpow)), 1e-12)
                                   / max(noise, 1e-12)))

    phich_ack = None
    if phich is not None:
        from .phich import phich_decode

        pkey = (repr(cell), sf_idx, phich)
        if pkey not in _phich_cache:
            import jax

            def _ph(grid, h, noise, _g=phich[0], _s=phich[1]):
                return phich_decode(grid[None], h[None], cell, sf_idx,
                                    group=_g, seq_idx=_s, noise_est=noise)

            _phich_cache[pkey] = jax.jit(_ph)
        h0 = h if (h.ndim == 3 and cell.nof_ports >= 2) \
            else (h[0, 0] if h.ndim == 4 else h[0])
        ak, _ = _phich_cache[pkey](grid, h0, noise)
        phich_ack = bool(np.asarray(ak)[0])

    # common search space RNTIs additionally monitor format 1C
    # (ue_dl.c: SI/P/RA-RNTI -> formats 1A+1C)
    common_ss = rnti in (0xFFFF, 0xFFFE) or 1 <= rnti <= 0x3C
    sizes = (dci_mod.format0_1a_size(cell.nof_prb),
             dci_mod.format1_size(cell.nof_prb))
    if common_ss:
        sizes = sizes + (dci_mod.format1c_size(cell.nof_prb),)
    f2_size = None
    if cell.nof_ports >= 2 and not common_ss:
        # TM4-configured UEs additionally monitor format 2 in their
        # UE-specific space (ue_dl.c dci_format per transmission mode)
        f2_size = dci_mod.format2_size(cell.nof_prb)
        sizes = sizes + (f2_size,)
    from .pdcch import pdcch_extract_llr

    key = (repr(cell), cfi, sf_idx)
    if key not in _pdcch_llr_cache:
        import jax

        def _ex(grid, h, noise, _cfi=cfi):
            return pdcch_extract_llr(grid, h, cell, _cfi, sf_idx, noise)

        _pdcch_llr_cache[key] = jax.jit(_ex)
    h1 = h[0, 0] if h.ndim == 4 else h[0]
    # diversity cells: the control region is SFBC across 2 ports
    hreg = h if (h.ndim == 3 and cell.nof_ports >= 2) else h1
    llr = np.asarray(_pdcch_llr_cache[key](grid, hreg, noise))
    hits = pdcch_blind_decode(grid, hreg, cell, cfi, sf_idx, rnti, sizes,
                              noise_est=noise, llr=llr)

    results: list[UeDlResult] = []
    for hit in hits:
        d = None
        if len(hit.payload) == sizes[0]:
            d = dci_mod.unpack_format1a(hit.payload, cell.nof_prb)
            if d is None:
                # flag bit 0: format 0 = an uplink grant for this RNTI
                d_ul = dci_mod.unpack_format0(hit.payload, cell.nof_prb)
                if d_ul is not None:
                    results.append(UeDlResult(cfi=cfi, dci=d_ul,
                                              noise_est=noise,
                                              snr_db=snr_db,
                                              cce=hit.cce))
                continue
        elif len(hit.payload) == sizes[1]:
            d = dci_mod.unpack_format1(hit.payload, cell.nof_prb)
        elif common_ss and len(hit.payload) == sizes[2]:
            d1c = dci_mod.unpack_format1c(hit.payload, cell.nof_prb)
            if d1c is None:
                continue
            tbs = int(ra.tbs_format1c_table()[d1c.i_tbs])
            cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                              mod=Mod.QPSK, mimo=mimo,
                              prb_mask=d1c.prb_mask,
                              prb_mask_slot1=d1c.prb_mask_slot1,
                              llr_int8=llr_int8)
            plan = cfg.plan(tbs, rv=0, max_iterations=max_iterations)
            bits, ok, _ = _pdsch_fn(cfg, plan)(grid, h, noise)
            results.append(UeDlResult(
                cfi=cfi, dci=d1c, tb_bits=np.asarray(bits)[0],
                crc_ok=bool(np.asarray(ok)[0]), noise_est=noise,
                snr_db=snr_db, cce=hit.cce))
            continue
        if f2_size is not None and len(hit.payload) == f2_size:
            d2 = dci_mod.unpack_format2(hit.payload, cell.nof_prb)
            if d2 is None:
                continue
            # equal-MCS constraint across codewords (one Mod per cfg).
            # Reserved/inconsistent MCS (29-31 without a stored retx
            # TBS) marks a false-positive blind decode — drop the
            # candidate like dci.c's validity checks.
            try:
                mod2, tbs0 = ra.mcs_to_tbs(d2.mcs[0], d2.n_prb)
                _, tbs1 = ra.mcs_to_tbs(d2.mcs[1], d2.n_prb)
            except ValueError:
                continue
            cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi,
                              rnti=rnti, mod=mod2,
                              mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                              nof_codewords=2, pmi=d2.pmi,
                              prb_mask=d2.prb_mask,
                              llr_int8=llr_int8)
            plan0 = cfg.plan(tbs0, rv=d2.rv[0],
                             max_iterations=max_iterations)
            plan1 = cfg.plan(tbs1, rv=d2.rv[1],
                             max_iterations=max_iterations)
            bits2, ok2, _ = _pdsch_fn2(cfg, plan0, plan1)(grid, h, noise)
            for cw in range(2):
                results.append(UeDlResult(
                    cfi=cfi, dci=d2,
                    tb_bits=np.asarray(bits2[cw])[0],
                    crc_ok=bool(np.asarray(ok2[cw])[0]),
                    noise_est=noise, snr_db=snr_db, cce=hit.cce,
                    cw=cw))
            continue
        if d is None:
            continue
        try:
            if common_ss and d.format == "1A":
                # SI/P/RA-RNTI 1A grants size the TBS with N_prb_1A from
                # the TPC LSB, not the actual allocation (36.212
                # 5.3.3.1.3; ra.c dci_format1a si-rnti handling)
                mod = Mod.QPSK
                tbs = ra.mcs_to_tbs(d.mcs, d.n_prb_1a)[1]
            else:
                mod, tbs = ra.mcs_to_tbs(d.mcs, d.n_prb)
        except ValueError:
            continue      # reserved MCS / empty allocation: false positive
        cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                          mod=mod, mimo=mimo, prb_mask=d.prb_mask,
                          llr_int8=llr_int8)
        plan = cfg.plan(tbs, rv=d.rv, max_iterations=max_iterations)
        soft_in, hst = None, None
        if harq_state is not None and not common_ss:
            hst = harq_state.setdefault(d.harq_pid,
                                        {"ndi": None, "soft": None})
            if hst["ndi"] == d.ndi and hst["soft"] is not None:
                soft_in = hst["soft"]      # retransmission: combine
            else:
                hst["ndi"] = d.ndi
                hst["soft"] = None
        if soft_in is not None:
            bits, ok, new_soft = _pdsch_fn(cfg, plan, True)(
                grid, h, noise, *soft_in)
        else:
            bits, ok, new_soft = _pdsch_fn(cfg, plan)(grid, h, noise)
        ok_b = bool(np.asarray(ok)[0])
        if hst is not None:
            hst["soft"] = None if ok_b else list(new_soft)
        results.append(UeDlResult(
            cfi=cfi, dci=d,
            tb_bits=np.asarray(bits)[0],
            crc_ok=ok_b,
            noise_est=noise, snr_db=snr_db, cce=hit.cce))
    if not results:
        results.append(UeDlResult(cfi=cfi, noise_est=noise,
                                  snr_db=snr_db))
    if phich_ack is not None:
        for r in results:
            r.phich_ack = phich_ack
    return results


_mib_full_cache: dict = {}


def ue_mib_acquire(samples, cell_geom: Cell, cell_id: int) -> dict | None:
    """MIB from a full-rate subframe-0 capture: FFT at the receiver's
    geometry, slice the central 6 PRB, blind PBCH decode (ue_mib.c runs
    at 1.92 Msps; post-FFT the central 72 subcarriers are identical)."""
    from ..utils import device_complex

    cell6 = Cell(nof_prb=6, id=cell_id, nof_ports=1)
    key = (repr(cell_geom), cell_id)
    if key not in _mib_full_cache:
        import jax

        def f(samples):
            grid = ofdm_rx_sf(samples[None], cell_geom)[0]
            mid = cell_geom.nof_re // 2
            g6 = grid[..., mid - 36 : mid + 36]
            h, n0 = estimate_channel(g6[None], cell6, 0)
            return pbch_decode(g6[None], h[0, 0][None], cell6,
                               noise_est=n0[0])

        _mib_full_cache[key] = jax.jit(f)
    bits, q, ports, ok = _mib_full_cache[key](device_complex(samples))
    if not bool(np.asarray(ok)[0]):
        return None
    from .pbch import mib_unpack

    mib = mib_unpack(np.asarray(bits)[0])
    mib["sfn_mod4"] = int(np.asarray(q)[0])
    mib["nof_ports"] = int(np.asarray(ports)[0])
    mib["sfn"] = (mib["sfn_msb"] << 2) | mib["sfn_mod4"]
    return mib


def ue_mib_decode(samples, cell_id: int) -> dict | None:
    """MIB acquisition from a subframe-0 capture at 1.92 Msps
    (ue_mib.c analog): chest on the 6-PRB grid, blind PBCH decode."""
    cell = Cell(nof_prb=6, id=cell_id, nof_ports=1)
    from ..utils import device_complex

    grid = ofdm_rx_sf(device_complex(samples)[None], cell)[0]
    h, n0 = estimate_channel(grid[None], cell, 0)
    from .pbch import mib_unpack

    bits, q, ports, ok = pbch_decode(
        grid[None], h[0, 0][None], cell, noise_est=float(np.asarray(n0[0])))
    if not bool(np.asarray(ok)[0]):
        return None
    mib = mib_unpack(np.asarray(bits)[0])
    mib["sfn_mod4"] = int(np.asarray(q)[0])
    mib["nof_ports"] = int(np.asarray(ports)[0])
    return mib
