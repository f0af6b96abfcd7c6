"""PUSCH: physical uplink shared channel (36.211 5.3, 36.212 5.2.2).

Capability parity with lib/src/phy/phch/pusch.c: UL-SCH coding (shared
turbo chain), scrambling, modulation, DFT transform precoding, mapping
around the two DMRS symbols; and the eNB receive path (enb_ul.c:256-386):
DMRS channel estimation, MMSE equalization, IDFT despreading, soft
demapping and decode. UCI multiplexing is handled in models/uci.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from ..ops.dft_precoding import dft_deprecode, dft_precode, valid_prb
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..utils.cell import Cell
from ..utils.sequence import cinit_pdsch
from .refsignal_ul import chest_ul_pusch, pusch_dmrs, pusch_dmrs_symbols
from .sch import DlschPlan, dlsch_decode, dlsch_encode


# --- frequency hopping (36.211 5.3.4 / 36.213 8.4; pusch.c:55-137) ----------


def pusch_hop_type1(nof_prb: int, n_rb_ho: int, n_prb_1: int,
                    hop: str) -> tuple[int, int]:
    """Type-1 hopping: fixed offset between slots from the DCI0 hopping
    bits (ra.c:145-177). hop: "quart" | "quart_neg" | "half"."""
    if n_rb_ho % 2:
        n_rb_ho += 1
    n_rb_pusch = nof_prb - n_rb_ho - (nof_prb % 2)
    if hop == "quart":
        n1 = (n_rb_pusch // 4 + n_prb_1) % n_rb_pusch
    elif hop == "quart_neg":
        n1 = (n_prb_1 - n_rb_pusch // 4) if n_prb_1 >= n_rb_pusch // 4             else (n_rb_pusch + n_prb_1 - n_rb_pusch // 4)
    elif hop == "half":
        n1 = (n_rb_pusch // 2 + n_prb_1) % n_rb_pusch
    else:
        raise ValueError(hop)
    return n_prb_1, n1


def pusch_hop_type2(cell: Cell, n_sb: int, hopping_offset: int,
                    inter_sf: bool, n_vrb: int, sf_idx: int,
                    current_tx_nb: int = 0) -> tuple[int, int]:
    """Type-2 (pseudo-random subband) hopping with mirroring
    (36.211 5.3.4; pusch.c:55-137). The hopping pattern c(i) is the
    Gold sequence seeded with the cell id (pusch.c:332)."""
    from ..utils.sequence import gold_sequence

    c = gold_sequence(cell.id, 210)

    def f_hop_sum(i):
        return sum(int(c[k]) << (k - (i * 10 + 1))
                   for k in range(i * 10 + 1, i * 10 + 9))

    def f_hop(i):
        if i == -1 or n_sb == 1:
            return 0
        if n_sb == 2:
            return (f_hop(i - 1) + f_hop_sum(i)) % 2
        return (f_hop(i - 1) + f_hop_sum(i) % (n_sb - 1) + 1) % n_sb

    def f_m(i):
        if n_sb == 1:
            return current_tx_nb % 2 if inter_sf else i % 2
        return int(c[i * 10])

    out = []
    for slot in range(2):
        n_vrb_t = n_vrb
        if n_sb > 1:
            n_vrb_t -= (hopping_offset - 1) // 2 + 1
        i = sf_idx if inter_sf else 2 * sf_idx + slot
        n_rb_sb = cell.nof_prb
        if n_sb > 1:
            n_rb_sb = (n_rb_sb - hopping_offset - hopping_offset % 2)                 // n_sb
        n_prb_t = (n_vrb_t + f_hop(i) * n_rb_sb
                   + (n_rb_sb - 1 - 2 * (n_vrb_t % n_rb_sb)) * f_m(i))             % (n_rb_sb * n_sb)
        if n_sb > 1:
            n_prb_t += (hopping_offset - 1) // 2 + 1
        out.append(n_prb_t)
    return out[0], out[1]


@dataclass(frozen=True)
class PuschConfig:
    """Static PUSCH grant configuration."""

    cell: Cell
    sf_idx: int = 0
    rnti: int = 0x1234
    mod: Mod = Mod.QPSK
    prb_start: int = 0
    n_prb: int = 6
    cyclic_shift: int = 0
    #: second-slot PRB start when frequency hopping (36.211 5.3.4);
    #: None = no hop
    prb_start_slot1: int | None = None
    #: DMRS group/sequence hopping (36.211 5.5.1.3/5.5.1.4;
    #: refsignal_ul.c:229,368)
    delta_ss: int = 0
    group_hopping: bool = False
    sequence_hopping: bool = False
    #: 8-bit quantized LLR lane (see PdschConfig.llr_int8)
    llr_int8: bool = False

    def __post_init__(self):
        assert valid_prb(self.n_prb), f"n_prb={self.n_prb} not 2^a 3^b 5^c"

    @property
    def m_sc(self) -> int:
        return 12 * self.n_prb

    @property
    def nof_data_symbols(self) -> int:
        return self.cell.nsymb_sf - 2  # minus the two DMRS symbols

    @property
    def g(self) -> int:
        return self.nof_data_symbols * self.m_sc * self.mod.bits_per_symbol

    def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
             decoder_impl: str = "auto") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         rv=rv, max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self) -> int:
        return cinit_pdsch(self.rnti, 0, 2 * self.sf_idx, self.cell.id)

    def slot_starts(self) -> tuple[int, int]:
        s1 = self.prb_start if self.prb_start_slot1 is None \
            else self.prb_start_slot1
        return self.prb_start, s1

    @functools.cached_property
    def data_symbol_indices(self) -> np.ndarray:
        l0, l1 = pusch_dmrs_symbols(self.cell)
        return np.asarray(
            [s for s in range(self.cell.nsymb_sf) if s not in (l0, l1)],
            np.int32)


def pusch_encode(tb_bits, cfg: PuschConfig, plan: DlschPlan):
    """tb_bits[..., tbs] -> UL grid [..., nsymb, nre] (single antenna)."""
    coded = dlsch_encode(tb_bits, plan)
    scr = scramble_bits(coded, cfg.cinit())
    syms = modulate(scr, cfg.mod)
    lead = syms.shape[:-1]
    blocks = syms.reshape(*lead, cfg.nof_data_symbols, cfg.m_sc)
    spread = dft_precode(blocks)

    from ..utils.scatter import place

    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    half = cell.nsymb_slot

    def k0_of(sym: int) -> int:
        # per-slot start implements frequency hopping (pusch_cp
        # pusch.c:141-180 uses grant->n_prb_tilde[slot])
        return 12 * (st0 if sym < half else st1)

    l0, l1 = pusch_dmrs_symbols(cell)
    dmrs = pusch_dmrs(cell, cfg.n_prb, cfg.cyclic_shift,
                      delta_ss=cfg.delta_ss, sf_idx=cfg.sf_idx,
                      group_hopping=cfg.group_hopping,
                      sequence_hopping=cfg.sequence_hopping)
    data_idx = np.concatenate(
        [s * cell.nof_re + k0_of(s) + np.arange(cfg.m_sc)
         for s in cfg.data_symbol_indices])
    dmrs_idx = np.concatenate(
        [l * cell.nof_re + k0_of(l) + np.arange(cfg.m_sc)
         for l in (l0, l1)])
    vals = jnp.concatenate(
        [spread.reshape(*lead, -1),
         jnp.broadcast_to(jnp.asarray(dmrs.reshape(-1)),
                          (*lead, 2 * cfg.m_sc))], axis=-1)
    flat = place(vals, np.concatenate([data_idx, dmrs_idx]),
                 cell.nsymb_sf * cell.nof_re)
    return flat.reshape(*lead, cell.nsymb_sf, cell.nof_re)


def pusch_decode(grid, cfg: PuschConfig, plan: DlschPlan, noise_est=0.0,
                 iters_out=None,
                 softbuffers=None):
    """eNB receive: grid [..., nsymb, nre] -> (tb, crc_ok, softbuffers).

    DMRS chest over the allocation, per-RE MMSE, IDFT despread, CSI-
    weighted LLRs, UL-SCH decode (srslte_enb_ul chain, enb_ul.c:256-386).
    """
    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    h = chest_ul_pusch(grid, cell, cfg.prb_start, cfg.n_prb,
                       cfg.cyclic_shift,
                       prb_start_slot1=cfg.prb_start_slot1,
                       sf_idx=cfg.sf_idx, delta_ss=cfg.delta_ss,
                       group_hopping=cfg.group_hopping,
                       sequence_hopping=cfg.sequence_hopping)
    if st0 == st1:
        alloc = grid[..., 12 * st0 : 12 * st0 + cfg.m_sc]
    else:
        half = cell.nsymb_slot
        alloc = jnp.concatenate(
            [grid[..., :half, 12 * st0 : 12 * st0 + cfg.m_sc],
             grid[..., half:, 12 * st1 : 12 * st1 + cfg.m_sc]], axis=-2)
    data_syms = jnp.asarray(cfg.data_symbol_indices)
    y = alloc[..., data_syms, :]
    hh = h[..., data_syms, :]
    x = y * jnp.conj(hh) / (jnp.abs(hh) ** 2 + noise_est)
    despread = dft_deprecode(x)
    llr = demod_soft(despread.reshape(*despread.shape[:-2], -1), cfg.mod)
    # weight by the mean channel gain per symbol (post-IDFT the per-RE CSI
    # averages across the allocation)
    csi = jnp.mean(jnp.abs(hh) ** 2, axis=-1, keepdims=True)
    csi = jnp.broadcast_to(csi, hh.shape).reshape(*despread.shape[:-2], -1)
    llr = llr * jnp.repeat(csi, cfg.mod.bits_per_symbol, axis=-1)
    if cfg.llr_int8:
        from ..ops.modem import quantize_llr_int8

        llr = quantize_llr_int8(llr, cfg.mod)
    llr = descramble_llrs(llr, cfg.cinit())
    return dlsch_decode(llr, plan, softbuffers=softbuffers,
                        iters_out=iters_out)


# --- UCI multiplexing on PUSCH (36.212 5.2.2; sch.c:550-1095) ----------------


@dataclass(frozen=True)
class UciData:
    """UCI payload riding on a PUSCH grant (srslte_uci_data_t parity)."""

    cqi_bits: tuple = ()        # CQI/PMI payload bits (O of them)
    ri: int | None = None       # 1-bit rank indicator
    ack: tuple = ()             # 0/1/2 HARQ-ACK bits
    i_offset_cqi: int = 7
    i_offset_ri: int = 2
    i_offset_ack: int = 2


class UciPlan:
    """Static per-grant UCI layout: Q' sizes, RI/ACK bit positions, the
    5.2.2.8 channel-interleaver permutation, and scrambling-repetition
    sign fixups — all precomputed host-side (the device path is gathers)."""

    def __init__(self, cfg: PuschConfig, tbs: int, uci: UciData,
                 rv: int = 0, max_iterations: int = 5,
                 decoder_impl: str = "auto"):
        from . import uci as uci_mod
        from ..ops.fec.cbsegm import cbsegm as cb_segm

        self.cfg = cfg
        self.uci = uci
        qm = cfg.mod.bits_per_symbol
        nb_q = cfg.g
        n_symb = cfg.nof_data_symbols
        h_total = nb_q // qm
        self.rows = h_total // n_symb
        self.qm = qm
        self.nb_q = nb_q

        if tbs > 0:
            segm = cb_segm(tbs)
            k_sum = segm.c_plus * segm.k_plus + segm.c_minus * segm.k_minus
        else:
            k_sum = 0
        m_sc, o_cqi = cfg.m_sc, len(uci.cqi_bits)

        def beta_div(beta):
            # UCI-only PUSCH: beta is relative to the CQI offset (sch.c:1016)
            if tbs == 0:
                return beta / uci_mod.BETA_CQI_OFFSET[uci.i_offset_cqi]
            return beta

        # RI
        if uci.ri is not None:
            beta = beta_div(uci_mod.BETA_RI_OFFSET[uci.i_offset_ri])
            self.q_ri = uci_mod.q_prime_ri_ack(1, o_cqi, beta, m_sc,
                                               n_symb, k_sum, m_sc)
            self.ri_pos = uci_mod.ri_ack_positions(
                self.q_ri, qm, self.rows, cfg.cell.cp.name == "NORM", ack=False)
        else:
            self.q_ri, self.ri_pos = 0, np.zeros(0, np.int64)

        # ACK (punctures data; positions computed like RI but column set
        # around DMRS)
        if len(uci.ack):
            beta = beta_div(uci_mod.BETA_HARQ_OFFSET[uci.i_offset_ack])
            self.q_ack = uci_mod.q_prime_ri_ack(len(uci.ack), o_cqi, beta,
                                                m_sc, n_symb, k_sum, m_sc)
            self.ack_pos = uci_mod.ri_ack_positions(
                self.q_ack, qm, self.rows, cfg.cell.cp.name == "NORM", ack=True)
        else:
            self.q_ack, self.ack_pos = 0, np.zeros(0, np.int64)

        # CQI
        if o_cqi:
            beta = uci_mod.BETA_CQI_OFFSET[uci.i_offset_cqi]
            self.q_cqi = uci_mod.q_prime_cqi(o_cqi, beta, self.q_ri, m_sc,
                                             n_symb, k_sum, m_sc, n_symb)
        else:
            self.q_cqi = 0

        self.perm = uci_mod.ulsch_interleaver_perm(h_total, n_symb, qm,
                                                   self.ri_pos)
        self.g_data = nb_q - (self.q_ri + self.q_cqi) * qm
        self.tbs = tbs
        self.data_plan = (DlschPlan(tbs=tbs, g=self.g_data, qm=qm, rv=rv,
                                    max_iterations=max_iterations,
                                    decoder_impl=decoder_impl)
                          if tbs > 0 else None)

    def _overlay(self, positions: np.ndarray, values, q_prime: int):
        """(data_pos, data_bits, ph_pos, rep_pos) for one RI/ACK field."""
        from . import uci as uci_mod

        pat = uci_mod.ri_ack_pattern(np.asarray(values), self.qm)
        codes = np.array([pat[(i * self.qm + k) % len(pat)]
                          for i in range(q_prime) for k in range(self.qm)])
        data_m = codes <= 1
        return (positions[data_m], codes[data_m].astype(np.int8),
                positions[codes == uci_mod.UCI_BIT_PLACEHOLDER],
                positions[codes == uci_mod.UCI_BIT_REPETITION])


def pusch_encode_uci(tb_bits, cfg: PuschConfig, plan: UciPlan):
    """Full UL-SCH+UCI encode (srslte_ulsch_uci_encode sch.c:995-1095 +
    pusch.c:536-560 placeholder fixups) -> UL grid [..., nsymb, nre]."""
    from . import uci as uci_mod
    from ..utils.scatter import place
    from ..utils.sequence import gold_sequence

    uci = plan.uci
    qm, nb_q = plan.qm, plan.nb_q

    parts = []
    if plan.q_cqi:
        cqi = uci_mod.encode_cqi_pusch(np.asarray(uci.cqi_bits, np.int8),
                                       plan.q_cqi * qm)
        parts.append(jnp.asarray(cqi, jnp.int8))
    if plan.tbs > 0:
        coded = dlsch_encode(tb_bits, plan.data_plan)
        parts.append(coded.astype(jnp.int8))
    g = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)

    # channel interleave (scatter through the precomputed permutation)
    lead = g.shape[:-1]
    q = place(g, plan.perm, nb_q)

    # RI/ACK overlays as static masks (utils/scatter.py: masks and
    # gathers in place of scatter-set)
    overlays = []
    if plan.q_ri:
        overlays.append(plan._overlay(plan.ri_pos, [uci.ri], plan.q_ri))
    if plan.q_ack:
        overlays.append(plan._overlay(plan.ack_pos, list(uci.ack),
                                      plan.q_ack))
    ov_mask = np.zeros(nb_q, bool)
    ov_val = np.zeros(nb_q, np.int8)
    ph_mask = np.zeros(nb_q, bool)
    rep_src = np.arange(nb_q)
    for data_pos, data_bits, ph_pos, rep_pos in overlays:
        ov_mask[data_pos] = True
        ov_val[data_pos] = data_bits
        ph_mask[ph_pos] = True
        rep_src[rep_pos] = rep_pos - 1
    if ov_mask.any():
        q = jnp.where(jnp.asarray(ov_mask), jnp.asarray(ov_val), q)

    q = scramble_bits(q, cfg.cinit())

    # post-scrambling fixups: placeholder (x) bits -> 1; repetition (y)
    # bits -> copy of previous (scrambled) bit (pusch.c:543-556)
    if ph_mask.any():
        q = jnp.where(jnp.asarray(ph_mask), jnp.int8(1), q)
    if (rep_src != np.arange(nb_q)).any():
        q = q[..., rep_src]

    syms = modulate(q, cfg.mod)
    blocks = syms.reshape(*lead, cfg.nof_data_symbols, cfg.m_sc)
    spread = dft_precode(blocks)

    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    half = cell.nsymb_slot

    def k0_of(sym: int) -> int:
        # per-slot start implements frequency hopping (pusch_cp
        # pusch.c:141-180 uses grant->n_prb_tilde[slot])
        return 12 * (st0 if sym < half else st1)

    l0, l1 = pusch_dmrs_symbols(cell)
    dmrs = pusch_dmrs(cell, cfg.n_prb, cfg.cyclic_shift,
                      delta_ss=cfg.delta_ss, sf_idx=cfg.sf_idx,
                      group_hopping=cfg.group_hopping,
                      sequence_hopping=cfg.sequence_hopping)
    data_idx = np.concatenate(
        [s * cell.nof_re + k0_of(s) + np.arange(cfg.m_sc)
         for s in cfg.data_symbol_indices])
    dmrs_idx = np.concatenate(
        [l * cell.nof_re + k0_of(l) + np.arange(cfg.m_sc)
         for l in (l0, l1)])
    vals = jnp.concatenate(
        [spread.reshape(*lead, -1),
         jnp.broadcast_to(jnp.asarray(dmrs.reshape(-1)),
                          (*lead, 2 * cfg.m_sc))], axis=-1)
    flat = place(vals, np.concatenate([data_idx, dmrs_idx]),
                 cell.nsymb_sf * cell.nof_re)
    return flat.reshape(*lead, cell.nsymb_sf, cell.nof_re)


def _decode_ri_ack_field(llr, plan: UciPlan, positions: np.ndarray,
                         q_prime: int, nof_bits: int, cinit: int):
    """Soft-combine one RI/ACK field from descrambled LLRs (positive <=>
    bit 0). Repetition bits (1-bit field, Qm>=2) repeat the *scrambled*
    previous bit, so after descrambling they need the sign of
    s[p-1]^s[p] — a static host-side correction."""
    from ..utils.sequence import gold_sequence

    qm = plan.qm
    pos = positions.reshape(q_prime, qm)
    if nof_bits == 1:
        seq = gold_sequence(cinit, plan.nb_q)
        s = jnp.sum(llr[..., pos[:, 0]], axis=-1)
        if qm >= 2:
            p1 = pos[:, 1]
            corr = (1.0 - 2.0 * (seq[p1 - 1] ^ seq[p1])).astype(np.float32)
            s = s + jnp.sum(llr[..., p1] * jnp.asarray(corr), axis=-1)
        return [(s < 0).astype(jnp.int8)]
    # 2-bit field: rep m%3 carries (b0,b1)/(b2,b0)/(b1,b2) at k=0,1
    sums = [jnp.zeros(llr.shape[:-1], llr.dtype) for _ in range(3)]
    carriers = [(0, 1), (2, 0), (1, 2)]
    for i in range(q_prime):
        bi0, bi1 = carriers[i % 3]
        sums[bi0] = sums[bi0] + llr[..., pos[i, 0]]
        if qm >= 2:
            sums[bi1] = sums[bi1] + llr[..., pos[i, 1]]
    # ML over (b0, b1) with b2 = b0^b1
    cands = []
    for b0 in (0, 1):
        for b1 in (0, 1):
            b2 = b0 ^ b1
            cands.append((1 - 2 * b0) * sums[0] + (1 - 2 * b1) * sums[1]
                         + (1 - 2 * b2) * sums[2])
    best = jnp.argmax(jnp.stack(cands, axis=-1), axis=-1)
    return [(best >> 1).astype(jnp.int8), (best & 1).astype(jnp.int8)]


@functools.lru_cache(maxsize=None)
def pusch_decode_jit(cfg: PuschConfig, tbs: int, rv: int = 0,
                     with_soft: bool = False):
    """Cached jitted PUSCH decode program for one (config, TBS, rv).

    The eNB stack receives PUSCH every granted TTI; running the chain
    eagerly re-traces/re-lowers the turbo scans per call (the dominant
    cost of a CPU TTI). Call as ``fn(grid, noise)`` or, with_soft,
    ``fn(grid, noise, softbuffers)``."""
    import jax

    plan = cfg.plan(tbs, rv=rv)
    if with_soft:
        return jax.jit(lambda grid, noise, soft: pusch_decode(
            grid, cfg, plan, noise_est=noise, softbuffers=soft))
    return jax.jit(lambda grid, noise: pusch_decode(
        grid, cfg, plan, noise_est=noise))


@functools.lru_cache(maxsize=None)
def pusch_decode_uci_jit(cfg: PuschConfig, plan: UciPlan,
                         with_soft: bool = False):
    """Cached jitted PUSCH+UCI decode program (see pusch_decode_jit)."""
    import jax

    if with_soft:
        return jax.jit(lambda grid, noise, soft: pusch_decode_uci(
            grid, cfg, plan, noise_est=noise, softbuffers=soft))
    return jax.jit(lambda grid, noise: pusch_decode_uci(
        grid, cfg, plan, noise_est=noise))


def pusch_decode_uci(grid, cfg: PuschConfig, plan: UciPlan, noise_est=0.0,
                     softbuffers=None):
    """eNB receive with UCI demux (srslte_ulsch_uci_decode sch.c:884-985).

    -> dict with 'tb', 'crc_ok', 'softbuffers', 'cqi_bits', 'cqi_ok',
    'ri', 'ack'.
    """
    from . import uci as uci_mod

    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    h = chest_ul_pusch(grid, cell, cfg.prb_start, cfg.n_prb,
                       cfg.cyclic_shift,
                       prb_start_slot1=cfg.prb_start_slot1,
                       sf_idx=cfg.sf_idx, delta_ss=cfg.delta_ss,
                       group_hopping=cfg.group_hopping,
                       sequence_hopping=cfg.sequence_hopping)
    if st0 == st1:
        alloc = grid[..., 12 * st0 : 12 * st0 + cfg.m_sc]
    else:
        half = cell.nsymb_slot
        alloc = jnp.concatenate(
            [grid[..., :half, 12 * st0 : 12 * st0 + cfg.m_sc],
             grid[..., half:, 12 * st1 : 12 * st1 + cfg.m_sc]], axis=-2)
    data_syms = jnp.asarray(cfg.data_symbol_indices)
    y = alloc[..., data_syms, :]
    hh = h[..., data_syms, :]
    x = y * jnp.conj(hh) / (jnp.abs(hh) ** 2 + noise_est)
    despread = dft_deprecode(x)
    llr = demod_soft(despread.reshape(*despread.shape[:-2], -1), cfg.mod)
    csi = jnp.mean(jnp.abs(hh) ** 2, axis=-1, keepdims=True)
    csi = jnp.broadcast_to(csi, hh.shape).reshape(*despread.shape[:-2], -1)
    llr = llr * jnp.repeat(csi, cfg.mod.bits_per_symbol, axis=-1)
    llr = descramble_llrs(llr, cfg.cinit())

    import jax

    # under jit (pusch_decode_uci_jit) leave results as traced arrays;
    # eager callers keep getting Python ints
    _py = lambda v: v if isinstance(v, jax.core.Tracer) else int(v)
    out = {"ri": None, "ack": (), "cqi_bits": None, "cqi_ok": None,
           "tb": None, "crc_ok": None, "softbuffers": None}
    cinit = cfg.cinit()
    if plan.q_ack:
        bits = _decode_ri_ack_field(llr, plan, plan.ack_pos, plan.q_ack,
                                    len(plan.uci.ack), cinit)
        out["ack"] = tuple(_py(b) for b in bits)
        # zero punctured positions before data demux (sch.c:925-928)
        zmask = np.ones(plan.nb_q, np.float32)
        zmask[plan.ack_pos] = 0.0
        llr = llr * jnp.asarray(zmask)
    if plan.q_ri:
        bits = _decode_ri_ack_field(llr, plan, plan.ri_pos, plan.q_ri, 1,
                                    cinit)
        out["ri"] = _py(bits[0])
    g = llr[..., plan.perm]
    n_cqi = plan.q_cqi * plan.qm
    if plan.q_cqi:
        cqi_bits, ok = uci_mod.decode_cqi_pusch(
            g[..., :n_cqi], len(plan.uci.cqi_bits), n_cqi)
        out["cqi_bits"] = (cqi_bits if isinstance(cqi_bits, jax.core.Tracer)
                           else np.asarray(cqi_bits))
        out["cqi_ok"] = ok
    if plan.tbs > 0:
        tb, crc_ok, sbuf = dlsch_decode(g[..., n_cqi:], plan.data_plan,
                                        softbuffers=softbuffers)
        out["tb"], out["crc_ok"], out["softbuffers"] = tb, crc_ok, sbuf
    return out
