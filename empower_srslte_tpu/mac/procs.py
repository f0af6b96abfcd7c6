"""UE MAC procedures: BSR, PHR, SR + the TTI timer service.

Capability parity with the reference's srsue MAC procedure objects
(srsue/src/mac/proc_bsr.cc, proc_phr.cc, proc_sr.cc) and the
srslte::timers service they run on (lib/include/srslte/common/timers.h).
Host-side integer/state logic — the accelerator carries the PHY; these drive
what goes into each UL transport block.

Behavioral contract (36.321 5.4.5 / 5.4.6 / 5.4.4, as the reference
implements it):

* **BSR** — three trigger classes: REGULAR (new data on a channel with
  higher priority than anything pending, or first data on any channel,
  proc_bsr.cc:102-167), PERIODIC (periodic timer expiry,
  proc_bsr.cc:83-89), PADDING (mux finds >=2 spare bytes,
  proc_bsr.cc:333). Format selection short/long/truncated by LCG count
  and padding room (proc_bsr.cc:175-221). On a UL grant, all triggered
  BSRs are cancelled if the grant fits all pending data but not the CE
  (proc_bsr.cc:292-331); retx timer restarts each grant.
* **PHR** — periodic + prohibit timers and a dl-pathloss-change trigger
  (proc_phr.cc:67-139); the power headroom CE value is quantized to
  the 64-level table (36.133 9.1.8.4).
* **SR** — pending flag raised by a regular BSR with no UL grant;
  signalled on PUCCH every >8 ms up to dsr_transmax, then the UE
  releases PUCCH and falls back to random access (proc_sr.cc:73-103).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

# 36.321 Table 6.1.3.1-1: buffer size levels BS_k for the BSR CE index
# (the reference carries the raw byte count and maps it in pdu.cc).
BSR_TABLE = (
    0, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78, 91,
    107, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706,
    826, 967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995,
    4677, 5476, 6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325,
    22624, 26487, 31009, 36304, 42502, 49759, 58255, 68201, 79846,
    93479, 109439, 128125, 150000, 150001,
)


def bsr_index(nof_bytes: int) -> int:
    """Byte count -> 6-bit BSR index (ceil level: BS_k >= nof_bytes)."""
    if nof_bytes <= 0:
        return 0
    for i, lvl in enumerate(BSR_TABLE):
        if nof_bytes <= lvl:
            return i
    return 63


def phr_index(ph_db: float) -> int:
    """Power headroom dB -> 6-bit PH field (36.133 9.1.8.4:
    PH = -23 + index, clamped to [-23, 40])."""
    return max(0, min(63, int(ph_db + 23)))


class Timer:
    """One countdown timer (srslte::timers::timer, timers.h:42-89)."""

    def __init__(self) -> None:
        self.timeout = 0
        self.counter = 0
        self.running = False
        self.callback: Callable[[int], None] | None = None
        self.id = 0

    def set(self, timeout: int, callback=None) -> None:
        self.timeout = timeout
        self.callback = callback
        self.reset()

    def reset(self) -> None:
        self.counter = 0

    def run(self) -> None:
        self.running = True

    def stop(self) -> None:
        self.running = False

    @property
    def is_expired(self) -> bool:
        return self.timeout > 0 and self.counter >= self.timeout

    def step(self) -> None:
        if self.running and self.timeout > 0 and not self.is_expired:
            self.counter += 1
            if self.is_expired:
                self.running = False
                if self.callback:
                    self.callback(self.id)


class TtiTimers:
    """Timer registry stepped once per TTI (srslte::timers)."""

    def __init__(self) -> None:
        self._timers: list[Timer] = []

    def get_unique(self) -> Timer:
        t = Timer()
        t.id = len(self._timers)
        self._timers.append(t)
        return t

    def step_all(self) -> None:
        for t in self._timers:
            t.step()


@dataclass
class UlSchConfig:
    """ulsch-Config / sr-Config / phr-Config fields the procedures read
    (RRC MAC-MainConfig, 36.331 6.3.2)."""
    periodic_bsr_timer_ms: int = 0     # 0 = infinity/off
    retx_bsr_timer_ms: int = 2560
    sr_configured: bool = True
    dsr_trans_max: int = 4
    sr_period_ms: int = 10         # sr-ConfigIndex periodicity
    sr_subframe: int = 0           # SR occasion: tti % period == this
    phr_setup: bool = True
    periodic_phr_timer_ms: int = 50
    prohibit_phr_timer_ms: int = 0
    dl_pathloss_change_db: int = 3


NONE, REGULAR, PADDING, PERIODIC = 0, 1, 2, 3
SHORT_BSR, LONG_BSR, TRUNC_BSR = 0, 1, 2


@dataclass
class Bsr:
    fmt: int = SHORT_BSR
    buff_size: list = field(default_factory=lambda: [0, 0, 0, 0])


class BsrProc:
    """Buffer status reporting (proc_bsr.cc)."""

    MAX_LCID = 11

    def __init__(self, rlc_buffer_state: Callable[[int], int],
                 timers: TtiTimers, cfg: UlSchConfig) -> None:
        self._buf = rlc_buffer_state
        self.cfg = cfg
        self.triggered_type = NONE
        self.lcg = {}                      # lcid -> lcg
        self.priorities = {}               # lcid -> priority (higher wins)
        self.last_pending = [0] * self.MAX_LCID
        self.sr_is_sent = False
        self.reset_sr_flag = False
        self.timer_periodic = timers.get_unique()
        self.timer_retx = timers.get_unique()
        if cfg.periodic_bsr_timer_ms > 0:
            self.timer_periodic.set(cfg.periodic_bsr_timer_ms,
                                    self._on_timer_periodic)
            self.timer_periodic.run()
        if cfg.retx_bsr_timer_ms > 0:
            self.timer_retx.set(cfg.retx_bsr_timer_ms, self._on_timer_retx)
            self.timer_retx.run()

    def setup_lcid(self, lcid: int, lcg: int, priority: int) -> None:
        self.lcg[lcid] = lcg
        self.priorities[lcid] = priority

    def _on_timer_periodic(self, _tid: int) -> None:
        if self.triggered_type == NONE:
            self.triggered_type = PERIODIC

    def _on_timer_retx(self, _tid: int) -> None:
        # retx of SR only when the periodic timer is not infinity
        # (proc_bsr.cc:90-97 gates on periodic >= 0; infinity is -1)
        self.triggered_type = REGULAR
        self.sr_is_sent = False

    # -- trigger checks (5.4.5 conditions 1/2) ---------------------------
    def _check_new_data(self) -> None:
        """REGULAR trigger: data became available on an LCID whose
        priority is >= every other LCID with pending data."""
        for lcid in self.lcg:
            n = self._buf(lcid)
            if n > 0 and n > self.last_pending[lcid]:
                higher = any(
                    self._buf(j) > 0 and
                    self.priorities.get(j, 0) > self.priorities.get(lcid, 0)
                    for j in self.lcg)
                first_data = self.last_pending[lcid] == 0
                if not higher or first_data:
                    self.triggered_type = REGULAR
                    return

    def step(self, tti: int) -> None:
        self._check_new_data()
        for lcid in self.lcg:
            self.last_pending[lcid] = self._buf(lcid)

    # -- generation ------------------------------------------------------
    def _generate(self, nof_padding_bytes: int) -> tuple[Bsr, bool]:
        bsr = Bsr()
        nof_lcg = 0
        have = False
        for lcid, lcg in self.lcg.items():
            n = self._buf(lcid)
            bsr.buff_size[lcg] += n
            if n > 0:
                nof_lcg += 1
                have = True
        if self.triggered_type == PADDING:
            if nof_padding_bytes < 4:
                if nof_lcg > 1:
                    bsr.fmt = TRUNC_BSR
                    keep = self._max_priority_lcg()
                    for g in range(4):
                        if g != keep:
                            bsr.buff_size[g] = 0
                else:
                    bsr.fmt = SHORT_BSR
            else:
                bsr.fmt = LONG_BSR
        else:
            bsr.fmt = LONG_BSR if nof_lcg > 1 else SHORT_BSR
        return bsr, have

    def _max_priority_lcg(self) -> int:
        best, best_p = 0, -1
        for lcid, lcg in self.lcg.items():
            if self._buf(lcid) > 0 and self.priorities.get(lcid, 0) > best_p:
                best, best_p = lcg, self.priorities.get(lcid, 0)
        return best

    def need_to_send_bsr_on_ul_grant(self, grant_size: int) -> Bsr | None:
        """Called by mux when a UL grant arrives. Returns the BSR to
        include, or None (and cancels triggers either way,
        proc_bsr.cc:292-331)."""
        ret = None
        if self.triggered_type in (PERIODIC, REGULAR):
            total = 0
            for lcid in self.lcg:
                n = self._buf(lcid)
                total += (n + self._sdu_header_size(n)) if n else 0
            total = max(0, total - 1)   # last SDU has no length field
            bsr, _ = self._generate(0)
            ce = 3 if bsr.fmt == LONG_BSR else 1
            if not (total <= grant_size < total + 1 + ce):
                ret = bsr
            if self.timer_periodic.timeout and bsr.fmt != TRUNC_BSR:
                self.timer_periodic.reset()
                self.timer_periodic.run()
        self.triggered_type = NONE
        self.reset_sr_flag = True
        if self.timer_retx.timeout:
            self.timer_retx.reset()
            self.timer_retx.run()
        return ret

    @staticmethod
    def _sdu_header_size(n: int) -> int:
        return 2 if n < 128 else 3

    def generate_padding_bsr(self, nof_padding_bytes: int) -> Bsr | None:
        if self.triggered_type == NONE and nof_padding_bytes < 2:
            return None
        if self.triggered_type == NONE:
            self.triggered_type = PADDING
        bsr, _ = self._generate(nof_padding_bytes)
        if self.timer_periodic.timeout and bsr.fmt != TRUNC_BSR:
            self.timer_periodic.reset()
            self.timer_periodic.run()
        self.triggered_type = NONE
        return bsr

    # -- SR interaction --------------------------------------------------
    def need_to_send_sr(self) -> bool:
        """A regular BSR with no grant means an SR must go out
        (proc_bsr.cc:370-382)."""
        if not self.sr_is_sent and self.triggered_type == REGULAR:
            self.sr_is_sent = True
            return True
        return False

    def need_to_reset_sr(self) -> bool:
        if self.reset_sr_flag:
            self.reset_sr_flag = False
            self.sr_is_sent = False
            return True
        return False


class SrProc:
    """Scheduling request (proc_sr.cc)."""

    def __init__(self, cfg: UlSchConfig) -> None:
        self.cfg = cfg
        self.is_pending = False
        self.counter = 0
        self.do_ra = False
        self.last_tx_tti = -1
        self.sr_signal = False          # consumed by the PHY/PUCCH layer

    def start(self) -> None:
        if not self.is_pending:
            self.counter = 0
            self.is_pending = True

    def reset(self) -> None:
        self.is_pending = False

    def _need_tx(self, tti: int) -> bool:
        if self.last_tx_tti < 0:
            return False
        delta = (tti - self.last_tx_tti) % 10240
        return delta > 8

    def step(self, tti: int) -> None:
        self.sr_signal = False
        if not self.is_pending:
            return
        if not self.cfg.sr_configured:
            self.do_ra = True
            self.reset()
            return
        if tti % self.cfg.sr_period_ms != self.cfg.sr_subframe:
            return                  # not an SR occasion (36.213 10.1)
        if self.counter < self.cfg.dsr_trans_max:
            if self.counter == 0 or self._need_tx(tti):
                self.counter += 1
                self.sr_signal = True
                self.last_tx_tti = tti
        elif self._need_tx(tti):
            # dsr_transmax exhausted: release PUCCH, fall back to RA
            self.do_ra = True
            self.is_pending = False

    def need_random_access(self) -> bool:
        if self.do_ra:
            self.do_ra = False
            return True
        return False


class PhrProc:
    """Power headroom reporting (proc_phr.cc)."""

    def __init__(self, get_pathloss_db: Callable[[], float],
                 get_phr_db: Callable[[], float],
                 timers: TtiTimers, cfg: UlSchConfig) -> None:
        self._pathloss = get_pathloss_db
        self._phr = get_phr_db
        self.cfg = cfg
        self.triggered = False
        self.last_pathloss_db = 0
        self.timer_periodic = timers.get_unique()
        self.timer_prohibit = timers.get_unique()
        if cfg.phr_setup and cfg.periodic_phr_timer_ms > 0:
            self.timer_periodic.set(cfg.periodic_phr_timer_ms,
                                    self._on_periodic)
            self.timer_periodic.run()
            self.triggered = True
        if cfg.prohibit_phr_timer_ms > 0:
            self.timer_prohibit.set(cfg.prohibit_phr_timer_ms,
                                    self._on_prohibit)
            self.timer_prohibit.run()

    def _on_periodic(self, _tid: int) -> None:
        self.timer_periodic.reset()
        self.timer_periodic.run()
        self.triggered = True

    def _on_prohibit(self, _tid: int) -> None:
        if self._pathloss_changed():
            self.triggered = True

    def _pathloss_changed(self) -> bool:
        cur = int(self._pathloss())
        if (self.cfg.dl_pathloss_change_db > 0 and
                abs(cur - self.last_pathloss_db) >
                self.cfg.dl_pathloss_change_db):
            self.last_pathloss_db = cur
            return True
        return False

    def step(self, tti: int) -> None:
        if not self.cfg.phr_setup:
            return
        if self._pathloss_changed() and (
                self.timer_prohibit.timeout == 0 or
                self.timer_prohibit.is_expired):
            self.triggered = True

    def generate_phr_on_ul_grant(self) -> int | None:
        """Returns the 6-bit PH field to include, or None."""
        if not self.triggered:
            return None
        ph = phr_index(self._phr())
        for t in (self.timer_periodic, self.timer_prohibit):
            if t.timeout:
                t.reset()
                t.run()
        self.triggered = False
        return ph
