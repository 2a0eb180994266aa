"""Admission control: load shedding + per-client fairness at saturation.

When offered load exceeds service capacity the failure mode must be an
explicit, cheap rejection — never an unbounded queue (latency collapse)
or a blocked producer graph (deadlock). Two gates, checked at submit:

1. *Global* — total in-flight requests may not exceed ``max_inflight``.
2. *Fair share* — once the system is congested (in-flight beyond the
   ``congestion`` fraction of budget), one client may not hold more than
   ``max_inflight / (active_clients + 1)`` slots — the ``+1`` reserves
   headroom for a newcomer, so a greedy client can neither starve polite
   ones nor lock out a client that hasn't arrived yet. Below congestion
   any client may use spare budget.
3. *SLO burn* (optional) — with an attached
   :class:`~repro_torch.obs.slo.SLOTracker` whose ``shed_burn`` is set, shed
   while every burn window reports budget consumption at or above that
   rate, before any slot accounting happens: when latency or error SLOs
   are burning, taking on more work only digs the hole deeper.

Every verdict — admit or shed — can be journaled to a
:class:`~repro_torch.obs.slo.DecisionLog` together with the live signal it
was decided against (slot counts, fair share, burn rates), so a shed is
explainable after the fact, not just countable.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class ServiceOverloaded(RuntimeError):
    """Raised to a client whose request was shed at admission."""


class AdmissionController:
    def __init__(self, max_inflight: int = 64, *,
                 congestion: float = 0.75, slo=None, log=None):
        if max_inflight <= 0:
            raise ValueError("max_inflight must be positive")
        self.max_inflight = int(max_inflight)
        self.congestion = float(congestion)
        self.slo = slo                          # SLOTracker or None
        self.log = log                          # DecisionLog or None
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}     # client -> held slots
        self._total = 0
        self.rejected_total = 0
        self.rejected_fairness = 0
        self.rejected_slo = 0

    # ------------------------------------------------------------ gates
    def _fair_share(self) -> int:
        active = max(1, len([c for c, n in self._inflight.items() if n > 0]))
        return max(1, self.max_inflight // (active + 1))

    def _note(self, decision: str, client: str, reason: str,
              signal: Dict[str, object]) -> None:
        if self.log is not None:
            self.log.record(decision, client=client, reason=reason,
                            signal=signal)

    def try_admit(self, client: str) -> Tuple[bool, str]:
        """Reserve a slot for ``client``; (ok, reason-if-shed)."""
        if self.slo is not None:
            burning, burn_signal = self.slo.should_shed()
            if burning:
                with self._lock:
                    self.rejected_slo += 1
                    burn_signal.update(inflight=self._total,
                                       max_inflight=self.max_inflight)
                self._note("shed", client, "slo burn rate", burn_signal)
                return False, "slo burn rate"
        with self._lock:
            if self._total >= self.max_inflight:
                self.rejected_total += 1
                signal: Dict[str, object] = {
                    "inflight": self._total,
                    "max_inflight": self.max_inflight}
                verdict: Tuple[bool, str] = (False, "queue saturated")
            else:
                held = self._inflight.get(client, 0)
                congested = (self._total
                             >= self.congestion * self.max_inflight)
                fair = self._fair_share()
                if congested and held >= fair:
                    self.rejected_fairness += 1
                    signal = {"inflight": self._total, "held": held,
                              "fair_share": fair,
                              "max_inflight": self.max_inflight}
                    verdict = (False, "client over fair share")
                else:
                    self._inflight[client] = held + 1
                    self._total += 1
                    signal = {"inflight": self._total, "held": held + 1}
                    verdict = (True, "")
        ok, reason = verdict
        self._note("admit" if ok else "shed", client, reason, signal)
        return verdict

    def release(self, client: str) -> None:
        with self._lock:
            held = self._inflight.get(client, 0)
            if held <= 1:
                self._inflight.pop(client, None)
            else:
                self._inflight[client] = held - 1
            self._total = max(0, self._total - 1)

    # ------------------------------------------------------------ stats
    @property
    def inflight(self) -> int:
        with self._lock:
            return self._total

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"inflight": self._total,
                    "active_clients": len(self._inflight),
                    "max_inflight": self.max_inflight,
                    "rejected_total": self.rejected_total,
                    "rejected_fairness": self.rejected_fairness,
                    "rejected_slo": self.rejected_slo}
