"""SLO-aware admission scheduling: deadlines, priority tiers, preemption.

This module is the policy half of ROADMAP item 2 ("retire FIFO"): every
request may declare an SLO — ``deadline_ms`` (end-to-end budget from
arrival), ``priority`` (``high`` / ``normal`` / ``low``), ``max_ttft_ms``
(admission latency budget) — and the engine orders admission by an
**EDF-with-priority-tiers** rank instead of arrival order:

    rank(req, now) = (effective_tier, admission_deadline, arrival_seq)

* ``effective_tier`` is the declared priority tier minus one level per
  ``aging_s`` seconds spent waiting (**starvation aging**: a low-priority
  request left behind long enough eventually outranks fresh high-priority
  arrivals — the tier is unbounded below, so no stream of urgent traffic
  can starve it forever).
* ``admission_deadline`` is the earliest absolute instant among the
  request's declared budgets (EDF within a tier); no SLO means +inf, so a
  default workload degrades exactly to FIFO (ties broken by arrival).
* ``arrival_seq`` is the queue's monotonic stamp — the FIFO tie-break
  that makes schedules reproducible.

**Preemption** (``SLOPolicy.pick_victim``): when no lane is free and the
head of the queue strictly outranks a running request *by declared
priority and deadline* (aging moves queue order, never evictions — an
aged tier would let equals preempt each other in a thrash loop), the
engine deschedules the worst-ranked running victim.  Only backends that
declare ``preemptible`` (the paged backend: block tables snapshot in
O(blocks) and the blocks stay refcounted) participate; others decline
with a capability reason.

**Overload shedding** (``pressure``): the queue's estimated decode-work
seconds gate two levels, shed in declared order —

    1. ``soft_overload_s``  — degrade: speculative backends drop their
       draft-model work (plain decode, still token-identical) before any
       request is refused;
    2. ``hard_overload_s``  — reject: the lowest-priority *waiting* tier
       is shed (queued requests retire as ``REJECTED``; new submissions
       of that tier raise ``OverloadedError`` → HTTP 429 with a
       structured status) rather than livelocking the whole queue.

``FIFOPolicy`` is the strict arrival-order baseline (no preemption, no
shedding) kept for A/B benchmarking (``bench_load.py --slo-smoke``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

PRIORITIES = {"high": 0, "normal": 1, "low": 2}


def validate_slo(deadline_ms: Optional[float], priority: Optional[str],
                 max_ttft_ms: Optional[float]) -> None:
    """Reject nonsensical SLOs with actionable messages (mirrors
    ``HydraConfig.validate()``); the HTTP layer maps these to 400."""
    if deadline_ms is not None:
        if not math.isfinite(deadline_ms) or deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms={deadline_ms}: a deadline is a positive "
                "end-to-end millisecond budget measured from arrival; "
                "omit it for no deadline")
    if max_ttft_ms is not None:
        if not math.isfinite(max_ttft_ms) or max_ttft_ms <= 0:
            raise ValueError(
                f"max_ttft_ms={max_ttft_ms}: the time-to-first-token "
                "budget must be a positive number of milliseconds; "
                "omit it for no TTFT bound")
    if priority is not None and priority not in PRIORITIES:
        raise ValueError(
            f"priority={priority!r}: known priorities are "
            f"{sorted(PRIORITIES, key=PRIORITIES.get)} "
            "(high runs first, low is shed first under overload)")


@dataclass
class SLO:
    """Per-request service-level objective (all fields optional)."""
    deadline_ms: Optional[float] = None     # end-to-end budget from arrival
    priority: str = "normal"                # "high" | "normal" | "low"
    max_ttft_ms: Optional[float] = None     # admission-latency budget

    def validate(self) -> "SLO":
        validate_slo(self.deadline_ms, self.priority, self.max_ttft_ms)
        return self

    @property
    def tier(self) -> int:
        return PRIORITIES[self.priority]

    def merged(self, default: Optional["SLO"]) -> "SLO":
        """Request-level fields win; unset ones inherit the model default."""
        if default is None:
            return self
        return SLO(
            deadline_ms=(self.deadline_ms if self.deadline_ms is not None
                         else default.deadline_ms),
            priority=(self.priority if self.priority != "normal"
                      or default.priority == "normal" else default.priority),
            max_ttft_ms=(self.max_ttft_ms if self.max_ttft_ms is not None
                         else default.max_ttft_ms))

    def deadline_abs(self, arrival: float) -> float:
        """Absolute end-to-end deadline (+inf when none declared)."""
        if self.deadline_ms is None:
            return math.inf
        return arrival + self.deadline_ms / 1000.0

    def admission_deadline(self, arrival: float) -> float:
        """Earliest absolute instant any declared budget expires — the
        EDF key (admission latency bounds TTFT, so ``max_ttft_ms``
        participates alongside the end-to-end deadline)."""
        out = self.deadline_abs(arrival)
        if self.max_ttft_ms is not None:
            out = min(out, arrival + self.max_ttft_ms / 1000.0)
        return out


class OverloadedError(RuntimeError):
    """Submission refused by the shed policy (HTTP maps this to 429)."""

    def __init__(self, message: str, *, payload: Optional[dict] = None):
        super().__init__(message)
        self.payload = dict(payload or {})


# ---------------------------------------------------------------------------
# admission policies
# ---------------------------------------------------------------------------

class FIFOPolicy:
    """Strict arrival order: the PR-1 baseline, kept for A/B comparison.
    Never preempts, never sheds — exactly the old head-of-queue scan."""

    name = "fifo"
    preempt = False

    def rank(self, req, now: float):
        return (req.arrival_seq if req.arrival_seq is not None else 0,)

    def order(self, reqs: Sequence, now: float) -> list:
        return sorted(reqs, key=lambda r: self.rank(r, now))

    def pick_victim(self, head, running: Sequence, now: float):
        return None

    def pressure(self, queued_seconds: float) -> int:
        return 0


@dataclass
class SLOPolicy:
    """EDF with priority tiers + starvation aging (see module docstring).

    ``aging_s``            — seconds of waiting per tier promotion
                             (0 disables aging).
    ``preempt``            — allow descheduling running requests when the
                             backend declares ``preemptible``.
    ``preempt_min_tokens`` — a victim must have decoded this many tokens
                             since its last admit/resume (anti-thrash).
    ``demote_on_preempt``  — on tiered-KV backends, eagerly demote a
                             victim's parked pages to the host pool so
                             they stop pinning device bytes (preempt→
                             demote, resume→prefetch barrier; see
                             docs/serving.md).  Ignored when the engine
                             is not tiered.
    ``soft_overload_s``    — queued-work seconds above which speculative
                             draft models are degraded (level 1).
    ``hard_overload_s``    — queued-work seconds above which the
                             lowest-priority waiting tier is shed
                             (level 2).  Defaults are +inf: no shedding
                             unless the deployment declares thresholds.
    """

    name: str = "slo"
    aging_s: float = 30.0
    preempt: bool = True
    preempt_min_tokens: int = 2
    demote_on_preempt: bool = True
    soft_overload_s: float = math.inf
    hard_overload_s: float = math.inf

    # -- ordering ------------------------------------------------------------
    def _tier(self, req, now: float) -> int:
        tier = req.slo.tier
        if self.aging_s > 0 and req.arrival_time is not None:
            waited = max(0.0, now - req.arrival_time)
            # unbounded below: aging must eventually outrank even fresh
            # high-priority deadline traffic, or low-priority requests
            # starve forever under sustained load (tests/test_slo.py)
            tier -= int(waited / self.aging_s)
        return tier

    def rank(self, req, now: float):
        return (self._tier(req, now),
                req.slo.admission_deadline(req.arrival_time or now),
                req.arrival_seq if req.arrival_seq is not None else 0)

    def order(self, reqs: Sequence, now: float) -> list:
        return sorted(reqs, key=lambda r: self.rank(r, now))

    # -- preemption ----------------------------------------------------------
    def _victim_rank(self, req, now: float):
        """Preemption compares DECLARED priority + deadline only: aging
        promotes queue order, but letting an aged tier evict a running
        equal would thrash (each preempts the other forever)."""
        return (req.slo.tier,
                req.slo.deadline_abs(req.arrival_time or now),
                req.arrival_seq if req.arrival_seq is not None else 0)

    def pick_victim(self, head, running: Sequence, now: float):
        """The worst-ranked running request the queue head STRICTLY
        outranks by (tier, deadline), or None.  Victims must have decoded
        ``preempt_min_tokens`` since their last admit/resume."""
        if not self.preempt:
            return None
        cands = [r for r in running
                 if len(r.generated) - r.resume_generated
                 >= self.preempt_min_tokens]
        if not cands:
            return None
        victim = max(cands, key=lambda r: self._victim_rank(r, now))
        if self._victim_rank(victim, now)[:2] > self._victim_rank(head,
                                                                  now)[:2]:
            return victim
        return None

    # -- overload ------------------------------------------------------------
    def pressure(self, queued_seconds: float) -> int:
        """0 nominal · 1 soft (degrade spec drafts) · 2 hard (shed)."""
        if queued_seconds >= self.hard_overload_s:
            return 2
        if queued_seconds >= self.soft_overload_s:
            return 1
        return 0

    @staticmethod
    def shed_tier(waiting: Sequence) -> Optional[int]:
        """The tier shed first under hard overload: the lowest-priority
        (numerically highest) tier currently waiting — relative, so an
        all-``normal`` workload still sheds rather than livelocking."""
        tiers = [r.slo.tier for r in waiting]
        return max(tiers) if tiers else None


POLICIES = {"slo": SLOPolicy, "fifo": FIFOPolicy}


def make_policy(name: str, **kw):
    """Policy by name; kwargs reach the policy constructor (``fifo``
    takes none — its point is having no knobs)."""
    if name not in POLICIES:
        raise ValueError(f"unknown admission policy {name!r} "
                         f"(have {sorted(POLICIES)})")
    if name == "fifo":
        return FIFOPolicy()
    return SLOPolicy(**kw)


# ---------------------------------------------------------------------------
# SLO-aware multi-model routing (the LRTF generalization multi.py uses)
# ---------------------------------------------------------------------------

def most_urgent(engines: Sequence, now: float,
                margin_s: float = 0.5) -> Optional[int]:
    """Index of the engine whose tightest deadline is closest to being
    missed — but only when some engine's slack is inside ``margin_s``
    (deadline pressure is real); otherwise None, and the caller falls
    back to LRTF's throughput-optimal pick.  This generalizes the LRTF
    router: identical behavior with no deadlines declared, EDF across
    engines when deadlines bite."""
    best: Optional[tuple[float, int]] = None
    for i, eng in enumerate(engines):
        slack = eng.min_slack_seconds(now)
        if slack is None or slack >= margin_s:
            continue
        if best is None or slack < best[0]:
            best = (slack, i)
    return best[1] if best else None
