"""Multi-model serving: several loaded engines, one device timeline (port
of ``repro.serving.multi``).

Hydra's thesis — interleave many independent jobs to hide per-job stalls —
applied to inference: each loaded model owns an ``InferenceEngine``, and
between ticks the server asks the SHARP scheduling policy (Sharded-LRTF
from ``repro_torch.core.scheduler``) which model's decode step runs next.  A
model's "remaining train time" maps onto its remaining decode work in
seconds (``ModelProgress.from_remaining``): LRTF therefore keeps the model
with the most outstanding tokens moving, the same longest-first rule the
paper proves out for training makespan.

``scheduler="slo"`` generalizes the LRTF router for deadline traffic:
each tick first asks every eligible engine for its tightest deadline
slack (``InferenceEngine.min_slack_seconds``); if some engine's slack is
inside the urgency margin, that engine steps (EDF across models) —
otherwise the tick falls back to plain LRTF, so workloads without
deadlines route identically to ``"lrtf"``.

Ties in remaining time resolve deterministically: eligible models are
presented to the policy sorted by (model name, earliest arrival seq), so
equal-remaining-work schedules are reproducible across runs instead of
following dict insertion order.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional, Union

from repro_torch.core.scheduler import (ModelProgress, SchedulerFn,
                                        get_scheduler)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.slo import most_urgent


class MultiModelServer:
    def __init__(self, engines: dict[str, InferenceEngine],
                 scheduler: Union[str, SchedulerFn] = "lrtf",
                 trace_cap: int = 4096, slo_margin_s: float = 0.5):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = dict(engines)
        self._names = list(self.engines)
        # "slo" = deadline-aware pre-pass + LRTF fallback (module
        # docstring); get_scheduler maps the name onto the fallback fn
        self.slo_routing = scheduler == "slo"
        self.slo_margin_s = slo_margin_s
        self.scheduler: SchedulerFn = (get_scheduler(scheduler)
                                       if isinstance(scheduler, str)
                                       else scheduler)
        # model picked at each tick — a capped ring, not an unbounded
        # list: a server alive for millions of ticks holds steady memory
        self.schedule_trace: deque[str] = deque(maxlen=trace_cap)

    def submit(self, model: str, prompt, max_new_tokens: int,
               **kw) -> Request:
        return self.engines[model].submit(prompt, max_new_tokens, **kw)

    def cancel(self, request_id: str) -> bool:
        """Withdraw a request by id from whichever engine holds it."""
        return any(eng.cancel(request_id)
                   for eng in self.engines.values())

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines.values())

    def _earliest_seq(self, name: str) -> float:
        """Oldest live arrival seq in an engine (queued or active) — the
        second component of the deterministic tie-break."""
        eng = self.engines[name]
        seqs = [r.arrival_seq
                for r in list(eng.queue) + eng.active_requests()
                if r.arrival_seq is not None]
        return min(seqs) if seqs else math.inf

    def step(self) -> Optional[str]:
        """One server tick: pick a model via the policy, run its engine
        tick.  Returns the model name stepped, or None when idle."""
        # deterministic tie-breaking: the LRTF/SRTF fns keep the FIRST
        # best on exact remaining-time ties, so present eligible models
        # sorted by (model name, earliest arrival seq) instead of dict
        # insertion order — equal-work schedules reproduce across runs
        eligible = sorted(
            (name for name in self._names if self.engines[name].has_work()),
            key=lambda name: (name, self._earliest_seq(name)))
        if not eligible:
            return None
        pick = None
        if self.slo_routing:
            # EDF pre-pass: an engine whose tightest deadline is inside
            # the urgency margin wins outright; None -> LRTF fallback
            now = self.engines[eligible[0]].clock()
            pick = most_urgent([self.engines[n] for n in eligible], now,
                               margin_s=self.slo_margin_s)
        if pick is None:
            progress = [ModelProgress.from_remaining(
                i, self.engines[name].remaining_seconds())
                for i, name in enumerate(eligible)]
            pick = self.scheduler(progress)
        name = eligible[pick]
        self.engines[name].step()
        self.schedule_trace.append(name)
        return name

    def run(self, max_steps: Optional[int] = None) -> dict[str, list[Request]]:
        """Drive to completion; returns only the requests completed DURING
        this call (mirrors ``InferenceEngine.run`` — returning the full
        ``completed`` history double-counted on repeated invocations)."""
        before = {name: eng.retired_total
                  for name, eng in self.engines.items()}
        steps = 0
        while self.step() is not None:
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {name: eng.completed_since(before[name])
                for name, eng in self.engines.items()}

    def drain_completed(self) -> dict[str, list[Request]]:
        """Pop every engine's retained completions (the serving loop's
        drain-on-read; see ``InferenceEngine.drain_completed``)."""
        return {name: eng.drain_completed()
                for name, eng in self.engines.items()}

    def summary(self) -> dict:
        out = {name: eng.summary() for name, eng in self.engines.items()}
        ledger = self.shared_ledger()
        if ledger is not None:
            out["device_memory"] = {
                "budget_bytes": ledger.budget,
                "kv_reserved_bytes": ledger.kv_reserved_bytes,
                "kv_peak_bytes": ledger.kv_peak_bytes,
                "resident_bytes": ledger.resident_bytes,
            }
        return out

    def shared_ledger(self):
        """The one DeviceMemory every paged engine charges, when the server
        was built that way (admission across models then splits a single
        device byte budget); None when ledgers are absent or per-engine.
        A lone engine's private ledger (device_id -1, built from its own
        kv_budget_bytes) is per-engine state, not device-level memory."""
        ledgers = [e.ledger for e in self.engines.values()
                   if getattr(e, "ledger", None) is not None]
        if ledgers and all(lg is ledgers[0] for lg in ledgers) \
                and (len(ledgers) > 1 or ledgers[0].device_id >= 0):
            return ledgers[0]
        return None
