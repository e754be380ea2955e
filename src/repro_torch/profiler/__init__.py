"""``repro_torch.profiler`` — measure the machine, price the plan (port of
``repro.profiler``).

Probes (``probes.py``) measure host<->device bandwidth, per-family
prefill/decode step latency, kernel-vs-plain-version throughput and draft
acceptance; the results persist as a versioned ``MachineFacts`` JSON
(``facts.py``, ``results/profile_latest_torch.json`` by default);
``CostModel`` (``cost.py``) answers the planner's pricing queries from the
measured grids and falls back to the analytic constants — byte-identically
— when no (fresh) profile exists.

    python -m repro_torch.profiler        # probe the card + persist
    Session(..., profile="auto")          # plan against the cached facts

``build_facts`` is imported lazily: the probes pull in the serving stack.
"""

from repro_torch.profiler.cost import CostModel, DraftChoice
from repro_torch.profiler.facts import (ANALYTIC_HARDWARE, DEFAULT_PATH,
                                        MachineFacts, StaleProfileWarning,
                                        current_fingerprint,
                                        hardware_constants, load_facts)

__all__ = ["ANALYTIC_HARDWARE", "CostModel", "DEFAULT_PATH", "DraftChoice",
           "MachineFacts", "StaleProfileWarning", "build_facts",
           "current_fingerprint", "hardware_constants", "load_facts"]


def build_facts(**kw):
    from repro_torch.profiler.probes import build_facts as _build
    return _build(**kw)
