"""SHARP scheduling (paper §4.7), port of ``repro.core.scheduler``: the
MILP formalization's greedy solver — Sharded-LRTF (Algorithm 2) — plus
baselines (random, FIFO, SRTF) and an exact branch-and-bound for small
instances (the Gurobi stand-in used by the Fig 7 simulation study).
Pure Python: the same picks as the JAX package on the same progress.

A *unit* here is opaque: the scheduler only sees per-model remaining-time
structure, exactly the Struct of Algorithm 2:
    e   remaining epochs
    b   mini-batches per epoch
    ce  remaining mini-batches in current epoch
    t   mini-batch train time (sum of the model's unit times)
    cm  remaining train time in current mini-batch
"""

from __future__ import annotations

import heapq
import random as _random
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


@dataclass
class ModelProgress:
    """Sharded-LRTF's per-model struct (paper Algorithm 2)."""
    model_id: int
    remaining_epochs: int            # e  (includes current)
    minibatches_per_epoch: int       # b
    remaining_in_epoch: int          # ce (includes current)
    minibatch_time: float            # t
    remaining_in_minibatch: float    # cm

    def remaining_time(self) -> float:
        e, b, ce = self.remaining_epochs, self.minibatches_per_epoch, \
            self.remaining_in_epoch
        return ((e - 1) * b + ce - 1) * self.minibatch_time \
            + self.remaining_in_minibatch

    @classmethod
    def from_remaining(cls, model_id: int,
                       remaining_seconds: float) -> "ModelProgress":
        """Degenerate single-minibatch struct whose ``remaining_time()`` is
        exactly ``remaining_seconds`` — how serving maps a model's remaining
        decode work onto the training-centric LRTF struct."""
        return cls(model_id, remaining_epochs=1, minibatches_per_epoch=1,
                   remaining_in_epoch=1, minibatch_time=remaining_seconds,
                   remaining_in_minibatch=remaining_seconds)


SchedulerFn = Callable[[Sequence[ModelProgress]], int]
"""Given the *eligible* models, return the chosen index into the sequence."""


def sharded_lrtf(eligible: Sequence[ModelProgress]) -> int:
    """Pick the model with the Longest Remaining Train Time (Algorithm 2)."""
    best, best_t = 0, -1.0
    for i, m in enumerate(eligible):
        t = m.remaining_time()
        if t > best_t:
            best, best_t = i, t
    return best


def sharded_srtf(eligible: Sequence[ModelProgress]) -> int:
    """Shortest-remaining-time-first (anti-LRTF control)."""
    best, best_t = 0, float("inf")
    for i, m in enumerate(eligible):
        t = m.remaining_time()
        if t < best_t:
            best, best_t = i, t
    return best


def fifo(eligible: Sequence[ModelProgress]) -> int:
    return min(range(len(eligible)), key=lambda i: eligible[i].model_id)


def make_random_scheduler(seed: int = 0) -> SchedulerFn:
    rng = _random.Random(seed)

    def random_sched(eligible: Sequence[ModelProgress]) -> int:
        return rng.randrange(len(eligible))

    return random_sched


SCHEDULERS: dict[str, Callable[..., SchedulerFn]] = {
    "lrtf": lambda **_: sharded_lrtf,
    "srtf": lambda **_: sharded_srtf,
    "fifo": lambda **_: fifo,
    "random": lambda seed=0, **_: make_random_scheduler(seed),
    # "slo": deadline-aware serving routing.  The deadline logic needs
    # live engine state (per-request slack, serving/slo.py), which this
    # ModelProgress-only signature cannot see; multi-model serving
    # special-cases the name and uses this LRTF fn as its no-deadline
    # fallback, so training/config surfaces accept "slo" uniformly.
    "slo": lambda **_: sharded_lrtf,
}


def get_scheduler(name: str, **kw) -> SchedulerFn:
    return SCHEDULERS[name](**kw)


# ---------------------------------------------------------------------------
# Exact branch-and-bound (small instances) — the paper's MILP stand-in.
#
# Problem: T models, model i is a chain of M_i units with runtimes S_i[j];
# P identical devices; a unit may start when its predecessor finished and
# some device is free; objective = makespan.  This is the paper's MILP
# (constraints a–e) solved exactly by DFS with pruning.
# ---------------------------------------------------------------------------

def optimal_makespan(unit_times: list[list[float]], n_devices: int,
                     node_limit: int = 200_000) -> float:
    """Exact (within node_limit) chain-job-shop makespan via branch & bound."""
    T = len(unit_times)
    totals = [sum(u) for u in unit_times]
    best = [greedy_list_makespan(unit_times, n_devices)]   # incumbent
    nodes = [0]

    def lower_bound(next_unit, model_free, dev_heap):
        # LB1: longest remaining chain from its earliest feasible start
        lb1 = max((model_free[i] + sum(unit_times[i][next_unit[i]:])
                   for i in range(T) if next_unit[i] < len(unit_times[i])),
                  default=0.0)
        # LB2: total remaining work / devices, from earliest device time
        rem = sum(sum(unit_times[i][next_unit[i]:]) for i in range(T))
        lb2 = min(dev_heap) + rem / n_devices if rem else 0.0
        return max(lb1, lb2)

    def dfs(next_unit, model_free, dev_heap, t_now):
        if nodes[0] > node_limit:
            return
        nodes[0] += 1
        if all(next_unit[i] >= len(unit_times[i]) for i in range(T)):
            best[0] = min(best[0], max(model_free))
            return
        if lower_bound(next_unit, model_free, dev_heap) >= best[0]:
            return
        # branching: assign the earliest-free device to any eligible model
        heap = sorted(dev_heap)
        dev_t = heap[0]
        rest = heap[1:]
        cands = [i for i in range(T) if next_unit[i] < len(unit_times[i])]
        # heuristic order: longest remaining first (matches LRTF intuition)
        cands.sort(key=lambda i: -(model_free[i]
                                   + sum(unit_times[i][next_unit[i]:])))
        for i in cands:
            start = max(dev_t, model_free[i])
            end = start + unit_times[i][next_unit[i]]
            if end >= best[0]:
                continue
            nu = list(next_unit)
            nu[i] += 1
            mf = list(model_free)
            mf[i] = end
            dfs(tuple(nu), tuple(mf), tuple(rest + [end]), end)
        # also allow the device to idle past the next model-free event
        future = sorted(set(m for m in model_free if m > dev_t))
        if future:
            dfs(next_unit, model_free, tuple(rest + [future[0]]), t_now)

    dfs(tuple([0] * T), tuple([0.0] * T), tuple([0.0] * n_devices), 0.0)
    return best[0]


def greedy_list_makespan(unit_times: list[list[float]], n_devices: int,
                         scheduler: Optional[SchedulerFn] = None,
                         seed: int = 0) -> float:
    """Event-driven makespan under a unit-level scheduler (default LRTF)."""
    scheduler = scheduler or sharded_lrtf
    T = len(unit_times)
    next_unit = [0] * T
    model_free = [0.0] * T
    running = [False] * T
    dev_heap = [(0.0, d) for d in range(n_devices)]
    heapq.heapify(dev_heap)
    finish_events: list[tuple[float, int]] = []
    makespan = 0.0

    while True:
        if all(next_unit[i] >= len(unit_times[i]) for i in range(T)):
            break
        t, d = heapq.heappop(dev_heap)
        # release models whose units finished by t
        for ft, mi in list(finish_events):
            if ft <= t:
                running[mi] = False
                finish_events.remove((ft, mi))
        eligible = [i for i in range(T)
                    if not running[i] and next_unit[i] < len(unit_times[i])]
        if not eligible:
            # advance this device to the next finish event
            nxt = min(ft for ft, _ in finish_events)
            heapq.heappush(dev_heap, (nxt, d))
            continue
        progress = [_as_progress(i, unit_times, next_unit, model_free)
                    for i in eligible]
        pick = eligible[scheduler(progress)]
        start = max(t, model_free[pick])
        end = start + unit_times[pick][next_unit[pick]]
        next_unit[pick] += 1
        model_free[pick] = end
        running[pick] = True
        finish_events.append((end, pick))
        makespan = max(makespan, end)
        heapq.heappush(dev_heap, (end, d))
    return makespan


def _as_progress(i, unit_times, next_unit, model_free) -> ModelProgress:
    remaining = unit_times[i][next_unit[i]:]
    return ModelProgress(
        model_id=i, remaining_epochs=1, minibatches_per_epoch=1,
        remaining_in_epoch=1, minibatch_time=sum(unit_times[i]),
        remaining_in_minibatch=sum(remaining))
