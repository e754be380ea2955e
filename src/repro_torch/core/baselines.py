"""Baseline execution paradigms (paper §2.2, Fig 3, Fig 8 comparisons),
port of ``repro.core.baselines``.

Each baseline consumes the same measured per-shard unit runtimes that SHARP
uses, and produces a virtual timeline (makespan + utilization).  This makes
the Fig-8-style comparisons *schedule* comparisons on identical compute —
exactly the quantity the paper varies — while real training still runs
through the Hydra executor.

* ``model_parallel``  — every model's shards statically placed across
  devices; sequential dependency means one active device at a time; models
  run one after another (PyTorch-Distributed MP baseline).
* ``pipeline``        — GPipe-style: mini-batch split into ``n_micro``
  micro-batches pipelined through the shard stages with a synchronous
  flush between forward and backward (fill/drain bubbles).
* ``task_parallel``   — whole models round-robin'd across devices; only
  valid when a model fits one device's memory (else raises, as the paper
  notes these systems crash).

Neither side of a comparison holds host<->device transfers here: SHARP's
``RunReport`` adds transfers modelled at ``HydraConfig.link_bw``, these
timelines add none.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.partitioner import tree_bytes


@dataclass
class BaselineReport:
    makespan: float
    avg_utilization: float
    name: str


def _model_times(models) -> list[list[tuple[float, float]]]:
    """[(fwd, bwd)] per shard per model (from pilot measurements)."""
    return [[(s.fwd_runtime, s.bwd_runtime) for s in m.partition.shards]
            for m in models]


def model_parallel(models, n_devices: int, steps: list[int]) -> BaselineReport:
    """Strict inter-layer model parallelism, one model at a time."""
    total = 0.0
    busy = 0.0
    for m_idx, shards in enumerate(_model_times(models)):
        per_mb = sum(f + b for f, b in shards)
        total += per_mb * steps[m_idx]
        busy += per_mb * steps[m_idx]     # exactly one device active
    util = busy / (total * n_devices) if total else 0.0
    return BaselineReport(total, util, "model_parallel")


def pipeline(models, n_devices: int, steps: list[int],
             n_micro: int | None = None) -> BaselineReport:
    """GPipe-style synchronous pipeline, one model at a time.

    Stages = shards mapped round-robin onto devices; micro-batch count
    defaults to device count (the paper's GPipe configuration).  Bubble
    fraction per pass = (S-1)/(M+S-1) with S stages, M micro-batches.
    """
    total = 0.0
    busy = 0.0
    for m_idx, shards in enumerate(_model_times(models)):
        S = min(len(shards), n_devices)
        M = n_micro or n_devices
        fwd = sum(f for f, _ in shards)
        bwd = sum(b for _, b in shards)
        # standard GPipe fill-drain schedule: (M+S-1) stage slots per pass,
        # stage time = per-microbatch per-stage compute
        f_stage = fwd / S / M
        b_stage = bwd / S / M
        per_mb = (M + S - 1) * (f_stage + b_stage)
        total += per_mb * steps[m_idx]
        busy += (fwd + bwd) * steps[m_idx]
    util = busy / (total * n_devices) if total else 0.0
    return BaselineReport(total, util, "pipeline")


def task_parallel(models, n_devices: int, steps: list[int],
                  device_budget: int) -> BaselineReport:
    """Pure task parallelism (Cerebro-class). Crashes on big models."""
    dev_loads = np.zeros(n_devices)
    for m_idx, m in enumerate(models):
        # whole model must fit: params + grads + Adam moments
        model_bytes = tree_bytes(m.store.params) * 4
        if model_bytes > device_budget:
            raise MemoryError(
                f"model {m_idx} ({model_bytes/1e9:.2f} GB with optimizer "
                f"state) exceeds a single device ({device_budget/1e9:.2f} GB)"
                " — task parallelism cannot train it (paper §2.2)")
        per_mb = sum(s.fwd_runtime + s.bwd_runtime
                     for s in m.partition.shards)
        dev_loads[np.argmin(dev_loads)] += per_mb * steps[m_idx]
    makespan = float(dev_loads.max())
    util = float(dev_loads.sum() / (makespan * n_devices)) if makespan else 0.0
    return BaselineReport(makespan, util, "task_parallel")
