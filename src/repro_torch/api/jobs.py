"""Typed job specs accepted by ``repro_torch.api.Session`` (port of
``repro.api.jobs``, the train and eval half).

* ``TrainJob`` — one model-selection candidate trained under SHARP
  (the fields of ``repro_torch.core.ModelTask``).
* ``EvalJob``  — fixed-batch loss/perplexity over a dataloader, executed
  forward-only through the same shard queue as training.

``ServeJob`` (the session's serving half) and ``SpmdTrainJob`` (training
over a device mesh) come with later slices of the port and raise; the
port's serve CLI builds its ``InferenceEngine`` directly.

A job is inert data; ``Session.plan`` turns submitted jobs into a ``Plan``
and ``Session.run`` executes one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class JobSpec:
    """Base spec: subclasses add workload fields; the session assigns ids."""
    cfg: Any                                    # ArchConfig

    kind: str = ""                              # set by subclasses


@dataclass
class TrainJob(JobSpec):
    """One SHARP training candidate (paper Fig. 4's ModelTask, spec form)."""
    dataloader: Optional[Any] = None            # iterable of batches
    lr: float = 1e-3
    epochs: int = 1
    steps_per_epoch: int = 4
    optimizer: str = "adamw"
    params: Optional[Any] = None                # init'd from seed if None
    seed: int = 0
    batch: int = 2                              # partitioning pilot shape
    seq: int = 128
    early_stop: Optional[Callable[[list], bool]] = None
    kind: str = field(default="train", init=False)

    @classmethod
    def from_task(cls, task) -> "TrainJob":
        """Adapter from ``repro_torch.core.orchestrator.ModelTask``."""
        return cls(cfg=task.cfg, dataloader=task.dataloader, lr=task.lr,
                   epochs=task.epochs, steps_per_epoch=task.steps_per_epoch,
                   optimizer=task.optimizer, params=task.params,
                   seed=task.seed, batch=task.batch, seq=task.seq,
                   early_stop=task.early_stop)

    def opt_config(self):
        from repro_torch.optim import optimizers as opt
        # per-shard stepping composes with sequential training only when
        # gradient clipping is off (clipping needs the global norm, which
        # no single shard sees) — Hydra therefore disables it
        return opt.OptimizerConfig(kind=self.optimizer, lr=self.lr,
                                   grad_clip=0.0)


@dataclass
class EvalJob(JobSpec):
    """Fixed-batch loss/perplexity over a dataloader, forward-only through
    the shard queue — a model bounded only by host DRAM evaluates on one
    device, sharing the partition/spill machinery with training."""
    dataloader: Optional[Any] = None
    n_batches: int = 1
    params: Optional[Any] = None                # init'd from seed if None
    seed: int = 0
    batch: int = 2                              # partitioning pilot shape
    seq: int = 128
    kind: str = field(default="eval", init=False)


class ServeJob:
    """Not ported yet: serving through the session comes with the serve
    half of ``Session`` in a later slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ServeJob: serving through the Session comes with the serve "
            "half of Session in a later slice of the port; build a "
            "repro_torch.serving.engine.InferenceEngine directly (as "
            "repro_torch.launch.serve does)")


class SpmdTrainJob:
    """Not ported yet: single-model training over a device mesh comes
    with the sharding slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SpmdTrainJob: training over a device mesh comes with the "
            "sharding slice of the port (sharding/, launch/train.py)")
