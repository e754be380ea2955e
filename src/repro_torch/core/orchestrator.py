"""Hydra's legacy user-facing API (paper Fig. 4), port of
``repro.core.orchestrator``:

    task_0 = ModelTask(cfg_0, dataloader_0, lr_0, epochs_0)
    task_1 = ModelTask(cfg_1, dataloader_1, lr_1, epochs_1)
    orchestra = ModelOrchestrator([task_0, task_1], hydra_cfg)
    report = orchestra.train_models()

Both classes are thin wrappers: ``ModelOrchestrator`` delegates to a
``Session`` holding one ``TrainJob`` per task, and ``SpilledInference``
runs what an ``EvalJob`` runs per batch.  ``train_sequential_reference``
is the oracle SHARP must reproduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch import resolve_device, tracing
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.sharp import HydraConfig, RunReport, ShardFunctions
from repro_torch.core.spilling import HostModelStore, to_device, to_host
from repro_torch.data.pipeline import as_tensors
from repro_torch.optim import optimizers as opt


@dataclass
class ModelTask:
    """One model-selection candidate: architecture + data + hyperparams."""
    cfg: Any                                   # ArchConfig
    dataloader: Iterator[dict]
    lr: float = 1e-3
    epochs: int = 1
    steps_per_epoch: int = 4
    optimizer: str = "adamw"
    params: Optional[Any] = None               # init'd if None
    seed: int = 0
    batch: int = 2                              # partitioning pilot shape
    seq: int = 128
    # AutoML early stopping: called with the loss history at each
    # mini-batch boundary; return True to stop the model.
    early_stop: Optional[Callable[[list], bool]] = None

    def opt_config(self) -> opt.OptimizerConfig:
        # per-shard stepping composes exactly with sequential training
        # only when gradient clipping is off (clipping needs the global
        # norm, which no single shard sees), so Hydra disables it
        return opt.OptimizerConfig(kind=self.optimizer, lr=self.lr,
                                   grad_clip=0.0)


class ModelOrchestrator:
    """Automated multi-model trainer: a thin wrapper holding a ``Session``
    with one ``TrainJob`` per task."""

    def __init__(self, tasks: list[ModelTask],
                 hydra_cfg: Optional[HydraConfig] = None, *,
                 device="cuda"):
        from repro_torch.api import Session, TrainJob
        self.tasks = tasks
        self.session = Session(hydra_cfg, device=device)
        self.hc = self.session.hc
        for task in tasks:
            self.session.submit(TrainJob.from_task(task))
        # materialize eagerly: callers inspect .models before training
        self.models = self.session.train_execs

    def train_models(self, *, max_units: Optional[int] = None) -> RunReport:
        return self.session.run(max_units=max_units).train

    def model_params(self, model_id: int):
        return self.models[model_id].store.model_params()


# ---------------------------------------------------------------------------
# large-model inference via spilling (paper §6 "Large Model Inference")
# ---------------------------------------------------------------------------

def spilled_forward(store, fns, partition, batch, *, on_shard=None):
    """Forward-only shard queue: promote each shard, apply it, thread the
    boundary activation — shared by ``SpilledInference`` and the session
    API's ``EvalJob``.  Returns ``(logits, bytes_moved)``; ``on_shard``
    fires after each shard unit."""
    batch = as_tensors(batch, store.device)
    act: dict = {}
    moved = 0
    for shard in partition.shards:
        own, shared = store.promote_shard_params(shard)
        moved += store.shard_transfer_bytes(shard, train=False)
        with tracing.span("hydra.fwd", shard=shard.index):
            act, _ = fns.fwd(shard)(own, shared, act, batch)
        if on_shard is not None:
            on_shard(shard)
    return act["logits"], moved


class SpilledInference:
    """Forward-only execution of a larger-than-device model through the
    shard queue: each shard's params are promoted, applied, and dropped —
    a model bounded only by host DRAM runs inference on one device.

        infer = SpilledInference(cfg, params, device_budget_bytes=...)
        logits = infer(batch)
    """

    def __init__(self, cfg, params, *, device_budget_bytes: int,
                 batch: int = 2, seq: int = 128,
                 buffer_frac: float = 0.05, device="cuda"):
        self.cfg = cfg
        self.plan = sg.build_plan(cfg)
        host = sg.prepare_host_params(cfg, to_host(params))
        self.partition = pt.partition(
            cfg, host, self.plan, budget_bytes=device_budget_bytes,
            batch=batch, seq=seq, buffer_frac=buffer_frac, train=False)
        # inference transfers exclude grads/optimizer state
        self.store = HostModelStore(cfg, self.plan, params,
                                    opt.OptimizerConfig(grad_clip=0.0),
                                    self.partition, device=device,
                                    train=False)
        self.fns = ShardFunctions(cfg, self.plan, self.partition,
                                  opt.OptimizerConfig(grad_clip=0.0))
        self.bytes_moved = 0

    @property
    def n_shards(self) -> int:
        return len(self.partition.shards)

    def __call__(self, batch):
        """batch -> logits, running the shard queue forward-only."""
        logits, moved = spilled_forward(self.store, self.fns,
                                        self.partition, batch)
        self.bytes_moved += moved
        return logits

    def loss(self, batch):
        from repro_torch.training.losses import softmax_xent
        logits = self(batch)
        return softmax_xent(logits, as_tensors(batch, logits.device)["labels"])


# ---------------------------------------------------------------------------
# sequential reference (the "no effect on accuracy" oracle)
# ---------------------------------------------------------------------------

def train_sequential_reference(task: ModelTask,
                               device="cuda") -> tuple[Any, list]:
    """Plain full-model training on ``device`` — Hydra must reproduce its
    losses."""
    from repro_torch.models import api
    from repro_torch.training.train_loop import make_train_step
    device = resolve_device(device)
    cfg = task.cfg
    params = to_device(task.params, device) if task.params is not None \
        else api.init_params(cfg, torch.Generator(device).manual_seed(
            task.seed), device)
    ocfg = task.opt_config()
    state = opt.init_state(ocfg, params)
    step = make_train_step(cfg, ocfg)
    losses = []
    it = iter(task.dataloader)
    for _ in range(task.epochs * task.steps_per_epoch):
        batch = as_tensors(next(it), device)
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return params, losses
