"""Optimizers (AdamW / SGD-momentum / Lion) + LR schedules (port of
``repro.optim.optimizers``).

Optimizer state is a tree mirroring the params, and ``update`` is a pure
function that works on any sub-tree, so Hydra steps a shard's params and
its state slice on the device while the rest of the model is spilled.
``update_`` steps in place, for SHARP's promoted copies: a unit's step
then holds one leaf's temporaries instead of a second copy of the
shard's params and moments.  ``update`` runs it on copies and writes
nothing it was given.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # adamw | sgd | lion
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9          # sgd
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    schedule: str = "constant"     # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def schedule_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` as an f32 scalar tensor (on the step's
    device when ``step`` is a tensor)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, dtype=torch.float32, device=dev)
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.schedule == "constant":
        return lr
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule in ("linear_warmup_cosine", "cosine"):
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        floor = cfg.min_lr_ratio
        return lr * warm * (floor + (1 - floor) * cos)
    raise ValueError(cfg.schedule)


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def init_state(cfg: OptimizerConfig, params) -> dict:
    def zeros():
        return tree_map(torch.zeros_like, params)
    if cfg.kind == "adamw":
        return {"mu": zeros(), "nu": zeros(), "step": _step_zero(params)}
    if cfg.kind == "sgd":
        return {"mom": zeros(), "step": _step_zero(params)}
    if cfg.kind == "lion":
        return {"mu": zeros(), "step": _step_zero(params)}
    raise ValueError(cfg.kind)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm, precomputed_norm=None):
    norm = precomputed_norm if precomputed_norm is not None \
        else global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def update(cfg: OptimizerConfig, params, grads, state, *,
           grad_norm: Optional[torch.Tensor] = None):
    """One optimizer step; returns ``(new_params, new_state)``, all new
    tensors.  Works on any (sub-)tree — Hydra steps per shard.

    ``grad_norm``: pass the *global* norm when stepping a shard so clipping
    matches full-model training exactly.
    """
    return update_(cfg, tree_map(torch.clone, params), grads,
                   tree_map(torch.clone, state), grad_norm=grad_norm)


def update_(cfg: OptimizerConfig, params, grads, state, *,
            grad_norm: Optional[torch.Tensor] = None):
    """``update`` in place: the new params and state are written into the
    tensors of ``params`` and ``state``, leaf by leaf, and returned.  A
    step holds one leaf's temporaries.  For tensors the caller owns:
    SHARP's promoted copies, never a master copy."""
    with tracing.span("hydra.opt_step"):
        if cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
        step = state["step"] + 1
        lr = schedule_lr(cfg, step)
        ps, gs = tree_leaves(params), tree_leaves(grads)

        if cfg.kind == "adamw":
            b1, b2 = cfg.b1, cfg.b2
            t = step.float()
            bc1 = 1 - torch.pow(b1, t)
            bc2 = 1 - torch.pow(b2, t)
            for p, m, v, g in zip(ps, tree_leaves(state["mu"]),
                                  tree_leaves(state["nu"]), gs):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
                denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
                upd = torch.div(m, bc1).div_(denom)
                del denom
                upd.add_(cfg.weight_decay * p).mul_(lr)
                p.sub_(upd)
        elif cfg.kind == "sgd":
            for p, m, g in zip(ps, tree_leaves(state["mom"]), gs):
                m.mul_(cfg.momentum).add_(g)
                p.sub_(torch.add(m, cfg.weight_decay * p).mul_(lr))
        elif cfg.kind == "lion":
            b1, b2 = cfg.b1, cfg.b2
            for p, m, g in zip(ps, tree_leaves(state["mu"]), gs):
                direction = torch.sign(b1 * m + (1 - b1) * g)
                p.sub_(direction.add_(cfg.weight_decay * p).mul_(lr))
                m.mul_(b2).add_((1 - b2) * g)
        else:
            raise ValueError(cfg.kind)
        state["step"].copy_(step)
    return params, state
