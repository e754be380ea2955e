"""Activation-sharding context (port of ``repro.sharding.context``).

Model code calls ``constrain_batch(x)``, ``constrain_q_seq(q)`` and
``constrain_expert(buf)`` at layer boundaries; launchers opt in with
``activation_axes(mesh)`` around a step.  Inside the context each call
``redistribute``s a DTensor activation to the first candidate layout that
fits its shape — the batch dim on the data axes, and where the rule says
so the sequence (or expert) dim on 'model' — which is what the JAX
package's ``with_sharding_constraint`` pins.  DTensor propagates layouts
op by op from the weights; without the pins it can keep an activation's
feature dims sharded over 'data' with the batch whole, as GSPMD did (the
JAX package measured +35 GB/device on yi-34b train_4k).

Outside the context, and on plain tensors, every call returns its input
unchanged: single-device paths and their tests are untouched.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Optional

from repro_torch.sharding.specs import (P, axis_names, batch_axes,
                                        fsdp_axes, spec_fits,
                                        spec_placements)
from repro_torch.tree import tree_map

_STATE: dict[str, Any] = {"mesh": None, "axes": None, "seq_parallel": True,
                          "moe_shardmap": True}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (cheap: no DTensor exists before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def activation_axes(mesh, *, seq_parallel: bool = True,
                    moe_shardmap: bool = True):
    """Enable activation constraints for the steps run inside the ctx.

    ``moe_shardmap``: take the explicit all_to_all expert-parallel MoE
    path (``models.moe._moe_mlp_shardmap``, forward only); the JAX
    package measured it leaner for prefill/decode, and its training path
    (the vjp) keeps the propagated layout."""
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["axes"] = batch_axes(mesh)
    _STATE["seq_parallel"] = seq_parallel
    _STATE["moe_shardmap"] = moe_shardmap
    try:
        yield
    finally:
        _STATE.update(prev)


def _pin(leaf, candidates):
    """``leaf`` redistributed to the first fitting candidate spec (a
    DTensor on the context's mesh), else unchanged."""
    if not is_dtensor(leaf):
        return leaf
    mesh = _STATE["mesh"]
    for spec in candidates:
        if spec_fits(mesh, spec, leaf.shape):
            placements = spec_placements(mesh, spec)
            if tuple(leaf.placements) == tuple(placements):
                return leaf
            return leaf.redistribute(leaf.device_mesh, placements)
    return leaf


def constrain_expert(x):
    """Pin MoE dispatch buffers (b, E, C, ...) to (data, model, ...):
    groups on the data axes, the expert axis on 'model' (expert
    parallelism) — without it the dispatch/hidden buffers stay whole on
    every device (the JAX package measured 60 GB/device on dbrx-132b
    prefill_32k)."""
    if _STATE["mesh"] is None:
        return x
    axes = _STATE["axes"]

    def one(leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim < 3:
            return leaf
        return _pin(leaf, (P(axes, "model", *([None] * (leaf.ndim - 2))),
                           P(axes, *([None] * (leaf.ndim - 1)))))

    return tree_map(one, x)


def constrain_q_seq(q):
    """Context parallelism for attention: shard the *query* sequence dim
    over 'model' (K/V stay whole).  GQA blocks head sharding whenever
    n_kv_heads < the model-axis size, and whole (sq, skv) score matrices
    are the next-largest temporary — q-seq sharding divides them by the
    model-axis size."""
    if _STATE["mesh"] is None or not hasattr(q, "ndim") or q.ndim != 4:
        return q
    if q.shape[1] <= 1:
        return q
    return _pin(q, (P(_STATE["axes"], "model", None, None),))


def constrain_batch(x, *, seq_parallel: Optional[bool] = None):
    """Pin dim 0 of every leaf to the data axes (a no-op outside the ctx,
    or when the batch dim doesn't divide the data axes).

    3D+ activations also shard dim 1 (sequence) over 'model' when it
    divides — sequence parallelism for the residual stream between
    layers; attention and the matmuls re-gather it (DTensor inserts the
    collectives) and norms run on it seq-sharded."""
    if _STATE["mesh"] is None:
        return x
    sp = _STATE.get("seq_parallel", True) if seq_parallel is None \
        else seq_parallel
    axes = _STATE["axes"]

    def one(leaf):
        if not hasattr(leaf, "ndim") or leaf.ndim == 0:
            return leaf
        cands = []
        if sp and leaf.ndim >= 3:
            cands.append(P(axes, "model", *([None] * (leaf.ndim - 2))))
        cands.append(P(axes, *([None] * (leaf.ndim - 1))))
        return _pin(leaf, cands)

    return tree_map(one, x)


def gather_fsdp(tree):
    """A layer's weights with their FSDP shards gathered: every DTensor
    leaf sharded over the FSDP axes ('pod', 'data') is all-gathered over
    them, its 'model' (tensor-parallel) shard kept — ZeRO-3, which the
    JAX package gets from GSPMD inside its layer scan.  Layer code calls
    it on one layer's weights inside the (rematerialized) layer, so one
    layer's gathered weights are live at a time and the backward gathers
    again.  A no-op outside the ctx and on plain tensors."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate, Shard
    F = fsdp_axes(mesh)
    fsdp = F if isinstance(F, tuple) else (F,)
    names = axis_names(mesh)

    def one(p):
        if not is_dtensor(p):
            return p
        new = tuple(Replicate() if names[i] in fsdp and isinstance(pl, Shard)
                    else pl for i, pl in enumerate(p.placements))
        if new == tuple(p.placements):
            return p
        return p.redistribute(p.device_mesh, new)

    return tree_map(one, tree)


def pointwise(fn, x):
    """``fn`` (elementwise) on each rank's shard of a DTensor — for the
    elementwise ops DTensor has no placement rule for (``log_sigmoid``'s
    backward); a pending sum is reduced first.  A plain tensor: ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())
