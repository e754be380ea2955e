"""Model-as-a-queue-of-segments: the structural substrate for Hydra (port
of ``repro.core.shard_graph``: the dense and vlm plans, the MoE plan
(the dense plan's segments, with the layers' aux sums carried in the
activation), the ssm plan (one segment per xLSTM group), the hybrid
plan (one segment per Mamba2 layer, the shared attention block a shared
group) and the audio plan (frontend, one segment per encoder layer, the
bridge, one per decoder layer, head; the encoder output rides through
the decoder segments)).

A *segment* is the finest cut-point granularity (one layer, or the embed /
head ends).  The partitioner groups contiguous segments into *shards*;
SHARP schedules *shard units* (forward or backward of one shard on one
mini-batch).

Two parameter classes:

* **own** params — spillable; live host-side, promoted with their shard,
  optimizer-stepped right after the shard's backward unit.
* **shared** params — referenced by more than one segment (the tied
  embedding table; zamba2's shared attention block).  One host copy, promoted alongside any shard that
  references it; gradients accumulate across backward units and step once
  when the model's mini-batch completes.

Segments pass a dict ``act`` of tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs import torch_dtype
from repro_torch.models import encdec, hybrid, moe, ssm, transformer
from repro_torch.models import layers as nn
from repro_torch.training.losses import softmax_xent
from repro_torch.tree import tree_map

Act = Any
ParamTree = Any


@dataclass(frozen=True)
class Segment:
    """One cut-point unit of a model.

    apply(cfg, own_params, shared_params: dict, act, batch) -> act
    """
    name: str
    param_ref: Optional[tuple]        # ref for own params (None = stateless)
    shared: tuple                      # names of shared param groups used
    apply: Callable[..., Act]
    flops_weight: float = 1.0          # relative cost hint (pilot fallback)


@dataclass
class ShardPlan:
    cfg: Any
    segments: list[Segment]
    shared_refs: dict[str, tuple]      # name -> ref into the full param tree
    loss: Callable[..., torch.Tensor]  # loss(cfg, act, batch)


# ---------------------------------------------------------------------------
# param_ref resolution (host trees are dicts of stacked tensors)
# ---------------------------------------------------------------------------

def resolve_ref(params: ParamTree, ref: Optional[tuple]):
    """The subtree ``ref`` names; a ``stack_slice`` ref gives views of rows
    ``[lo, hi)`` of the stacked tensors (no copy)."""
    if ref is None:
        return None
    if len(ref) == 4 and ref[0] == "stack_slice":
        _, key, lo, hi = ref
        return tree_map(lambda a: a[lo:hi], params[key])
    node = params
    for k in ref:
        node = node[k]
    return node


def merge_stack_slices(refs: list) -> list[tuple]:
    """``refs`` in order, each run of ``stack_slice`` refs to neighbouring
    rows of one stacked tree merged into one: ``[(ref, rows)]``, where
    ``rows`` lists each merged ref's rows of the merged slice (``None``
    for a ref that is no stack slice).  ``unmerge`` undoes it."""
    runs: list[tuple] = []
    for ref in refs:
        if ref is None or len(ref) != 4 or ref[0] != "stack_slice":
            runs.append((ref, None))
            continue
        _, key, lo, hi = ref
        last = runs[-1][0] if runs and runs[-1][1] is not None else None
        if last is not None and last[1] == key and last[3] == lo:
            rows = runs[-1][1] + [(lo - last[2], hi - last[2])]
            runs[-1] = (("stack_slice", key, last[2], hi), rows)
        else:
            runs.append((ref, [(0, hi - lo)]))
    return runs


def unmerge(runs: list[tuple], values) -> tuple:
    """The values of the refs ``merge_stack_slices`` merged, in their
    order, from the values of the merged refs: each merged ref's rows of
    a merged slice are views of it."""
    out = []
    for (_, rows), value in zip(runs, values):
        if rows is None:
            out.append(value)
        else:
            out.extend(tree_map(lambda t: t[lo:hi], value)
                       for lo, hi in rows)
    return tuple(out)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    # a blocking copy: the host tensor is final when this returns
    dst.copy_(src)


def update_with_ref(params: ParamTree, ref: tuple, new_val) -> ParamTree:
    """Write ``new_val`` back at ``ref`` into the host tree, in place (the
    host tensors keep their storage, pinned where they were pinned)."""
    if ref is None:
        return params
    if len(ref) == 4 and ref[0] == "stack_slice":
        _, key, lo, hi = ref
        tree_map(lambda dst, src: _copy_into(dst[lo:hi], src),
                 params[key], new_val)
        return params
    node = params
    for k in ref[:-1]:
        node = node[k]
    tree_map(_copy_into, node[ref[-1]], new_val)
    return params


# ---------------------------------------------------------------------------
# family shard plans
# ---------------------------------------------------------------------------

def _xent_loss(cfg, act, batch):
    loss = softmax_xent(act["logits"], batch["labels"])
    if "aux" in act:
        # act carries per-layer sums; the reference loss uses layer means
        loss = loss + (0.01 * act["aux"]["lb"]
                       + 1e-3 * act["aux"]["z"]) / cfg.n_layers
    return loss


def _dense_plan(cfg) -> ShardPlan:
    def embed_apply(cfg, own, shared, act, batch):
        x = transformer.embed_inputs(cfg, {"embed": shared["embed"]}, batch)
        return {"x": x}

    def layer_apply(cfg, own, shared, act, batch):
        return {"x": transformer.apply_layer_range(cfg, own, act["x"])}

    def head_apply(cfg, own, shared, act, batch):
        x = transformer._norm(cfg, own, act["x"])
        return {"logits": nn.unembed(shared["embed"], x)}

    segs = [Segment("embed", None, ("embed",), embed_apply, 0.1)]
    for i in range(cfg.n_layers):
        segs.append(Segment(f"layer{i}", ("stack_slice", "layers", i, i + 1),
                            (), layer_apply))
    segs.append(Segment("head", ("final_norm",), ("embed",), head_apply, 0.5))
    return ShardPlan(cfg, segs, {"embed": ("embed",)}, _xent_loss)


def _moe_plan(cfg) -> ShardPlan:
    def embed_apply(cfg, own, shared, act, batch):
        x = transformer.embed_inputs(cfg, {"embed": shared["embed"]}, batch)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return {"x": x, "aux": {"lb": zero, "z": zero}}

    def layer_apply(cfg, own, shared, act, batch):
        x, aux = moe.apply_layer_range(cfg, own, act["x"])
        return {"x": x, "aux": {"lb": act["aux"]["lb"] + aux["lb_loss"],
                                "z": act["aux"]["z"] + aux["z_loss"]}}

    def head_apply(cfg, own, shared, act, batch):
        x = nn.rms_norm(own, act["x"])
        return {"logits": nn.unembed(shared["embed"], x), "aux": act["aux"]}

    segs = [Segment("embed", None, ("embed",), embed_apply, 0.1)]
    for i in range(cfg.n_layers):
        segs.append(Segment(f"layer{i}", ("stack_slice", "layers", i, i + 1),
                            (), layer_apply))
    segs.append(Segment("head", ("final_norm",), ("embed",), head_apply, 0.5))
    return ShardPlan(cfg, segs, {"embed": ("embed",)}, _xent_loss)


def _slice1(lp):
    return tree_map(lambda a: a[0], lp)


def _embed_apply(cfg, own, shared, act, batch):
    return {"x": nn.embed(shared["embed"], batch["tokens"],
                          torch_dtype(cfg.dtype))}


def _rms_head_apply(cfg, own, shared, act, batch):
    x = nn.rms_norm(own, act["x"])
    return {"logits": nn.unembed(shared["embed"], x)}


def _ssm_plan(cfg) -> ShardPlan:
    def group_apply(cfg, own, shared, act, batch):
        return {"x": ssm.apply_layer_range(cfg, own, act["x"])}

    segs = [Segment("embed", None, ("embed",), _embed_apply, 0.1)]
    for i in range(ssm.n_groups(cfg)):
        segs.append(Segment(f"group{i}", ("stack_slice", "layers", i, i + 1),
                            (), group_apply, 2.0))
    segs.append(Segment("head", ("final_norm",), ("embed",), _rms_head_apply,
                        0.5))
    return ShardPlan(cfg, segs, {"embed": ("embed",)}, _xent_loss)


def hybrid_layer_apply(use_attn: bool, *, use_kernel: bool = False):
    """The segment apply of one hybrid layer: a Mamba2 layer, then the
    shared block where ``use_attn``.  ``use_kernel`` is
    ``ssm.mamba2_forward``'s switch; ``build_plan`` never sets it, as the
    JAX package's plan does not."""
    def layer_apply(cfg, own, shared, act, batch):
        lp = _slice1(own)
        x = act["x"]
        x = x + ssm.mamba2_forward(lp["mamba"], nn.rms_norm(lp["norm"], x),
                                   cfg, use_kernel=use_kernel)
        if use_attn:
            x, _ = hybrid.apply_shared_attn(cfg, shared["attn"], x)
        return {"x": x}

    return layer_apply


def _hybrid_plan(cfg) -> ShardPlan:
    flags = np.asarray(hybrid.attn_flags(cfg))
    segs = [Segment("embed", None, ("embed",), _embed_apply, 0.1)]
    for i in range(cfg.n_layers):
        shared_names = ("attn",) if flags[i] else ()
        segs.append(Segment(f"mamba{i}", ("stack_slice", "layers", i, i + 1),
                            shared_names, hybrid_layer_apply(bool(flags[i])),
                            2.0 if flags[i] else 1.0))
    segs.append(Segment("head", ("final_norm",), ("embed",), _rms_head_apply,
                        0.5))
    return ShardPlan(cfg, segs,
                     {"embed": ("embed",), "attn": ("shared_attn",)},
                     _xent_loss)


def _audio_plan(cfg) -> ShardPlan:
    def front_apply(cfg, own, shared, act, batch):
        return {"enc_x": encdec.encoder_inputs(cfg, batch["enc_embeds"])}

    def enc_layer_apply(cfg, own, shared, act, batch):
        return {"enc_x": encdec.apply_enc_layer(cfg, _slice1(own),
                                                act["enc_x"])}

    def bridge_apply(cfg, own, shared, act, batch):
        dt = torch_dtype(cfg.dtype)
        enc = nn.layer_norm(own["enc_final_norm"], act["enc_x"])
        tokens = batch["tokens"]
        x = nn.embed(shared["embed"], tokens, dt)
        x = x + own["dec_pos"][:tokens.shape[1]].to(dt)[None]
        return {"x": x, "enc": enc}

    def dec_layer_apply(cfg, own, shared, act, batch):
        x = encdec.apply_dec_layer(cfg, _slice1(own), act["x"], act["enc"])
        # the pass-through makes autograd sum every decoder layer's
        # cross-attention gradient into the encoder output
        return {"x": x, "enc": act["enc"]}

    def head_apply(cfg, own, shared, act, batch):
        x = nn.layer_norm(own, act["x"])
        return {"logits": nn.unembed(shared["embed"], x)}

    segs = [Segment("frontend", None, (), front_apply, 0.1)]
    for i in range(cfg.n_encoder_layers):
        segs.append(Segment(f"enc{i}", ("stack_slice", "encoder", i, i + 1),
                            (), enc_layer_apply))
    segs.append(Segment("bridge", ("bridge_group",), ("embed",),
                        bridge_apply, 0.1))
    for i in range(cfg.n_layers):
        segs.append(Segment(f"dec{i}", ("stack_slice", "decoder", i, i + 1),
                            (), dec_layer_apply, 1.5))
    segs.append(Segment("head", ("final_norm",), ("embed",), head_apply, 0.5))
    return ShardPlan(cfg, segs, {"embed": ("embed",)}, _xent_loss)


def prepare_host_params(cfg, params) -> ParamTree:
    """Family-specific host-tree tweaks: the audio family's bridge
    segment owns ``enc_final_norm`` and ``dec_pos`` as one
    ``bridge_group``."""
    params = dict(params)
    if cfg.family == "audio" and "bridge_group" not in params:
        params["bridge_group"] = {
            "enc_final_norm": params.pop("enc_final_norm"),
            "dec_pos": params.pop("dec_pos"),
        }
    return params


def restore_model_params(cfg, host_params) -> ParamTree:
    """Inverse of prepare_host_params (for checkpoint / reference compare)."""
    params = dict(host_params)
    if cfg.family == "audio" and "bridge_group" in params:
        grp = params.pop("bridge_group")
        params["enc_final_norm"] = grp["enc_final_norm"]
        params["dec_pos"] = grp["dec_pos"]
    return params


@functools.lru_cache(maxsize=None)
def build_plan(cfg) -> ShardPlan:
    if cfg.family in ("dense", "vlm"):
        return _dense_plan(cfg)
    if cfg.family == "moe":
        return _moe_plan(cfg)
    if cfg.family == "ssm":
        return _ssm_plan(cfg)
    if cfg.family == "hybrid":
        return _hybrid_plan(cfg)
    if cfg.family == "audio":
        return _audio_plan(cfg)
    raise ValueError(cfg.family)
