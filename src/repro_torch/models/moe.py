"""Mixture-of-Experts decoder, Mixtral / DBRX class (port of
``repro.models.moe``) on one device.

The expert layer routes each token to its top-k experts with switch-style
capacity-bounded dropping: each batch row is a routing group with its own
capacity ``C``, a token's (expert, slot) position is counted slot-major
(every token's first choice before any token's second), and tokens past
``C`` are dropped.  Kept tokens are scattered into a dense ``(b, E, C,
d)`` buffer so the expert products are three batched ``einsum``s, then
gathered back and summed with their gate weights.  The JAX package has
no Pallas kernel here (its dispatch and products are ``einsum``s XLA
compiles), so neither does the port.

Over a device mesh (``sharding.context.activation_axes``) the layer
takes one of two paths, as in the JAX package.  The propagated path runs
the code above on DTensors, with the dispatch buffers pinned to (data,
model) by ``constrain_expert``; it is the one training takes.  The
expert-parallel path (``_moe_mlp_shardmap``, forward only, where JAX
uses ``shard_map``) gives every 'model'-axis member ``E / model`` experts
and exchanges member-local ``(b_loc, E, C, d)`` dispatch buffers with
``all_to_all_single`` over the 'model' group.

Aux losses (load balance and router z-loss, and the dropped fraction)
come back beside the output; the train step and the shard plan add them
to the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import _n_stacked, layer_slices
from repro_torch.sharding.context import (constrain_batch, constrain_expert,
                                          gather_fsdp)

MOE_SEQ_CHUNK = 1024


# ---------------------------------------------------------------------------
# expert MLP bank + router
# ---------------------------------------------------------------------------

def init_moe_mlp(generator, cfg, device, lead=()) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pdt = torch_dtype(cfg.param_dtype)
    return {
        "router": nn.dense_init(generator, (*lead, d, E), d, pdt, device),
        "w_gate": nn.dense_init(generator, (*lead, E, d, f), d, pdt, device),
        "w_up": nn.dense_init(generator, (*lead, E, d, f), d, pdt, device),
        "w_down": nn.dense_init(generator, (*lead, E, f, d), f, pdt, device),
    }


def expert_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens``, padded up to a
    multiple of 8 (the pad decides which tokens drop)."""
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def moe_mlp(params, x, cfg):
    """x: (b, s, d) -> (y, aux).  A sequence longer than the chunk (and a
    multiple of it) is routed chunk by chunk, so the dispatch buffers stay
    near 16k tokens; the aux terms are then the means over the chunks, as
    the JAX package's ``scan`` gives them."""
    b, s, d = x.shape
    chunk = min(MOE_SEQ_CHUNK, max(256, 16384 // max(b, 1)))
    if s <= chunk or s % chunk != 0:
        return _moe_dispatch(params, x, cfg)
    ys, auxs = [], []
    for i in range(0, s, chunk):
        y, aux = _moe_dispatch(params, x[:, i:i + chunk], cfg)
        ys.append(y)
        auxs.append(aux)
    aux = {k: torch.stack([a[k] for a in auxs]).mean(0) for k in auxs[0]}
    return torch.cat(ys, dim=1), aux


def _shardmap_applicable(cfg, batch_size: int):
    """The expert-parallel all_to_all path's mesh: a mesh context is
    active with its MoE path on, the 'model' axis divides the expert
    count, and the batch divides the data axes; else None."""
    from repro_torch.sharding.context import _STATE
    from repro_torch.sharding.specs import (_axis_size, axis_names,
                                            axis_sizes, batch_axes)
    mesh = _STATE.get("mesh")
    if mesh is None or "model" not in axis_names(mesh):
        return None
    if not _STATE.get("moe_shardmap", True):
        return None
    if cfg.n_experts % axis_sizes(mesh)["model"] != 0:
        return None
    if batch_size % _axis_size(mesh, batch_axes(mesh)) != 0:
        return None
    return mesh


def _moe_dispatch(params, x, cfg):
    mesh = _shardmap_applicable(cfg, x.shape[0])
    if mesh is not None:
        return _moe_mlp_shardmap(params, x, cfg, mesh)
    return _moe_mlp_inner(params, x, cfg)


def _routing(x, router, cfg, batch_mean=None):
    """Top-k routing and each (token, slot)'s position within its expert
    (group-local, slot-major).  Returns (gate_vals (b, s, K) f32,
    expert_idx (b, s, K) int64, pos_in_expert (b, s, K) int64, keep (b, s,
    K) bool, C, aux).  ``batch_mean`` turns a mean over these rows into
    the mean over the whole batch (the expert-parallel path, where each
    rank routes its own rows)."""
    batch_mean = batch_mean or (lambda t: t)
    b, s, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, s)
    logits = (x @ router.to(x.dtype)).float()                    # (b,s,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = F.one_hot(expert_idx, E)                            # (b,s,K,E)
    slotmajor = onehot.transpose(1, 2).reshape(b, K * s, E)
    pos = torch.cumsum(slotmajor, dim=1) - slotmajor
    pos = pos.reshape(b, K, s, E).transpose(1, 2)                # (b,s,K,E)
    pos_in_expert = torch.gather(pos, -1, expert_idx[..., None])[..., 0]
    keep = pos_in_expert < C
    density = batch_mean(
        F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1)))
    router_prob = batch_mean(probs.mean(dim=(0, 1)))
    aux = {"lb_loss": E * torch.sum(density * router_prob),
           "z_loss": batch_mean(
               torch.logsumexp(logits, dim=-1).square().mean()),
           "frac_dropped": 1.0 - batch_mean(keep.float().mean())}
    return gate_vals, expert_idx, pos_in_expert, keep, C, aux


def _scatter(x, expert_idx, pos_in_expert, keep, C: int, E: int):
    """The (b, E, C, d) dispatch buffer: kept tokens have unique (expert,
    position) pairs; every dropped one lands on row E, position 0, which
    is cut off (the JAX package's ``.set(mode="drop")``)."""
    b, s, d = x.shape
    K = expert_idx.shape[-1]
    flat_e = torch.where(keep, expert_idx, E)
    pos_c = torch.where(keep, pos_in_expert, 0)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * K)
    buf = x.new_zeros((b, E + 1, C, d))
    buf = buf.index_put((rows, flat_e.reshape(b, -1), pos_c.reshape(b, -1)),
                        x[:, :, None].expand(b, s, K, d).reshape(b, -1, d))
    return buf[:, :E]


def _gather_slots(yexp, expert_idx, pos_in_expert, keep):
    """Each (token, slot)'s row of the (b, E, C, d) expert output:
    (b, s, K, d); a dropped slot reads a clamped row the caller masks."""
    b, E, C, d = yexp.shape
    s, K = expert_idx.shape[1:]
    flat_e = torch.where(keep, expert_idx, E)
    slot = flat_e.clamp(0, E - 1) * C + pos_in_expert.clamp(0, C - 1)
    rows = torch.arange(b, device=yexp.device)[:, None].expand(b, s * K)
    return yexp.reshape(b, E * C, d)[rows, slot.reshape(b, -1)] \
        .reshape(b, s, K, d)


def _moe_mlp_shardmap(params, x, cfg, mesh):
    """Expert parallelism with explicit all_to_all (the JAX package's
    ``shard_map`` path), forward only.

    Every 'model'-axis member owns E/model experts.  Each rank routes its
    own batch rows (the data-axis shard), dispatches them into a
    member-local (b_loc, E, C, d) buffer, exchanges it over the 'model'
    group (each member receives the slots destined for its experts from
    all peers), computes with its local expert weights, and exchanges
    back; all indexing is member-local.  ``x`` is a DTensor (its rows are
    redistributed to the batch axes) or a plain tensor holding the whole
    batch on every rank (then ``y`` is gathered back whole).  The aux
    terms are the whole batch's means, reduced over the data axes."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.sharding.specs import (P, _axis_size, axis_names,
                                            axis_sizes, batch_axes,
                                            shard_index, spec_placements)

    b, d = x.shape[0], x.shape[-1]
    E = cfg.n_experts
    M = axis_sizes(mesh)["model"]
    e_per = E // M
    B = batch_axes(mesh)
    data_axes = B if isinstance(B, tuple) else (B,)
    row_place = spec_placements(mesh, P(B, None, None))
    model_group = mesh.get_group("model")

    di, nd = shard_index(mesh, data_axes), _axis_size(mesh, data_axes)
    if isinstance(x, DTensor):
        xb = x.redistribute(mesh, row_place).to_local()
    else:
        xb = x[di * (b // nd):(di + 1) * (b // nd)]
    bl = xb.shape[0]
    # the data shards' means, averaged: a Partial sum over the data axes
    part = [Partial() if a in data_axes else Replicate()
            for a in axis_names(mesh)]

    def batch_mean(t):
        return DTensor.from_local(t / nd, mesh, part,
                                  run_check=False).full_tensor()

    def whole(w):
        return w.full_tensor() if isinstance(w, DTensor) else w

    def local_experts(w):
        if isinstance(w, DTensor):
            return w.redistribute(
                mesh, spec_placements(mesh, P("model", None, None))
            ).to_local()
        m = shard_index(mesh, "model")
        return w[m * e_per:(m + 1) * e_per]

    gate_vals, expert_idx, pos_in_expert, keep, C, aux = _routing(
        xb, whole(params["router"]), cfg, batch_mean)
    dt = xb.dtype

    buf = _scatter(xb, expert_idx, pos_in_expert, keep, C, E)

    # exchange: dim 0 = destination member (owner of the expert group)
    send = buf.reshape(bl, M, e_per, C, d).transpose(0, 1).contiguous()
    recv = funcol.wait_tensor(funcol.all_to_all_single(
        send, None, None, model_group))            # (M_src, bl, e_per, C, d)
    wg, wu, wd = (local_experts(params[k]).to(dt)
                  for k in ("w_gate", "w_up", "w_down"))
    g = torch.einsum("mbjcd,jdf->mbjcf", recv, wg)
    u = torch.einsum("mbjcd,jdf->mbjcf", recv, wu)
    yexp = torch.einsum("mbjcf,jfd->mbjcd", F.silu(g) * u, wd).contiguous()
    # exchange back: dim 0 returns to the source member
    back = funcol.wait_tensor(funcol.all_to_all_single(
        yexp, None, None, model_group))            # (M, bl, e_per, C, d)
    yfull = back.transpose(0, 1).reshape(bl, E, C, d)

    # member-local combine
    gathered = _gather_slots(yfull, expert_idx, pos_in_expert, keep)
    gathered = torch.where(keep[..., None], gathered, 0)
    y = torch.sum(gathered * gate_vals[..., None].to(dt), dim=2)

    if isinstance(x, DTensor):
        return DTensor.from_local(y, mesh, row_place, run_check=False), aux
    # all_gather_single is all_gather_tensor's newer name
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    for a in reversed(data_axes):               # minor axis first
        y = gather(y, 0, mesh.get_group(a))
    return funcol.wait_tensor(y), aux


def _moe_mlp_inner(params, x, cfg):
    """x: (b, s, d) -> (y, aux) with aux {"lb_loss", "z_loss",
    "frac_dropped"}; each batch row is a routing group (GShard-style)."""
    E = cfg.n_experts
    gate_vals, expert_idx, pos_in_expert, keep, C, aux = _routing(
        x, params["router"], cfg)

    buf = constrain_expert(_scatter(x, expert_idx, pos_in_expert, keep,
                                    C, E))        # (b,E,C,d): b@data, E@model

    dt = x.dtype
    g = torch.einsum("becd,edf->becf", buf, params["w_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
    h = constrain_expert(F.silu(g) * u)                          # (b,E,C,f)
    yexp = constrain_expert(torch.einsum("becf,efd->becd", h,
                                         params["w_down"].to(dt)))

    # combine: each (token, slot) reads its row back, weighted by its gate
    gathered = constrain_batch(
        _gather_slots(yexp, expert_idx, pos_in_expert, keep),
        seq_parallel=False)
    gathered = torch.where(keep[..., None], gathered, 0)
    y = torch.sum(gathered * gate_vals[..., None].to(dt), dim=2)
    return y, aux


# ---------------------------------------------------------------------------
# blocks / model
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator``, laid out as the JAX package
    lays them out: per-layer expert stacks ``(L, E, d, f)`` and router
    ``(L, d, E)``.  The numbers differ from JAX's for the same seed."""
    device = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    L = (cfg.n_layers,)
    return {
        "embed": nn.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   pdt, device),
        "layers": {
            "attn_norm": nn.init_rmsnorm(cfg.d_model, pdt, device, L),
            "attn": nn.init_attention(generator, cfg, device, L),
            "mlp_norm": nn.init_rmsnorm(cfg.d_model, pdt, device, L),
            "moe": init_moe_mlp(generator, cfg, device, L),
        },
        "final_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
    }


def apply_layer(cfg, lp, x, *, window=None):
    """One pre-norm block (cache-free): attention, then the expert layer.
    Returns (x, aux)."""
    lp = gather_fsdp(lp)
    x = constrain_batch(x, seq_parallel=False)
    xn = constrain_batch(nn.rms_norm(lp["attn_norm"], x), seq_parallel=False)
    h, _ = nn.attention(lp["attn"], xn, cfg,
                        causal=cfg.causal,
                        window=window if window is not None else cfg.window,
                        impl=cfg.attn_impl)
    x = x + h
    xn = constrain_batch(nn.rms_norm(lp["mlp_norm"], x), seq_parallel=False)
    y, aux = moe_mlp(lp["moe"], xn, cfg)
    return x + y, aux


def apply_layer_range(cfg, stacked_slice, x, *, window=None, remat=None):
    """Apply a contiguous slice of stacked layers (a Hydra shard unit).
    Returns (x, {"lb_loss", "z_loss"}), each the mean over the slice's
    layers.  ``remat`` (default ``cfg.remat``) checkpoints each layer when
    autograd records."""
    remat = cfg.remat if remat is None else remat
    lbs, zs = [], []
    for lp in layer_slices(stacked_slice, _n_stacked(stacked_slice)):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(lambda lp_, h: apply_layer(cfg, lp_, h,
                                                           window=window),
                                lp, x, use_reentrant=False)
        else:
            x, aux = apply_layer(cfg, lp, x, window=window)
        x = constrain_batch(x)
        lbs.append(aux["lb_loss"])
        zs.append(aux["z_loss"])
    return x, {"lb_loss": torch.stack(lbs).mean(),
               "z_loss": torch.stack(zs).mean()}


def forward(cfg, params, batch, *, window=None, return_aux=False,
            last_only=False):
    x = tfm.embed_inputs(cfg, params, batch)
    x, aux = apply_layer_range(cfg, params["layers"], x, window=window)
    if last_only:
        x = x[:, -1:]
    x = nn.rms_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    return (logits, aux) if return_aux else logits


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    return {"kv": nn.init_kv_cache(cfg, batch, max_seq,
                                   resolve_device(device))}


def decode_step(cfg, params, state, tokens, *, window=None):
    """One decode step over a contiguous cache, as the dense family's
    (``transformer.decode_step``: the cache is written in place, the index
    an int or a (b,) tensor), with the expert layer in place of SwiGLU.
    Each row routes alone, so one token per lane (C = 8) never drops and
    lanes never couple."""
    x = nn.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    kv = state["kv"]
    win = window if window is not None else cfg.window
    positions = tfm._chunk_positions(kv["index"], x.shape[0], x.shape[1],
                                     x.device)
    for lp, k_l, v_l in zip(layer_slices(params["layers"], cfg.n_layers),
                            kv["k"], kv["v"]):
        lp = gather_fsdp(lp)
        cache = {"k": k_l, "v": v_l, "index": kv["index"]}
        a, _ = nn.attention(lp["attn"], nn.rms_norm(lp["attn_norm"], x),
                            cfg, cache, positions=positions, causal=True,
                            window=win)
        x = x + a
        y, _ = moe_mlp(lp["moe"], nn.rms_norm(lp["mlp_norm"], x), cfg)
        x = constrain_batch(x + y)
    x = nn.rms_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    return logits, {"kv": {"k": kv["k"], "v": kv["v"],
                           "index": kv["index"] + tokens.shape[1]}}


def _register():
    import sys

    from repro_torch.models import registry
    registry.register(registry.FamilySpec(
        family="moe", module=sys.modules[__name__],
        batched_prefill=True, padded_prefill=False, paging=False,
        pure_kv_state=True, servable=True,
        notes={
            "padded_prefill": "capacity-bounded expert routing couples "
                              "tokens: pad tokens consume expert capacity "
                              "and displace real tokens' routes",
            "paging": "expert capacity is a function of the token batch, "
                      "coupling decode lanes: a batched paged step would "
                      "not be token-identical to per-lane decode",
            "spec_draftable": "capacity-bounded routing couples the k "
                              "verified tokens: a multi-token verify would "
                              "route differently than token-by-token decode",
        },
        decode_state_cost=tfm._kv_state_bytes,
        kv_block_cost=tfm._kv_block_bytes))


_register()
