"""Train-step and serving-step factories (port of
``repro.training.train_loop``).

``make_train_step(cfg, opt_cfg)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``: gradients by autograd over the
whole model, then one optimizer update that returns new tensors;
``make_grad_step(cfg)`` stops at the gradients; ``make_train_step(...,
mesh=)`` trains over a device mesh on DTensors.  The serving factories
run under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import api, registry
from repro_torch.models import moe as moe_mod
from repro_torch.optim import optimizers as opt
from repro_torch.sharding.context import is_dtensor
from repro_torch.training.losses import (moe_total_loss, softmax_xent,
                                         vocab_whole)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def make_loss_fn(cfg, *, window: Optional[int] = None,
                 cast_layer_weights: bool = False):
    """``loss_fn(params, batch) -> (loss, metrics)``.

    ``cast_layer_weights``: cast the weight matrices to the compute dtype
    before use (``api.cast_weights``), so FSDP all-gathers move them in
    ``cfg.dtype`` rather than the f32 master copy.  The layer code casts
    per use anyway, so the numbers are the same, gradients included.  The
    JAX package casts every >= 2-D leaf of the stacked trees, the stacked
    norm scales too, which rounds their gradients to bf16; the port keeps
    the rule its serving path uses (norm scales and f32-at-use weights
    stay as they are), so a step over a mesh equals one without."""

    def maybe_cast(params):
        return api.cast_weights(cfg, params) if cast_layer_weights \
            else params

    def loss_fn(params, batch):
        params = maybe_cast(params)
        if cfg.family == "moe":
            logits, aux = moe_mod.forward(cfg, params, batch, window=window,
                                          return_aux=True)
            xent = softmax_xent(logits, batch["labels"])
            # over a mesh the loss is a plain tensor (``softmax_xent``);
            # the aux terms join it whole
            aux = {k: _full(v) for k, v in aux.items()}
            loss = moe_total_loss(xent, aux)
            return loss, {"loss": loss, "xent": xent,
                          "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}
        logits = api.forward(cfg, params, batch, window=window)
        loss = softmax_xent(logits, batch["labels"])
        return loss, {"loss": loss, "xent": loss}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """``(loss, metrics), grads`` of ``loss_fn`` at ``params`` (grads in the
    params' tree structure; a leaf the loss does not read gets zeros)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten_like(params, grads)


def make_train_step(cfg, opt_cfg: opt.OptimizerConfig, *,
                    window: Optional[int] = None, accum_steps: int = 1,
                    mesh=None):
    """Full train step; with ``accum_steps > 1`` the batch is split into
    micro-batches whose gradients are summed in f32 and averaged (gradient
    accumulation), as the JAX package's scan does.

    ``mesh`` (a ``DeviceMesh``): SPMD training over it.  The params and
    optimizer state are DTensors laid out by ``sharding.specs`` (the
    caller distributes them); each micro-batch is pinned to the mesh's
    batch axes — a plain batch (the same on every rank) is split there
    without communication, a DTensor batch is redistributed — and the
    stacked layer matrices are cast to ``cfg.dtype`` before use.  Grads
    come back in their params' placements (the reductions DTensor
    inserts), and ``global_norm`` and the optimizer update run on the
    DTensor leaves.  The returned metrics are plain tensors, the same on
    every rank."""
    loss_fn = make_loss_fn(cfg, window=window,
                           cast_layer_weights=mesh is not None)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                return _train_step(params, opt_state, batch)
        return _train_step(params, opt_state, batch)

    def grads_of(params, batch):
        (loss, m), g = _value_and_grad(loss_fn, params, pin_batch(batch))
        if mesh is not None:
            g = tree_map(_match_placements, g, params)
        return (loss, m), g

    def pin_batch(batch):
        if mesh is None:
            return batch
        from repro_torch.sharding import specs as sh
        return sh.distribute(mesh, batch, sh.batch_specs(cfg, batch, mesh))

    def _train_step(params, opt_state, batch):
        if accum_steps == 1:
            (_, metrics), grads = grads_of(params, batch)
        else:
            b = batch["labels"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps "
                                 f"{accum_steps}")
            mb = b // accum_steps
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            ms = []
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                (_, m), g = grads_of(params, micro)
                gsum = tree_map(torch.add, gsum, g)
                ms.append(m)
            grads = tree_map(lambda g: g / accum_steps, gsum)
            metrics = {k: torch.stack([_full(m[k]) for m in ms]).mean()
                       for k in ms[0]}
        gnorm = opt.global_norm(grads)
        new_params, new_state = opt.update(opt_cfg, params, grads, opt_state,
                                           grad_norm=gnorm)
        metrics = {k: _full(v) for k, v in metrics.items()}
        return new_params, new_state, dict(metrics, grad_norm=_full(gnorm))

    return train_step


def _full(x):
    """A DTensor metric as its full (plain) tensor; others unchanged."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _match_placements(g, p):
    """A gradient in its param's placements (a Partial sum reduced or
    reduce-scattered by DTensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor) and isinstance(g, DTensor) \
            and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_step(cfg, *, window: Optional[int] = None):
    """Gradient-only step (Hydra's shard executor owns the optimizer):
    ``grad_step(params, batch) -> (grads, metrics)``."""
    loss_fn = make_loss_fn(cfg, window=window)

    def grad_step(params, batch):
        (_, metrics), grads = _value_and_grad(loss_fn, params, batch)
        return grads, metrics

    return grad_step


def make_prefill_step(cfg, *, window: Optional[int] = None):
    """Prefill: full-sequence forward to the last position's logits (a
    batch of requests): ``prefill_step(params, batch) -> (b, V)``.  Only
    the last position is unembedded (``forward(..., last_only=True)``):
    serving samples from it, and the ``(b, s, V)`` logits are never
    made."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits = api.forward(cfg, params, batch, last_only=True,
                             window=window)
        return logits[:, -1, :]

    return prefill_step


def make_prefill_into_cache(cfg, *, window: Optional[int] = None):
    """Fill the decode cache/state with a whole prompt, returning the
    logits the first generated token is sampled from.

    Attention families consume the full ``(b, plen)`` prompt in ONE
    ``decode_step``: the KV write is one slice assignment of ``plen`` rows
    and the causal chunk mask keeps intra-prompt attention correct.
    Recurrent and hybrid states advance strictly token by token, so they
    fall back to a loop of one-token ``decode_step``s over the prompt
    (the JAX package's ``lax.scan``; here each step is eager) — same
    signature.  Returns ``prefill(params, state, tokens) -> (last_logits
    (b, V), state)``; the state's tensors are written in place."""
    if registry.spec(cfg).batched_prefill:
        @torch.no_grad()
        def prefill(params, state, tokens):
            logits, state = api.decode_step(cfg, params, state, tokens,
                                            window=window)
            return logits[:, -1, :], state

        return prefill

    @torch.no_grad()
    def prefill_steps(params, state, tokens):
        for t in range(tokens.shape[1]):
            logits, state = api.decode_step(cfg, params, state,
                                            tokens[:, t:t + 1],
                                            window=window)
        return logits[:, -1, :], state

    return prefill_steps


def _rewind_index(state, delta):
    """``state`` with every ``index`` leaf moved back by ``delta`` (the
    JAX package's ``tree_map_with_path`` over keys named ``index``)."""
    if isinstance(state, dict):
        return {k: (v - delta if k == "index" else _rewind_index(v, delta))
                for k, v in state.items()}
    return state


def make_padded_prefill_into_cache(cfg, *, window: Optional[int] = None):
    """Length-bucketed prefill: consume right-padded ``(n, bucket)`` prompts
    whose true lengths are ``lengths`` ((n,) int64), returning each row's
    logits at position ``length - 1`` and a state whose cache index is
    rewound to ``lengths`` — one write index per lane, where the JAX
    package vmaps the prefill over batch-1 states and rewinds each.

    Correctness rests on the same two properties as in the JAX package:
    the causal chunk mask keeps positions ``< length`` off the pad tail
    (masked scores get exactly zero weight), so the returned logits match
    an exact-length prefill; and decode attention masks keys at
    ``kvpos > qpos`` (contiguous) or past the lane's length (paged), so
    the pad tail's KV rows at ``[length, bucket)`` are never read before
    decode overwrites them.  Engines then prefill one shape per
    ``(n, bucket)`` instead of per ``(n, plen)``.

    Dense attention families only: recurrent and hybrid states advance
    through every consumed token and cannot be rewound past the pad tail.
    """
    if not registry.spec(cfg).padded_prefill:
        raise ValueError(
            f"{cfg.name} ({cfg.family}): padded prefill needs a rewindable "
            "KV cache and per-token-independent mixing "
            f"({registry.spec(cfg).why_not('padded_prefill')}); this "
            "family must prefill at exact length")

    @torch.no_grad()
    def prefill(params, state, tokens, lengths):
        logits, state = api.decode_step(cfg, params, state, tokens,
                                        window=window)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = logits[rows, lengths - 1]
        return last, _rewind_index(state, tokens.shape[1] - lengths)

    return prefill


def make_paged_decode_step(cfg, *, window: Optional[int] = None, impl=None):
    """One-token greedy decode through per-lane KV block tables.

    Returns ``step(params, pages, tables, lengths, tokens) -> next_tokens
    (n, 1) int32``; the pages are written in place (the JAX package
    donates them and gets an updated copy back)."""

    @torch.no_grad()
    def paged_step(params, pages, tables, lengths, tokens):
        logits = api.paged_decode_step(cfg, params, pages, tables, lengths,
                                       tokens, window=window, impl=impl)
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)

    return paged_step


def make_decode_step(cfg, *, window: Optional[int] = None):
    """One-token greedy decode against a contiguous KV cache.  Returns
    ``step(params, state, tokens (b, 1)) -> (next_tokens (b, 1) int32,
    state)``; the cache planes are written in place."""

    @torch.no_grad()
    def decode_step(params, state, tokens):
        logits, state = api.decode_step(cfg, params, state, tokens,
                                        window=window)
        if is_dtensor(logits):          # over a mesh: argmax a whole vocab
            logits = vocab_whole(logits)
        return (torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                .to(torch.int32), state)

    return decode_step


def make_verify_step(cfg, *, window: Optional[int] = None):
    """Speculative verify over the contiguous cache: tokens ``(b, k)`` (the
    last committed token + k-1 drafts) -> ``(greedy (b, k) int32, state)``,
    the target's greedy continuation at every draft position in ONE
    forward.  The cache advances k rows; the caller rewinds past the
    accept point (``api.rollback_decode_state``)."""

    @torch.no_grad()
    def verify(params, state, tokens):
        logits, state = api.verify_step(cfg, params, state, tokens,
                                        window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return verify


def make_paged_verify_step(cfg, *, window: Optional[int] = None, impl=None):
    """The paged twin of ``make_verify_step``: k positions per lane scored
    through block tables.  Returns ``step(params, pages, tables, lengths,
    tokens (n, k)) -> greedy (n, k) int32``; the pages are written in
    place."""

    @torch.no_grad()
    def verify(params, pages, tables, lengths, tokens):
        logits = api.paged_verify_step(cfg, params, pages, tables, lengths,
                                       tokens, window=window, impl=impl)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return verify


def decode_window_for(cfg, shape) -> Optional[int]:
    """Policy: ``long_500k`` on full-attention archs uses the sliding-window
    fallback ``cfg.long_context_window``; a native window (mixtral) is
    kept, and recurrent families need none."""
    if shape.name != "long_500k":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None          # recurrent state: no attention window needed
    if cfg.window is not None:
        return cfg.window    # native sliding window
    return cfg.long_context_window
