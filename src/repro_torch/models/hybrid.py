"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block
(port of ``repro.models.hybrid``).

The shared transformer block's parameters are reused at every invocation
(after every ``cfg.attn_every``-th Mamba2 layer).  For Hydra they are a
shared parameter group (``core/shard_graph.py``): promoted with any shard
that uses them, their gradient summed over the shards that do.

A Python loop walks the stacked Mamba2 layers with the static per-layer
``attn_flags``.  Decode keeps one K/V slot per invocation site: K/V
planes of ``(A, b, max_seq, nkv, hd)`` whose write index is the state's
``pos`` — an int shared by the batch (prefill), or a ``(b,)`` tensor with
one per lane (the slot pool), as the dense family's contiguous cache
takes it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import layers as nn
from repro_torch.models import ssm
from repro_torch.models.transformer import _n_stacked, layer_slices
from repro_torch.sharding.context import constrain_batch, gather_fsdp


def init_shared_attn(generator, cfg, device):
    pdt = torch_dtype(cfg.param_dtype)
    return {
        "attn_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
        "attn": nn.init_attention(generator, cfg, device),
        "mlp_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
        "mlp": nn.init_swiglu(generator, cfg, device),
    }


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator``, laid out as the JAX package
    lays them out (Mamba2 layers stacked on axis 0, ``shared_attn``
    once).  The numbers differ from JAX's for the same seed."""
    device = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    L = (cfg.n_layers,)
    return {
        "embed": nn.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   pdt, device),
        "layers": {"norm": nn.init_rmsnorm(cfg.d_model, pdt, device, L),
                   "mamba": ssm.init_mamba2(generator, cfg, device, L)},
        "shared_attn": init_shared_attn(generator, cfg, device),
        "final_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
    }


def attn_flags(cfg) -> np.ndarray:
    """use_attn[i] — apply the shared block after mamba layer i (static)."""
    idx = np.arange(cfg.n_layers)
    return (idx % cfg.attn_every) == (cfg.attn_every - 1)


def apply_shared_attn(cfg, sp, x, *, window=None, kv_cache=None,
                      positions=None):
    h, nc = nn.attention(sp["attn"], nn.rms_norm(sp["attn_norm"], x), cfg,
                         kv_cache, positions=positions, causal=True,
                         window=window, impl=cfg.attn_impl)
    x = x + h
    x = x + nn.swiglu(sp["mlp"], nn.rms_norm(sp["mlp_norm"], x))
    return x, nc


def apply_layer(cfg, lp, x, shared, use_attn, *, window=None):
    """One Mamba2 layer, then the shared block where ``use_attn``."""
    lp, shared = gather_fsdp((lp, shared))
    x = constrain_batch(x, seq_parallel=False)
    xn = constrain_batch(nn.rms_norm(lp["norm"], x), seq_parallel=False)
    x = x + ssm.mamba2_forward(lp["mamba"], xn, cfg)
    if use_attn:
        x = apply_shared_attn(cfg, shared, x, window=window)[0]
    return x


def apply_layer_range(cfg, stacked_slice, x, shared, flags_slice, *,
                      window=None, remat=None):
    """Apply a contiguous slice of stacked layers with their flags;
    ``remat`` (default ``cfg.remat``) checkpoints each layer when autograd
    records."""
    remat = cfg.remat if remat is None else remat
    lps = layer_slices(stacked_slice, _n_stacked(stacked_slice))
    for lp, flag in zip(lps, flags_slice):
        flag = bool(flag)
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda lp_, h, sh, f=flag: apply_layer(
                cfg, lp_, h, sh, f, window=window), lp, x, shared,
                use_reentrant=False)
        else:
            x = apply_layer(cfg, lp, x, shared, flag, window=window)
        x = constrain_batch(x)
    return x


def forward(cfg, params, batch, *, window=None, last_only=False):
    x = nn.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    x = apply_layer_range(cfg, params["layers"], x, params["shared_attn"],
                          attn_flags(cfg), window=window)
    if last_only:
        x = x[:, -1:]
    x = nn.rms_norm(params["final_norm"], x)
    return nn.unembed(params["embed"], x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def n_attn_invocations(cfg) -> int:
    return int(attn_flags(cfg).sum())


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    device = resolve_device(device)
    kv = nn.init_kv_cache(cfg, batch, max_seq, device,
                          n_layers=n_attn_invocations(cfg))
    return {"mamba": ssm.init_mamba2_state(cfg, batch, device,
                                           (cfg.n_layers,)),
            "kv": kv, "pos": 0}


def decode_step(cfg, params, state, tokens, *, window=None):
    """tokens: (b, 1).  The shared block keeps one K/V slot per invocation
    site; the Mamba2 states and the K/V rows are written in place."""
    if tokens.shape[1] != 1:
        raise ValueError(f"{cfg.name}: recurrent decode takes one token "
                         f"per lane, got {tokens.shape[1]}")
    b = tokens.shape[0]
    x = nn.embed(params["embed"], tokens[:, 0], torch_dtype(cfg.dtype))
    kv, pos = state["kv"], state["pos"]
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None]
    else:
        positions = torch.full((b, 1), int(pos), dtype=torch.int64,
                               device=x.device)
    slot = 0
    mstates = layer_slices(state["mamba"], cfg.n_layers)
    for lp, ms, flag in zip(layer_slices(params["layers"], cfg.n_layers),
                            mstates, attn_flags(cfg)):
        y, new_ms = ssm.mamba2_step(lp["mamba"], nn.rms_norm(lp["norm"], x),
                                    ms, cfg)
        x = x + y
        ms["ssm"].copy_(new_ms["ssm"])
        ms["conv"].copy_(new_ms["conv"])
        if flag:
            cache = {"k": kv["k"][slot], "v": kv["v"][slot], "index": pos}
            h2, _ = apply_shared_attn(cfg, params["shared_attn"],
                                      x[:, None], window=window,
                                      kv_cache=cache, positions=positions)
            x = h2[:, 0]
            slot += 1
    x = nn.rms_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x[:, None, :])
    new_state = {"mamba": state["mamba"],
                 "kv": {"k": kv["k"], "v": kv["v"],
                        "index": kv["index"] + 1},
                 "pos": pos + 1}
    return logits, new_state


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _decode_state_bytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of ``init_decode_state``: the f32 Mamba2 (h, p, N) states and
    conv tails of every layer, the shared block's K/V slots in
    ``cfg.kv_cache_dtype``, and the two 4-byte int32 indices (K/V
    ``index`` and ``pos``) the JAX package counts."""
    d_in, h, p, n = ssm.mamba2_dims(cfg)
    mamba = 4 * cfg.n_layers * batch * (
        h * p * n + (cfg.conv_kernel - 1) * (d_in + 2 * n))
    item = torch_dtype(cfg.kv_cache_dtype).itemsize
    kv = 2 * n_attn_invocations(cfg) * batch * max_seq * cfg.n_kv_heads \
        * cfg.head_dim * item
    return mamba + kv + 4 + 4


def _register():
    import sys

    from repro_torch.models import registry
    registry.register(registry.FamilySpec(
        family="hybrid", module=sys.modules[__name__],
        batched_prefill=False, padded_prefill=False, paging=False,
        pure_kv_state=False, servable=True, spec_draftable=False,
        kv_quant=False,
        notes={
            "batched_prefill": "mamba recurrences advance strictly "
                               "token-by-token (prefill scans the prompt)",
            "padded_prefill": "recurrent sub-states cannot be rewound past "
                              "a pad tail",
            "paging": "decode state mixes O(1) recurrences with the shared-"
                      "attention KV slots — not a pure pageable KV cache",
            "pure_kv_state": "decode state mixes mamba recurrences with a "
                             "KV cache",
            "spec_draftable": "mamba sub-states cannot be rolled back past "
                              "rejected draft tokens",
        },
        decode_state_cost=_decode_state_bytes))


_register()
