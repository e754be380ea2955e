"""Dense decoder-only transformer, serving subset (port of
``repro.models.transformer``).

Param tree layout, the same as the JAX package's (Hydra shards over the
leading ``layers`` axis):

    {"embed": {"table": (V, d)}, "layers": stacked-per-layer tree,
     "final_norm": {"scale": (d,)}}

The JAX package scans the stacked layers; here a Python loop walks them,
taking each layer's slice as a view.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import layers as nn


def _require_dense_rms_swiglu(cfg) -> None:
    if cfg.norm != "rms" or cfg.mlp != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: norm={cfg.norm!r}, mlp={cfg.mlp!r} — the port has "
            "only RMSNorm + SwiGLU decoders so far (layer norm and GELU "
            "come with the bert-style configs)")


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``), laid out as the JAX package lays them out.  The numbers
    differ from JAX's for the same seed; parity tests carry JAX's
    parameters across with ``checkpoint.convert.params_from_numpy``."""
    _require_dense_rms_swiglu(cfg)
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
            "mlp": nn.init_swiglu(generator, cfg, device, L),
        },
        "final_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
    }


def layer_slices(stacked: dict, n_layers: int) -> list[dict]:
    """Per-layer views of a stacked layer tree (no copies)."""
    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [take(stacked, i) for i in range(n_layers)]


def apply_layer_decode(cfg, lp, x, cache, *, window=None):
    """One pre-norm block in decode mode; ``cache`` is one layer's
    {"k","v","index"} and is written in place."""
    positions = cache["index"] + torch.arange(x.shape[1], device=x.device)
    positions = positions[None, :].expand(x.shape[0], x.shape[1])
    h, new_cache = nn.attention(
        lp["attn"], nn.rms_norm(lp["attn_norm"], x), cfg, cache,
        positions=positions,
        window=window if window is not None else cfg.window)
    x = x + h
    return x + nn.swiglu(lp["mlp"], nn.rms_norm(lp["mlp_norm"], x)), \
        new_cache


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    return {"kv": nn.init_kv_cache(cfg, batch, max_seq,
                                   resolve_device(device))}


def decode_step(cfg, params, state, tokens, *, window=None):
    """One decode step over a contiguous cache: tokens (b, s) -> logits
    (b, s, V), new state.  The cache planes are written in place; the
    returned state shares them with ``state`` and has the index advanced."""
    _require_dense_rms_swiglu(cfg)
    x = nn.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    kv = state["kv"]
    for lp, k_l, v_l in zip(layer_slices(params["layers"], cfg.n_layers),
                            kv["k"], kv["v"]):
        cache = {"k": k_l, "v": v_l, "index": kv["index"]}
        x, _ = apply_layer_decode(cfg, lp, x, cache, window=window)
    x = nn.rms_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    new_state = {"kv": {"k": kv["k"], "v": kv["v"],
                        "index": kv["index"] + tokens.shape[1]}}
    return logits, new_state


def paged_decode_step(cfg, params, pages, tables, lengths, tokens, *,
                      window=None, impl=None):
    """One decode step over a paged KV cache shared by all lanes.

    tokens: (n, 1); pages: {"k","v"} of (L, P, bs, nkv, hd), written in
    place (this step's row per lane); tables: (n, B) int32 physical block
    ids per lane; lengths: (n,) int32 rows already written (this token's
    row index).  ``impl`` routes the attention (``kernels.ops``).  Returns
    logits (n, 1, V)."""
    _require_dense_rms_swiglu(cfg)
    x = nn.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    win = window if window is not None else cfg.window
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        pg = {"k": pages["k"][i], "v": pages["v"][i]}
        x = x + nn.paged_attention_decode(
            lp["attn"], nn.rms_norm(lp["attn_norm"], x), cfg,
            pages=pg, tables=tables, lengths=lengths, window=win, impl=impl)
        x = x + nn.swiglu(lp["mlp"], nn.rms_norm(lp["mlp_norm"], x))
    x = nn.rms_norm(params["final_norm"], x)
    return nn.unembed(params["embed"], x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _kv_state_bytes(cfg, batch: int, max_seq: int) -> int:
    """K + V planes of (L, b, s, n_kv, hd) in ``cfg.kv_cache_dtype`` plus
    the 4-byte write index the JAX package counts."""
    item = torch_dtype(cfg.kv_cache_dtype).itemsize
    kv = 2 * cfg.n_layers * batch * max_seq * cfg.n_kv_heads \
        * cfg.head_dim * item
    return kv + 4


def _kv_block_bytes(cfg, block_size: int) -> int:
    """Bytes of ONE physical KV block across all layers (fp pools)."""
    rows = 2 * cfg.n_layers * block_size * cfg.n_kv_heads
    return rows * cfg.head_dim * torch_dtype(cfg.kv_cache_dtype).itemsize


def _register():
    import sys

    from repro_torch.models import registry
    later = "ported in a later slice of the PyTorch port"
    registry.register(registry.FamilySpec(
        family="dense", module=sys.modules[__name__],
        batched_prefill=True, paging=True, servable=True,
        notes={"kv_quant": f"int8 KV pages are {later}"},
        decode_state_cost=_kv_state_bytes,
        kv_block_cost=_kv_block_bytes))


_register()
