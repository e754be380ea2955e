"""Unified model API: dispatch on ``cfg.family`` through the FamilySpec
registry (port of ``repro.models.api``, serving subset)."""

from __future__ import annotations

from typing import Optional

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import registry


def family_module(cfg):
    return registry.spec(cfg).module


def init_params(cfg, generator, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def prepare_params(cfg, params, device="cuda"):
    """Params ready to serve on ``device``: every tensor moved there, and
    the >= 2-D ``layers`` weights held in ``cfg.dtype``.  The layer code
    casts each weight to the compute dtype at use, as the JAX package's
    per-use ``astype`` does; holding the cast copy makes that cast a no-op
    with the same numbers instead of a full weight copy every step.  The
    embedding table and 1-D norm scales stay as they are (embed gathers
    then casts; unembed runs in f32)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def conv(tree, in_layers):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v, in_layers or k == "layers")
            else:
                v = v.to(device)
                out[k] = v.to(dt) if in_layers and v.dim() >= 3 else v
        return out

    return conv(params, False)


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    return family_module(cfg).init_decode_state(cfg, batch, max_seq, device)


def decode_step(cfg, params, state, tokens, *, window: Optional[int] = None):
    return family_module(cfg).decode_step(cfg, params, state, tokens,
                                          window=window)


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------

def init_kv_pages(cfg, n_blocks: int, block_size: int, device="cuda"):
    """Physical KV block pool: {"k","v"} of (L, n_blocks, block_size,
    n_kv_heads, head_dim) in ``cfg.kv_cache_dtype`` — the contiguous
    cache's layout with the block axis where batch was."""
    from repro_torch.models import layers as nn
    pages = nn.init_kv_cache(cfg, n_blocks, block_size,
                             resolve_device(device))
    return {"k": pages["k"], "v": pages["v"]}


def kv_block_bytes(cfg, block_size: int, kv_dtype=None) -> int:
    """Residency cost of ONE physical block across all layers — the unit
    page-granular admission charges against the device ledger."""
    return registry.spec(cfg).kv_block_bytes(cfg, block_size, kv_dtype)


def paged_decode_step(cfg, params, pages, tables, lengths, tokens, *,
                      window: Optional[int] = None, impl=None):
    """One decode step reading K/V through per-lane block tables."""
    spec = registry.spec(cfg)
    if not spec.paging:
        raise ValueError(f"{cfg.name} ({cfg.family}): {spec.why_not('paging')}")
    return spec.module.paged_decode_step(
        cfg, params, pages, tables, lengths, tokens, window=window,
        impl=impl)


def decode_state_bytes(cfg, batch: int, max_seq: int) -> int:
    """Residency cost of one decode state (KV-budget admission control)."""
    return registry.spec(cfg).decode_state_bytes(cfg, batch, max_seq)
