"""Unified model API: dispatch on ``cfg.family`` through the FamilySpec
registry (port of ``repro.models.api``)."""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import registry
from repro_torch.tree import tree_map


def family_spec(cfg) -> registry.FamilySpec:
    """The registered FamilySpec for ``cfg`` (or a family name)."""
    return registry.spec(cfg)


def family_module(cfg):
    return registry.spec(cfg).module


def init_params(cfg, generator, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def forward(cfg, params, batch, *, window: Optional[int] = None,
            last_only: bool = False):
    return family_module(cfg).forward(cfg, params, batch, window=window,
                                      last_only=last_only)


def param_count(params) -> int:
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())
    return count(params)


def make_dummy_batch(cfg, batch_size: int, seq_len: int, generator=None,
                     device="cuda"):
    """Random batch on ``device`` with the keys of ``input_specs`` (smoke
    runs): int64 ``tokens``/``labels``, plus bf16 ``enc_embeds`` (b,
    encoder_len, d) for the audio family; a family that takes embeddings
    gets bf16 ``embeds`` (b, s, d) in place of ``tokens``.  Its numbers
    differ from the JAX package's for the same seed; parity tests feed
    both sides the same arrays."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    def draw():
        return torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                             generator=generator, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    if cfg.family == "audio":
        return {"enc_embeds": normal(batch_size, cfg.encoder_len,
                                     cfg.d_model),
                "tokens": draw(), "labels": draw()}
    if cfg.takes_embeddings:
        return {"embeds": normal(batch_size, seq_len, cfg.d_model),
                "labels": draw()}
    return {"tokens": draw(), "labels": draw()}


# weights the layer code reads in f32 whatever the compute dtype (the
# Mamba2 conv taps, the sLSTM recurrent matrix): cast copies would change
# their numbers, so they stay as they are
_F32_AT_USE = ("conv_w", "r")


def cast_weights(cfg, params):
    """``params`` with the weight matrices — >= 3-D ``layers``,
    ``encoder`` and ``decoder`` leaves (stacked) and >= 2-D
    ``shared_attn`` leaves — in ``cfg.dtype``.  The layer code casts each
    such weight to the compute dtype at use, as the JAX package's per-use
    ``astype`` does, so the cast copy gives the same numbers, gradients
    included.  The embedding table, the learned ``dec_pos`` table
    (gathered, then cast), norm scales and the weights read in f32
    (``_F32_AT_USE``) stay as they are (embed gathers then casts; unembed
    runs in f32)."""
    dt = torch_dtype(cfg.dtype)

    def conv(tree, min_dim):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = {"layers": 3, "encoder": 3, "decoder": 3,
                       "shared_attn": 2}.get(k, min_dim)
                out[k] = conv(v, sub)
            else:
                cast = min_dim and v.dim() >= min_dim \
                    and k not in _F32_AT_USE
                out[k] = v.to(dt) if cast else v
        return out

    return conv(params, 0)


def prepare_params(cfg, params, device="cuda"):
    """Params ready to serve on ``device``: every tensor moved there, and
    the weight matrices held in ``cfg.dtype`` (``cast_weights``): the
    per-use cast is then a no-op with the same numbers instead of a full
    weight copy every step."""
    device = resolve_device(device)
    return cast_weights(cfg, tree_map(lambda v: v.to(device), params))


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    return family_module(cfg).init_decode_state(cfg, batch, max_seq,
                                                device=device)


def decode_step(cfg, params, state, tokens, *, window: Optional[int] = None):
    return family_module(cfg).decode_step(cfg, params, state, tokens,
                                          window=window)


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------

def init_kv_pages(cfg, n_blocks: int, block_size: int, device="cuda",
                  kv_dtype=None):
    """Physical KV block pool: {"k","v"} of (L, n_blocks, block_size,
    n_kv_heads, head_dim) in ``cfg.kv_cache_dtype`` — the contiguous
    cache's layout with the block axis where batch was.

    ``kv_dtype='int8'`` allocates the quantized pool instead: int8 pages
    plus per-row f32 {"k_scale","v_scale"} planes of (L, n_blocks,
    block_size, n_kv_heads).  Rows are quantized on write
    (``kernels.ref.quantize_kv``) and dequantized inside the attention
    kernel, so no f32 copy of the cache exists."""
    from repro_torch.models import layers as nn
    if kv_dtype not in (None, "fp", "int8"):
        raise ValueError(f"kv_dtype={kv_dtype!r}: expected None, 'fp', "
                         "or 'int8'")
    device = resolve_device(device)
    if kv_dtype == "int8":
        spec = registry.spec(cfg)
        if not spec.kv_quant:
            raise ValueError(f"{cfg.name} ({cfg.family}): "
                             f"{spec.why_not('kv_quant')}")
        shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    pages = nn.init_kv_cache(cfg, n_blocks, block_size, device)
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


def _require_spec_draftable(cfg) -> registry.FamilySpec:
    spec = registry.spec(cfg)
    if not spec.spec_draftable:
        raise ValueError(
            f"{cfg.name} ({cfg.family}): {spec.why_not('spec_draftable')}; "
            "serve this family without speculative decoding")
    return spec


def verify_step(cfg, params, state, tokens, *, window: Optional[int] = None):
    """Multi-token speculative verify: score k draft positions against the
    contiguous decode cache in ONE forward.  tokens ``(b, k)`` -> ``(logits
    (b, k, V), new state)`` with the cache advanced k rows; the caller
    rolls back past the accept point (``rollback_decode_state``)."""
    spec = _require_spec_draftable(cfg)
    return spec.module.verify_step(cfg, params, state, tokens,
                                   window=window)


def rollback_decode_state(cfg, state, delta):
    """Rewind a decode state's write index by ``delta`` rows (per-lane
    tensor or int) — the KV-rollback half of speculative decoding."""
    spec = _require_spec_draftable(cfg)
    return spec.module.rollback_decode_state(cfg, state, delta)


def paged_verify_step(cfg, params, pages, tables, lengths, tokens, *,
                      window: Optional[int] = None, impl=None):
    """Speculative verify reading K/V through per-lane block tables:
    tokens ``(n, k)`` -> logits ``(n, k, V)``; the pages are written in
    place."""
    spec = _require_spec_draftable(cfg)
    if not spec.paging:
        raise ValueError(
            f"{cfg.name} ({cfg.family}): {spec.why_not('paging')}; verify "
            "through the slot backend instead")
    return spec.module.paged_verify_step(
        cfg, params, pages, tables, lengths, tokens, window=window,
        impl=impl)


def decode_state_spec(cfg, batch: int, max_seq: int):
    """The decode state's tree on the ``meta`` device: its shapes and
    dtypes with no allocation (the JAX package's ``eval_shape``)."""
    return init_decode_state(cfg, batch, max_seq, device="meta")


def decode_state_bytes(cfg, batch: int, max_seq: int) -> int:
    """Residency cost of one decode state (KV-budget admission control)."""
    return registry.spec(cfg).decode_state_bytes(cfg, batch, max_seq)


# ---------------------------------------------------------------------------
# deprecated predicate shims (the registry replaced the predicate zoo)
# ---------------------------------------------------------------------------

def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{__name__}.{old} is deprecated: capability decisions now "
        f"live in the FamilySpec registry; use {new} "
        "(see docs/api.md#backends--capabilities)",
        DeprecationWarning, stacklevel=3)


def is_attention_family(cfg) -> bool:
    """Deprecated: use ``family_spec(cfg).batched_prefill``."""
    _deprecated("is_attention_family", "family_spec(cfg).batched_prefill")
    return registry.spec(cfg).batched_prefill


def supports_padded_prefill(cfg) -> bool:
    """Deprecated: use ``family_spec(cfg).padded_prefill``."""
    _deprecated("supports_padded_prefill", "family_spec(cfg).padded_prefill")
    return registry.spec(cfg).padded_prefill


def supports_paging(cfg) -> bool:
    """Deprecated: use ``family_spec(cfg).paging``."""
    _deprecated("supports_paging", "family_spec(cfg).paging")
    return registry.spec(cfg).paging


def __getattr__(name: str):
    # PEP 562 shims: the old capability tuples are now registry queries
    if name == "ATTENTION_FAMILIES":
        _deprecated("ATTENTION_FAMILIES",
                    "registry.families_with('batched_prefill')")
        return registry.families_with("batched_prefill")
    if name == "PAGED_FAMILIES":
        _deprecated("PAGED_FAMILIES", "registry.families_with('paging')")
        return registry.families_with("paging")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, *, kind: Optional[str] = None) -> dict:
    """Meta-tensor inputs for (arch, input shape): the shapes of the JAX
    package's ``ShapeDtypeStruct``s, in the dtypes of the batches the
    port's loaders give (int64 tokens and labels).

    kind 'train'/'prefill' -> full-sequence batch; 'decode' -> one token.
    """
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
    if kind == "decode":
        return {"tokens": _meta((b, 1), torch.int64)}
    if cfg.family == "audio":
        return {"enc_embeds": _meta((b, cfg.encoder_len, cfg.d_model),
                                    torch.bfloat16),
                "tokens": _meta((b, s), torch.int64),
                "labels": _meta((b, s), torch.int64)}
    if cfg.takes_embeddings:
        # VLM: the frontend stub emits fused patch+text embeddings
        return {"embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                "labels": _meta((b, s), torch.int64)}
    return {"tokens": _meta((b, s), torch.int64),
            "labels": _meta((b, s), torch.int64)}
