"""Dense transformer: RMSNorm/SwiGLU decoders (qwen-class), their VLM
variant (the LLaVA backbone, fed patch+text embeddings) and layer-norm
/GELU encoders (BERT*/ViT*-class), port of ``repro.models.transformer``.

Param tree layout, the same as the JAX package's (Hydra shards over the
leading ``layers`` axis):

    {"embed": {"table": (V, d)}, "layers": stacked-per-layer tree,
     "final_norm": {"scale": (d,)}}

The JAX package scans the stacked layers; here a Python loop walks them,
taking each layer's slice as a view.  ``apply_layer_range`` applies a
contiguous slice of layers — the primitive Hydra's shard units execute.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import layers as nn
from repro_torch.sharding.context import constrain_batch, gather_fsdp


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``), laid out as the JAX package lays them out.  The numbers
    differ from JAX's for the same seed; parity tests carry JAX's
    parameters across with ``checkpoint.convert.params_from_numpy``."""
    device = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    L = (cfg.n_layers,)
    norm_init = nn.init_rmsnorm if cfg.norm == "rms" else nn.init_layernorm
    mlp_init = nn.init_swiglu if cfg.mlp == "swiglu" else nn.init_gelu_mlp
    return {
        "embed": nn.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   pdt, device),
        "layers": {
            "attn_norm": norm_init(cfg.d_model, pdt, device, L),
            "attn": nn.init_attention(generator, cfg, device, L),
            "mlp_norm": norm_init(cfg.d_model, pdt, device, L),
            "mlp": mlp_init(generator, cfg, device, L),
        },
        "final_norm": norm_init(cfg.d_model, pdt, device),
    }


def layer_slices(stacked: dict, n_layers: int) -> list[dict]:
    """Per-layer views of a stacked layer tree (no copies)."""
    def take(tree, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [take(stacked, i) for i in range(n_layers)]


def _norm(cfg, p, x):
    return nn.rms_norm(p, x) if cfg.norm == "rms" else nn.layer_norm(p, x)


def _mlp(cfg, p, x):
    return nn.swiglu(p, x) if cfg.mlp == "swiglu" else nn.gelu_mlp(p, x)


def _n_stacked(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def apply_layer(cfg, lp, x, *, window=None, positions=None, impl=None):
    """One pre-norm transformer block (cache-free). x: (b, s, d).

    Over a mesh (``sharding.context``) the residual stream between layers
    is seq-sharded over 'model', as in the JAX package, so the layer
    inputs remat keeps are; inside the layer it is re-gathered (seq
    whole) and tensor parallelism owns the model axis.  The JAX package
    runs the norms seq-sharded and gathers their outputs; gathering the
    residual first keeps the residual add, and so every product's
    gradient, batch-sharded only — a product flattens (b, s), which some
    DTensor versions cannot do with both dims sharded."""
    lp = gather_fsdp(lp)
    x = constrain_batch(x, seq_parallel=False)
    xn = constrain_batch(_norm(cfg, lp["attn_norm"], x), seq_parallel=False)
    h, _ = nn.attention(lp["attn"], xn, cfg,
                        positions=positions, causal=cfg.causal,
                        window=window if window is not None else cfg.window,
                        impl=impl or cfg.attn_impl)
    x = x + h
    hn = constrain_batch(_norm(cfg, lp["mlp_norm"], x), seq_parallel=False)
    return x + _mlp(cfg, lp["mlp"], hn)


def embed_inputs(cfg, params, batch):
    """A VLM batch's ``embeds`` (the frontend stub's fused patch+text
    embeddings) cast to the compute dtype, else the token embedding."""
    if cfg.takes_embeddings and "embeds" in batch:
        return batch["embeds"].to(torch_dtype(cfg.dtype))
    return nn.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))


def apply_layer_range(cfg, stacked_slice, x, *, window=None, remat=None):
    """Apply a contiguous slice of stacked layer params (Hydra shard
    unit).  ``remat`` (default ``cfg.remat``) checkpoints each layer when
    autograd records: its activations are recomputed in the backward
    instead of kept, which changes memory, not numbers."""
    remat = cfg.remat if remat is None else remat
    x = constrain_batch(x)
    for lp in layer_slices(stacked_slice, _n_stacked(stacked_slice)):
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda lp_, h: apply_layer(cfg, lp_, h,
                                                      window=window),
                           lp, x, use_reentrant=False)
        else:
            x = apply_layer(cfg, lp, x, window=window)
        x = constrain_batch(x)
    return x


def forward(cfg, params, batch, *, window=None, last_only=False):
    """Full forward to logits. batch: {"tokens": (b, s) int64 tensor}.

    ``last_only``: unembed only the final position; the (b, s, V) logits
    tensor is never made."""
    x = embed_inputs(cfg, params, batch)
    x = apply_layer_range(cfg, params["layers"], x, window=window)
    if last_only:
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    return nn.unembed(params["embed"], x)


def _chunk_positions(index, b: int, sq: int, device) -> torch.Tensor:
    """(b, sq) positions of a chunk written at ``index`` (an int shared by
    the batch, or a (b,) tensor with one write index per lane)."""
    steps = torch.arange(sq, device=device)
    if isinstance(index, torch.Tensor):
        return index[:, None] + steps[None, :]
    return (index + steps)[None, :].expand(b, sq)


def apply_layer_decode(cfg, lp, x, cache, *, window=None):
    """One pre-norm block in decode mode; ``cache`` is one layer's
    {"k","v","index"} and is written in place."""
    lp = gather_fsdp(lp)
    positions = _chunk_positions(cache["index"], x.shape[0], x.shape[1],
                                 x.device)
    h, new_cache = nn.attention(
        lp["attn"], _norm(cfg, lp["attn_norm"], x), cfg, cache,
        positions=positions,
        window=window if window is not None else cfg.window)
    x = x + h
    return x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["mlp_norm"], x)), \
        new_cache


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    return {"kv": nn.init_kv_cache(cfg, batch, max_seq,
                                   resolve_device(device))}


def decode_step(cfg, params, state, tokens, *, window=None):
    """One decode step over a contiguous cache: tokens (b, s) -> logits
    (b, s, V), new state.  The cache planes are written in place; the
    returned state shares them with ``state`` and has the index advanced.
    The index is an int for a batch that shares one (prefill), or a (b,)
    int64 tensor with one per lane (the slot pool, where the JAX package
    vmaps the step over batch-1 states)."""
    x = nn.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    kv = state["kv"]
    for lp, k_l, v_l in zip(layer_slices(params["layers"], cfg.n_layers),
                            kv["k"], kv["v"]):
        cache = {"k": k_l, "v": v_l, "index": kv["index"]}
        x, _ = apply_layer_decode(cfg, lp, x, cache, window=window)
        x = constrain_batch(x)
    x = _norm(cfg, params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    new_state = {"kv": {"k": kv["k"], "v": kv["v"],
                        "index": kv["index"] + tokens.shape[1]}}
    return logits, new_state


def _unfused_block(cfg, attend):
    """A pre-norm block with ``attend(lp, normed x, layer pages)`` as its
    attention."""
    def block(lp, x, pg):
        x = x + attend(lp["attn"], _norm(cfg, lp["attn_norm"], x), pg)
        return x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["mlp_norm"], x))
    return block


def _paged_layers(cfg, params, pages, tokens, block):
    """Embed ``tokens``, run ``block(lp, x, layer pages)`` for every layer,
    and unembed.  Each layer's pages are views of the stacked planes (k, v
    and, for int8 pools, k_scale, v_scale), written in place."""
    x = nn.embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        x = block(lp, x, {name: plane[i] for name, plane in pages.items()})
    x = _norm(cfg, params["final_norm"], x)
    return nn.unembed(params["embed"], x)


def paged_decode_step(cfg, params, pages, tables, lengths, tokens, *,
                      window=None, impl=None):
    """One decode step over a paged KV cache shared by all lanes.

    tokens: (n, 1); pages: {"k","v"} of (L, P, bs, nkv, hd) — plus per-row
    {"k_scale","v_scale"} of (L, P, bs, nkv) for an int8 pool — written in
    place (this step's row per lane); tables: (n, B) int32 physical block
    ids per lane; lengths: (n,) int32 rows already written (this token's
    row index).  ``impl`` routes the attention (``kernels.ops``): 'cuda',
    'ref' or None (by device).  ``impl='fused'`` (the kernel; its plain
    version on the CPU) or ``'fused_ref'`` (the plain version anywhere)
    runs each whole block through ``kernels.ops.fused_decode_layer`` when
    the config qualifies (RMSNorm + SwiGLU, an f32, bf16 or fp8 pool; an
    int8 pool does not); other configs quietly take the equivalent
    unfused path.  Returns logits (n, 1, V)."""
    win = window if window is not None else cfg.window
    if (impl in nn.FUSED_IMPLS and cfg.norm == "rms" and cfg.mlp == "swiglu"
            and "k_scale" not in pages):
        op_impl = nn.FUSED_IMPLS[impl]
        return _paged_layers(cfg, params, pages, tokens, lambda lp, x, pg:
                             nn.paged_decode_layer_fused(
                                 lp, x, cfg, pages=pg, tables=tables,
                                 lengths=lengths, window=win, impl=op_impl))
    return _paged_layers(cfg, params, pages, tokens, _unfused_block(
        cfg, lambda lp, x, pg: nn.paged_attention_decode(
            lp, x, cfg, pages=pg, tables=tables, lengths=lengths,
            window=win, impl=impl)))


# ---------------------------------------------------------------------------
# speculative verify (k tokens scored against cached state in one forward)
# ---------------------------------------------------------------------------

def verify_step(cfg, params, state, tokens, *, window=None):
    """Score k draft positions against the contiguous KV cache in ONE
    forward: tokens ``(b, k)`` (last committed token + k-1 drafts) ->
    ``(logits (b, k, V), new state)`` with the cache index advanced by k.
    The batched-prefill mechanism pointed at mid-decode: the causal chunk
    mask keeps position ``i``'s logits equal to what i single-token decode
    steps would give.  The caller rolls the state back past the accept
    point with ``rollback_decode_state``."""
    return decode_step(cfg, params, state, tokens, window=window)


def rollback_decode_state(cfg, state, delta):
    """Rewind the cache write index by ``delta`` rows (a per-lane tensor
    or an int).  Rows past the rewound index are stale but invisible:
    decode attention masks ``kvpos > qpos`` and later writes overwrite
    them in place."""
    kv = state["kv"]
    return {"kv": {"k": kv["k"], "v": kv["v"],
                   "index": kv["index"] - delta}}


def paged_verify_step(cfg, params, pages, tables, lengths, tokens, *,
                      window=None, impl=None):
    """The paged twin of ``verify_step``: score k positions per lane
    through per-lane block tables.  tokens ``(n, k)``; the k K/V rows per
    lane are written in place; returns logits ``(n, k, V)``.  The caller
    owns rollback: it advances ``lengths`` by the accepted rows only and
    frees whole tail blocks — rows past a lane's length get zero weight,
    so rejected draft rows never perturb later decode.  ``impl`` routes
    the attention: 'cuda' is the multi-query kernel, 'ref' the gathered
    plain version."""
    win = window if window is not None else cfg.window
    return _paged_layers(cfg, params, pages, tokens, _unfused_block(
        cfg, lambda lp, x, pg: nn.paged_attention_verify(
            lp, x, cfg, pages=pg, tables=tables, lengths=lengths,
            window=win, impl=impl)))


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


def _kv_block_bytes(cfg, block_size: int, kv_dtype=None) -> int:
    """Bytes of ONE physical KV block across all layers.  ``kv_dtype=
    'int8'`` prices the quantized pool: one byte per cache element plus a
    4-byte f32 scale per (row, KV head) — ``rows * (hd + 4)``."""
    rows = 2 * cfg.n_layers * block_size * cfg.n_kv_heads
    if kv_dtype == "int8":
        return rows * (cfg.head_dim + torch.float32.itemsize)
    return rows * cfg.head_dim * torch_dtype(cfg.kv_cache_dtype).itemsize


def _register():
    import sys

    from repro_torch.models import registry
    mod = sys.modules[__name__]
    for family, tokens_only in (("dense", True), ("vlm", False)):
        registry.register(registry.FamilySpec(
            family=family, module=mod,
            batched_prefill=True, padded_prefill=True, paging=True,
            pure_kv_state=True, servable=True, spec_draftable=True,
            kv_quant=True,
            token_stream_data=tokens_only,
            notes={} if tokens_only else {
                "token_stream_data": "VLM batches carry fused patch+text "
                                     "embeddings, not raw token streams"},
            decode_state_cost=_kv_state_bytes,
            kv_block_cost=_kv_block_bytes))


_register()
