"""Whisper-class encoder-decoder transformer (port of
``repro.models.encdec``).

The mel-spectrogram + conv frontend is a stub: ``input_specs`` feeds
precomputed frame embeddings ``(b, encoder_len, d)``.  Encoder:
bidirectional self-attention; decoder: causal self-attention +
cross-attention to the encoder output.  LayerNorm + GELU (Whisper
style), learned decoder positions, no RoPE.

For Hydra the model is one queue: [frontend, enc_0..enc_{E-1}, bridge,
dec_0..dec_{D-1}, head] (``core/shard_graph.py``) — the encoder output is
a boundary intermediate checkpointed between shard units like any other.

Param tree layout, the JAX package's: ``encoder`` and ``decoder`` are
stacked per-layer trees (layer axis first), ``dec_pos`` an (8192, d)
learned table.  Python loops walk the stacked layers where JAX scans.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.models import layers as nn
from repro_torch.models.transformer import _n_stacked, layer_slices
from repro_torch.sharding.context import constrain_batch, gather_fsdp

# learned decoder positions: Whisper trains 448; the table is capped at 8k
# and positions past it reuse the last row
DEC_POS_ROWS = 8192


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator``, laid out as the JAX package
    lays them out.  The numbers differ from JAX's for the same seed."""
    device = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    E, D = (cfg.n_encoder_layers,), (cfg.n_layers,)
    return {
        "embed": nn.init_embedding(generator, cfg.vocab_size, d, pdt,
                                   device),
        "dec_pos": nn.embed_init(generator, (DEC_POS_ROWS, d), pdt, device),
        "encoder": {
            "attn_norm": nn.init_layernorm(d, pdt, device, E),
            "attn": nn.init_attention(generator, cfg, device, E),
            "mlp_norm": nn.init_layernorm(d, pdt, device, E),
            "mlp": nn.init_gelu_mlp(generator, cfg, device, E),
        },
        "enc_final_norm": nn.init_layernorm(d, pdt, device),
        "decoder": {
            "self_norm": nn.init_layernorm(d, pdt, device, D),
            "self_attn": nn.init_attention(generator, cfg, device, D),
            "cross_norm": nn.init_layernorm(d, pdt, device, D),
            "cross_attn": nn.init_attention(generator, cfg, device, D),
            "mlp_norm": nn.init_layernorm(d, pdt, device, D),
            "mlp": nn.init_gelu_mlp(generator, cfg, device, D),
        },
        "final_norm": nn.init_layernorm(d, pdt, device),
    }


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """(n, d) f32: sines of the first d/2 frequencies, then cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _normed(p, x):
    """Layer norm, re-gathered to batch-only sharding over a mesh."""
    return constrain_batch(nn.layer_norm(p, x), seq_parallel=False)


def apply_enc_layer(cfg, lp, x):
    lp = gather_fsdp(lp)
    x = constrain_batch(x, seq_parallel=False)
    h, _ = nn.attention(lp["attn"], _normed(lp["attn_norm"], x), cfg,
                        causal=False, rope=False, impl=cfg.attn_impl)
    x = x + h
    return x + nn.gelu_mlp(lp["mlp"], _normed(lp["mlp_norm"], x))


def apply_dec_layer(cfg, lp, x, enc_out, *, window=None):
    lp = gather_fsdp(lp)
    x = constrain_batch(x, seq_parallel=False)
    h, _ = nn.attention(lp["self_attn"], _normed(lp["self_norm"], x),
                        cfg, causal=True, rope=False, window=window,
                        impl=cfg.attn_impl)
    x = x + h
    h, _ = nn.attention(lp["cross_attn"], _normed(lp["cross_norm"], x),
                        cfg, xkv=enc_out, causal=False, rope=False)
    x = x + h
    return x + nn.gelu_mlp(lp["mlp"], _normed(lp["mlp_norm"], x))


def _walk(cfg, stacked, x, layer_fn, *extra):
    """``layer_fn(lp, x, *extra)`` over a stacked tree; with ``cfg.remat``
    each layer is checkpointed when autograd records (memory, not
    numbers, changes).  Over a mesh the residual stream is pinned
    batch-sharded between layers (``sharding.context``)."""
    x = constrain_batch(x)
    for lp in layer_slices(stacked, _n_stacked(stacked)):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer_fn, lp, x, *extra, use_reentrant=False)
        else:
            x = layer_fn(lp, x, *extra)
        x = constrain_batch(x)
    return x


def encoder_inputs(cfg, frame_embeds):
    """Frame embeddings in the compute dtype plus sinusoidal positions."""
    dt = torch_dtype(cfg.dtype)
    x = frame_embeds.to(dt)
    pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
    return x + pos.to(dt)


def encode(cfg, params, frame_embeds):
    """frame_embeds: (b, encoder_len, d) from the (stubbed) conv frontend."""
    x = _walk(cfg, params["encoder"], encoder_inputs(cfg, frame_embeds),
              lambda lp, h: apply_enc_layer(cfg, lp, h))
    return nn.layer_norm(params["enc_final_norm"], x)


def decode_stack(cfg, params, tokens, enc_out, *, window=None,
                 pos_offset=0):
    dt = torch_dtype(cfg.dtype)
    x = nn.embed(params["embed"], tokens, dt)
    # positions beyond the learned table clamp to its last row
    idx = torch.clamp(pos_offset + torch.arange(tokens.shape[1],
                                                device=tokens.device),
                      0, params["dec_pos"].shape[0] - 1)
    x = x + params["dec_pos"][idx].to(dt)[None]
    x = _walk(cfg, params["decoder"], x,
              lambda lp, h, e: apply_dec_layer(cfg, lp, h, e, window=window),
              enc_out)
    return nn.layer_norm(params["final_norm"], x)


def forward(cfg, params, batch, *, window=None, last_only=False):
    """batch: {"enc_embeds": (b, F, d), "tokens": (b, s)} -> logits."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    x = decode_stack(cfg, params, batch["tokens"], enc_out, window=window)
    if last_only:
        x = x[:, -1:]
    return nn.unembed(params["embed"], x)


# ---------------------------------------------------------------------------
# decode (serve): cached self-attn KV + precomputed cross-attn KV
# ---------------------------------------------------------------------------

def init_decode_state(cfg, batch: int, max_seq: int, device="cuda",
                      enc_out=None, params=None):
    """Self-attention K/V of (D, b, max_seq, nkv, hd) and the cross K/V:
    ``precompute_cross_kv`` of ``enc_out`` when given, else zeros of (D,
    b, encoder_len, nkv, hd).  The cross K/V is bf16 whatever the config
    dtype, as in the JAX package."""
    device = resolve_device(device)
    state = {"kv": nn.init_kv_cache(cfg, batch, max_seq, device)}
    if enc_out is not None:
        state["cross"] = precompute_cross_kv(cfg, params, enc_out)
    else:
        shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads,
                 cfg.head_dim)
        state["cross"] = {
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    return state


def precompute_cross_kv(cfg, params, enc_out):
    """Every decoder layer's cross-attention K/V of the encoder output,
    stacked (D, b, F, nkv, hd), bf16."""
    ks, vs = [], []
    for lp in layer_slices(params["decoder"], cfg.n_layers):
        _, k, v = nn._project_qkv(lp["cross_attn"], enc_out, cfg)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(cfg, params, state, tokens, *, window=None):
    """One decoder token.  tokens: (b, 1).  The self-attention K/V rows
    are written in place; the returned state shares the planes with
    ``state`` and has the index advanced."""
    kv = state["kv"]
    idx = kv["index"]
    b = tokens.shape[0]
    dt = torch_dtype(cfg.dtype)
    x = nn.embed(params["embed"], tokens, dt)
    row = min(int(idx), params["dec_pos"].shape[0] - 1)
    x = x + params["dec_pos"][row].to(dt)[None, None]
    positions = torch.full((b, 1), int(idx), dtype=torch.int64,
                           device=x.device)
    cross = state["cross"]
    for i, lp in enumerate(layer_slices(params["decoder"], cfg.n_layers)):
        cache = {"k": kv["k"][i], "v": kv["v"][i], "index": idx}
        a, _ = nn.attention(lp["self_attn"],
                            nn.layer_norm(lp["self_norm"], x), cfg, cache,
                            positions=positions, causal=True, rope=False,
                            window=window)
        x = x + a
        ccache = {"k": cross["k"][i], "v": cross["v"][i], "index": idx}
        a, _ = nn.attention(lp["cross_attn"],
                            nn.layer_norm(lp["cross_norm"], x), cfg, ccache,
                            xkv=x,   # ignored: the cache supplies enc K/V
                            causal=False, rope=False)
        x = x + a
        x = x + nn.gelu_mlp(lp["mlp"], nn.layer_norm(lp["mlp_norm"], x))
    x = nn.layer_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x)
    new_state = {"kv": {"k": kv["k"], "v": kv["v"],
                        "index": idx + tokens.shape[1]},
                 "cross": cross}
    return logits, new_state


def _register():
    import sys

    from repro_torch.models import registry
    registry.register(registry.FamilySpec(
        family="audio", module=sys.modules[__name__],
        batched_prefill=False, padded_prefill=False, paging=False,
        pure_kv_state=False, servable=False, token_stream_data=False,
        notes={
            "servable": "encoder-decoder decode states need real encoder "
                        "output; InferenceEngine has no encoder-output "
                        "path yet",
            "batched_prefill": "decoder states advance token-by-token "
                               "against the cross-attention cache",
            "padded_prefill": "decoder prefill cannot be rewound past a "
                              "pad tail",
            "paging": "cross-attention cache is request-constant — paging "
                      "the self-attention half alone buys nothing",
            "pure_kv_state": "decode state couples self- and cross-"
                             "attention caches",
            "token_stream_data": "audio batches carry encoder frame "
                                 "embeddings alongside tokens",
            "spec_draftable": "not servable through InferenceEngine, so "
                              "there is no decode path to speculate on",
        }))


_register()
