"""The dense pre-norm block with LayerNorm and a GELU MLP with biases,
as the port's dense and vlm families lay it out: {"embed", "layers",
"final_norm"}, the layers stacked on a leading axis, the embedding table
tied to the unembedding.  Weights are f32, drawn N(0, std) or filled.

A batch is token rows with next-token labels or, for a family fed
embeddings, bf16 patch embeddings with each image's class at every
position.
"""

from __future__ import annotations

import math

import torch


def weight_specs(arch: dict) -> list[tuple[str, tuple, str, float]]:
    """(dotted name, shape, kind, std) of every stacked leaf: kind is
    'normal' (std given), 'ones' or 'zeros'."""
    L, d, f = arch["n_layers"], arch["d_model"], arch["d_ff"]
    nh, nkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // nh
    if arch["norm"] != "layer" or arch["mlp"] != "gelu" \
            or not arch["mlp_bias"] or arch["qk_norm"] \
            or not arch["tie_embeddings"]:
        raise ValueError(f"{arch['name']}: this family lays out the "
                         "LayerNorm / GELU-with-biases block only")
    specs = [("embed.table", (arch["vocab_size"], d), "normal", 0.02)]
    specs += [
        ("layers.attn_norm.scale", (L, d), "ones", 0.0),
        ("layers.attn_norm.bias", (L, d), "zeros", 0.0),
        ("layers.attn.wq", (L, d, nh * hd), "normal", 1 / math.sqrt(d)),
        ("layers.attn.wk", (L, d, nkv * hd), "normal", 1 / math.sqrt(d)),
        ("layers.attn.wv", (L, d, nkv * hd), "normal", 1 / math.sqrt(d)),
        ("layers.attn.wo", (L, nh * hd, d), "normal",
         1 / math.sqrt(nh * hd)),
    ]
    if arch["qkv_bias"]:
        specs += [("layers.attn.bq", (L, nh * hd), "zeros", 0.0),
                  ("layers.attn.bk", (L, nkv * hd), "zeros", 0.0),
                  ("layers.attn.bv", (L, nkv * hd), "zeros", 0.0)]
    specs += [
        ("layers.mlp_norm.scale", (L, d), "ones", 0.0),
        ("layers.mlp_norm.bias", (L, d), "zeros", 0.0),
        ("layers.mlp.w_in", (L, d, f), "normal", 1 / math.sqrt(d)),
        ("layers.mlp.b_in", (L, f), "zeros", 0.0),
        ("layers.mlp.w_out", (L, f, d), "normal", 1 / math.sqrt(f)),
        ("layers.mlp.b_out", (L, d), "zeros", 0.0),
        ("final_norm.scale", (d,), "ones", 0.0),
        ("final_norm.bias", (d,), "zeros", 0.0),
    ]
    return specs


def make_batch(arch: dict, seq: int, batch: int, g: torch.Generator,
               device) -> dict:
    V = arch["vocab_size"]
    if arch["takes_embeddings"]:
        emb = torch.randn((batch, seq, arch["d_model"]), generator=g,
                          device=device, dtype=torch.float32)
        cls = torch.randint(0, V, (batch, 1), generator=g, device=device)
        return {"embeds": emb.to(torch.bfloat16),
                "labels": cls.expand(batch, seq).contiguous()}
    rows = torch.randint(0, V, (batch, seq + 1), generator=g, device=device)
    return {"tokens": rows[:, :-1].contiguous(),
            "labels": rows[:, 1:].contiguous()}


def matmul_params(arch: dict) -> int:
    """The layers' q, k, v, o and MLP weights and the tied unembedding
    (vocab x d); the embedding lookup, norms and biases count nothing."""
    d, f, L = arch["d_model"], arch["d_ff"], arch["n_layers"]
    nh, nkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // nh
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    return L * (attn + 2 * d * f) + arch["vocab_size"] * d


def attention_width(arch: dict) -> int:
    """Layers x query heads x head size: one score product of one token
    against one key position costs this many multiply-adds."""
    return arch["n_layers"] * arch["n_heads"] \
        * (arch["head_dim"] or arch["d_model"] // arch["n_heads"])
