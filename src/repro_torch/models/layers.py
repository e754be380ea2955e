"""Core layers, dense subset (port of ``repro.models.layers``): RMSNorm
and layer norm, RoPE, GQA attention (cache-free, contiguous-cache and
paged), SwiGLU and GELU MLPs, embedding and tied LM head.

Plain functions over tensors: every layer is an ``init_*`` returning a
param dict plus an apply function taking ``(params, inputs, cfg)``.  The
params keep the JAX package's layout — weights are ``(in, out)`` and
stacked layers carry a leading ``layers`` axis — so parameters carry
across as a straight conversion (``checkpoint/convert.py``).

Compute dtype is ``cfg.dtype``; weights are cast to it at each use, as in
the JAX package.  ``models.api.prepare_params`` may cast the >= 2-D layer
weights once ahead of time; the per-use cast is then a no-op with the same
numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import torch_dtype

Params = dict  # nested dict[str, torch.Tensor]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(generator, shape, in_axis_size, dtype, device):
    """Scaled-normal init: N(0, 1/fan_in)."""
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * std
    return x.to(dtype)


def embed_init(generator, shape, dtype, device):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * 0.02
    return x.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead=()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-6,
             use_kernel: bool = False):
    """``use_kernel`` routes through ``kernels.ops.rms_norm`` (the CUDA
    kernel on a CUDA device); no caller sets it, as in the JAX package."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.rms_norm(x, params["scale"], eps=eps)
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def init_layernorm(d: int, dtype, device, lead=()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (.., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                       # (.., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, qk-norm, causal / sliding window)
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, device, lead=()) -> Params:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pdt = torch_dtype(cfg.param_dtype)
    p: Params = {
        "wq": dense_init(generator, (*lead, d, nh * hd), d, pdt, device),
        "wk": dense_init(generator, (*lead, d, nkv * hd), d, pdt, device),
        "wv": dense_init(generator, (*lead, d, nkv * hd), d, pdt, device),
        "wo": dense_init(generator, (*lead, nh * hd, d), nh * hd, pdt,
                         device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, nh * hd), dtype=pdt, device=device)
        p["bk"] = torch.zeros((*lead, nkv * hd), dtype=pdt, device=device)
        p["bv"] = torch.zeros((*lead, nkv * hd), dtype=pdt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, pdt, device, lead)
        p["k_norm"] = init_rmsnorm(hd, pdt, device, lead)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg):
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(*x.shape[:-1], nh, hd)
    k = k.reshape(*x.shape[:-1], nkv, hd)
    v = v.reshape(*x.shape[:-1], nkv, hd)
    if cfg.qk_norm:                 # per head, after the reshape
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    return q, k, v


# above this many score elements per (b, h) row-block, sdpa walks query
# chunks so the (sq, skv) score matrix is never materialized whole
_SDPA_CHUNK_ELEMS = 4096 * 4096
_SDPA_Q_CHUNK = 1024


def _sdpa_dense(q, k, v, scale, qpos, kpos, causal, window):
    """q: (b, sq, nkv, g, hd) grouped; k/v: (b, skv, nkv, hd); qpos: (sq,)
    shared by the batch, or (b, sq) per lane."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    qp = qpos if qpos.dim() == 2 else qpos[None]              # (1|b, sq)
    mask = torch.ones((qp.shape[0], qp.shape[1], kpos.shape[0]),
                      dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None, :] <= qp[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > qp[:, :, None] - window
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())


def sdpa(q, k, v, *, causal: bool, window: Optional[int] = None,
         q_positions: Optional[torch.Tensor] = None,
         kv_positions: Optional[torch.Tensor] = None,
         impl: str = "xla") -> torch.Tensor:
    """Scaled dot-product attention with GQA broadcast.

    q: (b, sq, nh, hd); k/v: (b, skv, nkv, hd).  nh % nkv == 0.
    ``q_positions`` is (sq,), or (b, sq) when each lane has its own.
    ``impl='cuda'`` takes the flash kernel (``kernels.ops.flash_attention``:
    the CUDA kernel on CUDA tensors, its plain version on the CPU) exactly
    when the JAX package takes its Pallas kernel: causal and ``sq > 1``,
    with positions from 0.  Otherwise plain products, query-chunked above
    ``_SDPA_CHUNK_ELEMS`` score elements."""
    if impl == "cuda" and causal and q.shape[1] > 1:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True, window=window)
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    groups = nh // nkv
    qg = q.reshape(b, sq, nkv, groups, hd)
    scale = 1.0 / math.sqrt(hd)
    qpos = (q_positions if q_positions is not None
            else torch.arange(sq, device=q.device))
    kpos = (kv_positions if kv_positions is not None
            else torch.arange(skv, device=q.device))
    if sq * skv <= _SDPA_CHUNK_ELEMS or sq % _SDPA_Q_CHUNK != 0:
        out = _sdpa_dense(qg, k, v, scale, qpos, kpos, causal, window)
        return out.reshape(b, sq, nh, hd).to(q.dtype)
    outs = [_sdpa_dense(qg[:, i:i + _SDPA_Q_CHUNK], k, v, scale,
                        qpos[..., i:i + _SDPA_Q_CHUNK], kpos, causal, window)
            for i in range(0, sq, _SDPA_Q_CHUNK)]
    return torch.cat(outs, dim=1).reshape(b, sq, nh, hd).to(q.dtype)


def attention(params: Params, x: torch.Tensor, cfg,
              kv_cache: Optional[dict] = None, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None, impl: str = "xla"):
    """Self-attention layer.  Returns (out, kv_cache).

    Without a cache (forward, training, eval): positions default to
    arange, attention is ``causal`` or not, and ``impl`` routes ``sdpa``
    (the returned cache is None).

    kv_cache: {"k": (b, max_s, nkv, hd), "v": ..., "index": int or (b,)
    int64 tensor} — this chunk's rows are written at ``index`` IN PLACE
    (where the JAX package returns an updated copy) and attention runs
    over the filled prefix; the returned cache has ``index`` advanced.  A
    tensor index gives every lane its own write row and causal limit (the
    JAX package's per-slot ``vmap``); like its ``dynamic_update_slice``,
    the write start is clamped so the chunk fits the cache."""
    b, sq, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :].expand(b, sq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = sdpa(q, k, v, causal=causal, window=window, impl=impl)
        out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
        return out @ params["wo"].to(x.dtype), None
    idx = kv_cache["index"]
    ck, cv = kv_cache["k"], kv_cache["v"]
    steps = torch.arange(sq, device=x.device)
    if isinstance(idx, torch.Tensor):
        rows = torch.clamp(idx, max=ck.shape[1] - sq)[:, None] + steps
        lane = torch.arange(b, device=x.device)[:, None]
        ck[lane, rows] = k.to(ck.dtype)
        cv[lane, rows] = v.to(cv.dtype)
        qpos = idx[:, None] + steps                          # (b, sq)
    else:
        idx = int(idx)
        ck[:, idx:idx + sq] = k.to(ck.dtype)
        cv[:, idx:idx + sq] = v.to(cv.dtype)
        qpos = idx + steps                                   # (sq,)
    kvpos = torch.arange(ck.shape[1], device=x.device)
    # unwritten slots are masked by the causal predicate (kvpos <= qpos)
    out = sdpa(q, ck, cv, causal=True, window=window,
               q_positions=qpos, kv_positions=kvpos)
    out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), \
        {"k": ck, "v": cv, "index": idx + sq}


def _scatter_kv_rows(pages: dict, blk, off, k, v) -> None:
    """Write K/V rows through the block table into one layer's pages, IN
    PLACE (the JAX package donates the pages and gets an updated copy).
    pages: {"k","v"} of (P, bs, nkv, hd) — plus {"k_scale","v_scale"} of
    (P, bs, nkv) when the pool is int8, in which case the rows are
    quantized per row on write (``ref.quantize_kv``) and the scales land
    at the same table-addressed slots.  blk/off index rows; k/v are the
    new rows.  Duplicate (blk, off) pairs — inactive lanes all aim at the
    garbage block — land in an unspecified order, which is harmless."""
    if "k_scale" in pages:
        from repro_torch.kernels.ref import quantize_kv
        for name, rows in (("k", k), ("v", v)):
            q8, scale = quantize_kv(rows)
            pages[name][blk, off] = q8
            pages[f"{name}_scale"][blk, off] = scale
        return
    pages["k"][blk, off] = k.to(pages["k"].dtype)
    pages["v"][blk, off] = v.to(pages["v"].dtype)


# the fused layer's impls, and the attention impl each means where the
# fused layer does not apply (int8 pools, non-RMSNorm/SwiGLU configs) and
# for speculative verify: "fused" is the kernel (on a CUDA device; the
# plain version on the CPU), "fused_ref" the plain version anywhere
FUSED_IMPLS = {"fused": None, "fused_ref": "ref"}


def paged_attention_decode(params: Params, x: torch.Tensor, cfg, *,
                           pages: dict, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           window: Optional[int] = None, impl=None):
    """One-token attention block over a paged KV cache (one layer's pages).

    x: (n, 1, d) *normed* hidden states, one decode lane per row.
    pages: {"k","v"} of (P, bs, nkv, hd) physical blocks (+ per-row
    {"k_scale","v_scale"} when int8); tables: (n, B) int32 block ids
    (unused entries name the pool's garbage block); lengths: (n,) int32
    rows already written, i.e. this token's row index.

    Writes this step's K/V row through the block table in place and
    attends to the ``[0, lengths]`` logical prefix through
    ``kernels.ops.paged_attention`` (``paged_attention_quant`` for int8
    pools).  A fused ``impl`` takes the attention kernel it stands for
    (``FUSED_IMPLS``).  Returns ``out`` (n, 1, d)."""
    from repro_torch.kernels import ops as kops
    impl = FUSED_IMPLS.get(impl, impl)
    n = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg)
    positions = lengths[:, None]                        # (n, 1)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    bs = pages["k"].shape[1]
    lens = lengths.long()
    blk = tables[torch.arange(n, device=x.device), lens // bs].long()
    _scatter_kv_rows(pages, blk, lens % bs, k[:, 0], v[:, 0])
    if "k_scale" in pages:
        out = kops.paged_attention_quant(
            q[:, 0].contiguous(), pages["k"], pages["v"], pages["k_scale"],
            pages["v_scale"], tables, lengths + 1, window=window, impl=impl)
    else:
        out = kops.paged_attention(q[:, 0].contiguous(), pages["k"],
                                   pages["v"], tables, lengths + 1,
                                   window=window, impl=impl)
    out = out.reshape(n, 1, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype)


def paged_decode_layer_fused(lp: Params, h: torch.Tensor, cfg, *,
                             pages: dict, tables: torch.Tensor,
                             lengths: torch.Tensor,
                             window: Optional[int] = None, impl=None):
    """One FULL pre-norm decode block through the fused layer: the
    attention norm, QKV projection with qk-norm, rope and the K/V scatter
    run here (they write the pages); attention through the block table,
    the wo projection, residual, MLP RMSNorm, SwiGLU and the second
    residual run in ``kernels.ops.fused_decode_layer`` (``impl``: 'cuda'
    | 'ref' | None, by device).  Requires ``cfg.norm == 'rms'``,
    ``cfg.mlp == 'swiglu'`` and an fp pool — callers gate on that.

    h: (n, 1, d) residual stream.  Returns the new residual (n, 1, d)."""
    from repro_torch.kernels import ops as kops
    n = h.shape[0]
    x = rms_norm(lp["attn_norm"], h)
    q, k, v = _project_qkv(lp["attn"], x, cfg)
    positions = lengths[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    bs = pages["k"].shape[1]
    lens = lengths.long()
    blk = tables[torch.arange(n, device=h.device), lens // bs].long()
    _scatter_kv_rows(pages, blk, lens % bs, k[:, 0], v[:, 0])
    dt = h.dtype
    # every operand in h's dtype, the 1-D norm scale too (as the JAX
    # package casts them before its kernel call)
    out = kops.fused_decode_layer(
        h[:, 0].contiguous(), q[:, 0].contiguous(), pages["k"], pages["v"],
        tables, lengths + 1, lp["attn"]["wo"].to(dt).contiguous(),
        lp["mlp_norm"]["scale"].to(dt).contiguous(),
        lp["mlp"]["w_gate"].to(dt).contiguous(),
        lp["mlp"]["w_up"].to(dt).contiguous(),
        lp["mlp"]["w_down"].to(dt).contiguous(), window=window, impl=impl)
    return out[:, None, :]


def paged_attention_verify(params: Params, x: torch.Tensor, cfg, *,
                           pages: dict, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           window: Optional[int] = None, impl=None):
    """k-token attention block over a paged KV cache (speculative verify).

    The multi-token twin of ``paged_attention_decode``: x is ``(n, k, d)``
    *normed* hidden states — the last committed token followed by k-1
    draft tokens per lane.  Writes all k K/V rows through the block table
    in place (rows ``lengths + [0, k)``; lanes whose table names only the
    garbage block park their rows there harmlessly), then attends each of
    the k query positions to its own causal prefix ``[0, lengths + i]``
    through ``kernels.ops.paged_verify``.  int8 pools take the gathered
    ``ref.paged_verify_quant_ref`` whatever ``impl`` says, as the JAX
    package does: draft depths are too small to earn a quant verify
    kernel.  A fused ``impl`` (a spec engine over a fused paged inner)
    verifies through the verify kernel (``FUSED_IMPLS``).  Returns ``out``
    (n, k, d)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    impl = FUSED_IMPLS.get(impl, impl)
    n, kk, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    positions = lengths.long()[:, None] \
        + torch.arange(kk, device=x.device)[None, :]            # (n, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    bs = pages["k"].shape[1]
    col = torch.clamp(positions // bs, max=tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, col)                   # (n, k)
    _scatter_kv_rows(pages, blk, positions % bs, k, v)
    if "k_scale" in pages:
        out = kref.paged_verify_quant_ref(
            q, pages["k"], pages["v"], pages["k_scale"], pages["v_scale"],
            tables, lengths, window=window)
    else:
        out = kops.paged_verify(q.contiguous(), pages["k"], pages["v"],
                                tables, lengths, window=window, impl=impl)
    out = out.reshape(n, kk, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ params["wo"].to(x.dtype)


def init_kv_cache(cfg, batch: int, max_seq: int, device,
                  n_layers: Optional[int] = None, dtype=None) -> dict:
    """Stacked (layers-first) KV cache for decode."""
    L = n_layers if n_layers is not None else cfg.n_layers
    dtype = dtype if dtype is not None else torch_dtype(cfg.kv_cache_dtype)
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_swiglu(generator, cfg, device, lead=()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pdt = torch_dtype(cfg.param_dtype)
    return {
        "w_gate": dense_init(generator, (*lead, d, f), d, pdt, device),
        "w_up": dense_init(generator, (*lead, d, f), d, pdt, device),
        "w_down": dense_init(generator, (*lead, f, d), f, pdt, device),
    }


def swiglu(params: Params, x: torch.Tensor,
           use_kernel: bool = False) -> torch.Tensor:
    """``use_kernel`` routes through ``kernels.ops.swiglu`` (the CUDA
    kernel on a CUDA device); no caller sets it, as in the JAX package."""
    dt = x.dtype
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.swiglu(x, params["w_gate"].to(dt),
                           params["w_up"].to(dt), params["w_down"].to(dt))
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (F.silu(g) * u) @ params["w_down"].to(dt)


def init_gelu_mlp(generator, cfg, device, lead=()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pdt = torch_dtype(cfg.param_dtype)
    return {
        "w_in": dense_init(generator, (*lead, d, f), d, pdt, device),
        "b_in": torch.zeros((*lead, f), dtype=pdt, device=device),
        "w_out": dense_init(generator, (*lead, f, d), f, pdt, device),
        "b_out": torch.zeros((*lead, d), dtype=pdt, device=device),
    }


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    # tanh approximation: jax.nn.gelu's default
    dt = x.dtype
    h = F.gelu(x @ params["w_in"].to(dt) + params["b_in"].to(dt),
               approximate="tanh")
    return h @ params["w_out"].to(dt) + params["b_out"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d: int, dtype, device) -> Params:
    return {"table": embed_init(generator, (vocab, d), dtype, device)}


def embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather-then-cast: the same numbers as the JAX cast-then-gather,
    # without a compute-dtype copy of the whole table
    return params["table"][tokens].to(dtype)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in f32."""
    return x.float() @ params["table"].float().t()
