"""Core layers (port of ``repro.models.layers``): RMSNorm and layer
norm, RoPE, GQA self- and cross-attention (cache-free, contiguous-cache
and paged), SwiGLU and GELU MLPs, embedding and tied LM head.

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
from repro_torch.sharding.context import (constrain_batch, constrain_q_seq,
                                          gather_fsdp, is_dtensor)

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


class _ContiguousGrad(torch.autograd.Function):
    """The identity on a DTensor, whose gradient's local shard leaves
    contiguous.  The attention einsums' gradients come back permuted; a
    plain reshape's backward copies such a gradient, but a DTensor takes
    the global strides for its shard's and its reshape backward views
    the shard, which fails."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def _split_heads(t, n: int, hd: int):
    """(..., n * hd) -> (..., n, hd).  A DTensor whose feature dim is
    sharded over mesh dims that do not divide ``n`` (2 KV heads on an
    8-wide 'model' axis) is gathered along it first: a shard must hold
    whole heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = t.dim() - 1
        sizes = [t.device_mesh.size(i) for i in range(t.device_mesh.ndim)]
        ways = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == last:
                ways *= sizes[i]
        if n % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in t.placements])
        return _ContiguousGrad.apply(t.reshape(*t.shape[:-1], n, hd))
    return t.reshape(*t.shape[:-1], n, hd)


def _project_qkv(params: Params, x: torch.Tensor, cfg,
                 src: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``src`` (the encoder output under
    cross-attention; ``x`` itself when None)."""
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if src is None else src
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = src @ params["wk"].to(dt)
    v = src @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = _split_heads(q, nh, hd)
    k = _split_heads(k, nkv, hd)
    v = _split_heads(v, nkv, hd)
    if cfg.qk_norm:                 # per head, after the reshape
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    return q, k, v


# above this many score elements per (b, h) row-block, sdpa walks query
# chunks so the (sq, skv) score matrix is never materialized whole
_SDPA_CHUNK_ELEMS = 4096 * 4096
_SDPA_Q_CHUNK = 1024


def _attn_mask(qpos, kpos, causal, window, device):
    """(1|b, sq, skv) bool: which keys each query row sees."""
    qp = qpos if qpos.dim() == 2 else qpos[None]              # (1|b, sq)
    mask = torch.ones((qp.shape[0], qp.shape[1], kpos.shape[0]),
                      dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, None, :] <= qp[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > qp[:, :, None] - window
    return mask


def _sdpa_dense(q, k, v, scale, qpos, kpos, causal, window):
    """q: (b, sq, nkv, g, hd) grouped; k/v: (b, skv, nkv, hd); qpos: (sq,)
    shared by the batch, or (b, sq) per lane."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = _attn_mask(qpos, kpos, causal, window, q.device)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())


def _sdpa_dense_lse(q, k, v, scale, qpos, kpos, causal, window):
    """``_sdpa_dense`` over a slice of the keys, also returning each query
    row's log-sum-exp: ``(out (b, sq, nkv, g, hd), lse (b, nkv, g, sq))``,
    both f32 — one split of a split-KV attention, for
    ``_merge_key_splits``.  A row that sees no key of the slice gives out
    0 and lse ``NEG_INF``: weight 0 in the merge, never NaN."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    mask = _attn_mask(qpos, kpos, causal, window, q.device)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    live = mask.any(dim=-1)[:, None, None]                   # (1|b,1,1,sq)
    lse = torch.where(live, torch.logsumexp(logits, dim=-1),
                      torch.full_like(logits[..., 0], NEG_INF))
    probs = torch.where(live[..., None], torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v.float()), lse


def _merge_key_splits(out, lse, groups):
    """Merge split-KV partials across ranks, in f32: each rank holds the
    attention over its own keys (``_sdpa_dense_lse``); the result is
    ``sum_r(o_r e^(lse_r - m)) / sum_r(e^(lse_r - m))`` with ``m`` the
    rows' largest lse — what ``kernels/csrc/split_kv.cuh`` does across
    splits on one card.  ``groups``: the process groups of the mesh dims
    the keys are split over, reduced one after another (max and sum are
    associative); one max and one sum all-reduce a group."""
    import torch.distributed._functional_collectives as funcol
    m = lse
    for g in groups:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
    w = torch.exp(lse - m)                                   # (b, nkv, g, sq)
    wq = w.permute(0, 3, 1, 2)[..., None]                    # (b, sq, nkv, g, 1)
    packed = torch.cat([(out * wq).reshape(-1), w.reshape(-1)])
    for g in groups:
        packed = funcol.wait_tensor(funcol.all_reduce(packed, "sum", g))
    num = packed[:out.numel()].reshape(out.shape)
    den = packed[out.numel():].reshape(w.shape).permute(0, 3, 1, 2)
    return num / den[..., None]


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
    if is_dtensor(q):
        return _sdpa_over_mesh(q, k, v, causal=causal, window=window,
                               q_positions=q_positions,
                               kv_positions=kv_positions)
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


def _sdpa_over_mesh(q, k, v, *, causal, window, q_positions, kv_positions):
    """``sdpa`` of DTensors, run on each rank's shards (DTensor's
    ``local_map`` idea, the JAX package's GSPMD partitioning of the same
    products): batch rows over the data axes, and heads over 'model' when
    the KV heads divide it (a rank then holds whole GQA groups); else the
    query sequence over 'model' (``constrain_q_seq``: context
    parallelism, K/V whole).  Each (row, head, query) still reads whole
    K/V rows, so the result is the unsharded one.  A K/V whose sequence
    is sharded (a decode cache) stays where it lies: see
    ``_sdpa_over_key_shards``.  Running the products
    on local tensors also keeps DTensor from searching placements for the
    grouped 5-D einsums."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.sharding import specs as sh

    if _key_sharded(k):
        return _sdpa_over_key_shards(q, k, v, causal=causal, window=window,
                                     q_positions=q_positions,
                                     kv_positions=kv_positions)
    mesh = q.device_mesh
    names = sh.axis_names(mesh)
    b, sq = q.shape[:2]
    nkv = k.shape[2]
    B = sh.batch_axes(mesh)
    rows = B if sh.spec_fits(mesh, sh.P(B), (b,)) else None
    heads = "model" if "model" in names and \
        sh.spec_fits(mesh, sh.P("model"), (nkv,)) else None
    seq = None
    if heads is None and "model" in names:
        q = constrain_q_seq(q)
        pl = q.placements[names.index("model")]
        seq = "model" if isinstance(pl, Shard) and pl.dim == 1 else None
    q_pl = sh.spec_placements(mesh, sh.P(rows, seq, heads, None))
    kv_pl = sh.spec_placements(mesh, sh.P(rows, None, heads, None))
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()

    qpos = (q_positions if q_positions is not None
            else torch.arange(sq, device=ql.device))
    if rows is not None and qpos.dim() == 2:      # one row per lane
        r = sh.shard_index(mesh, rows)
        qpos = qpos[r * ql.shape[0]:(r + 1) * ql.shape[0]]
    if seq is not None:
        r = sh.shard_index(mesh, seq)
        qpos = qpos[..., r * ql.shape[1]:(r + 1) * ql.shape[1]]
    out = sdpa(ql, kl, vl, causal=causal, window=window, q_positions=qpos,
               kv_positions=kv_positions)
    out = DTensor.from_local(out.contiguous(), mesh, q_pl, run_check=False,
                             shape=q.shape,
                             stride=sh.contiguous_stride(q.shape))
    if seq is not None:
        # the query sequence whole again: the output projection flattens
        # (b, s), which some DTensor versions cannot do with both sharded
        out = out.redistribute(mesh, kv_pl)
    return out


def _kv_query_placements(kv_pl):
    """The placements a query or a new K/V row takes beside K/V laid out
    ``kv_pl``: the same batch (dim 0) and head (dim 2) shards, and whole
    on every mesh dim that splits the K/V sequence (dim 1)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in kv_pl)


def _sdpa_over_key_shards(q, k, v, *, causal, window, q_positions,
                          kv_positions):
    """``sdpa`` over a K/V whose *sequence* is sharded (a decode cache laid
    out by ``decode_state_specs``'s sequence candidates: flash-decode
    context parallelism).  Nothing of K/V moves: each rank attends its
    queries, whole over the sequence's mesh dims, to its own key rows at
    their own positions, and the partials are merged by their
    log-sum-exp (``_merge_key_splits``) — a few (b, sq, nh, hd) all-reduces
    a layer where gathering K/V would move the whole cache.  Batch rows
    and heads keep the shards K/V have (a rank holds whole GQA groups)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.sharding import specs as sh

    mesh = k.device_mesh
    kv_pl = tuple(k.placements)
    q_pl = _kv_query_placements(kv_pl)
    seq_dims = [i for i, p in enumerate(kv_pl)
                if isinstance(p, Shard) and p.dim == 1]
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()
    # this rank's first batch row and key row, in DTensor's own shard order
    _, off = compute_local_shape_and_global_offset(k.shape, mesh, kv_pl)

    b, sq, nh_l, hd = ql.shape
    skv, nkv_l = kl.shape[1], kl.shape[2]
    qg = ql.reshape(b, sq, nkv_l, nh_l // nkv_l, hd)
    qpos = (q_positions if q_positions is not None
            else torch.arange(sq, device=ql.device))
    if qpos.dim() == 2 and qpos.shape[0] != b:            # one row per lane
        qpos = qpos[off[0]:off[0] + b]
    kpos = (kv_positions if kv_positions is not None
            else torch.arange(k.shape[1], device=ql.device))
    kpos = kpos[off[1]:off[1] + skv]
    scale = 1.0 / math.sqrt(hd)
    step = (sq if sq * skv <= _SDPA_CHUNK_ELEMS or sq % _SDPA_Q_CHUNK
            else _SDPA_Q_CHUNK)
    parts = [_sdpa_dense_lse(qg[:, i:i + step], kl, vl, scale,
                             qpos[..., i:i + step], kpos, causal, window)
             for i in range(0, sq, step)]
    out = _merge_key_splits(torch.cat([o for o, _ in parts], dim=1),
                            torch.cat([l for _, l in parts], dim=-1),
                            [mesh.get_group(i) for i in seq_dims])
    out = out.reshape(b, sq, nh_l, hd).to(q.dtype)
    return DTensor.from_local(out.contiguous(), mesh, q_pl, run_check=False,
                              shape=q.shape,
                              stride=sh.contiguous_stride(q.shape))


def _store_rows_over_key_shards(plane, start, rows) -> None:
    """``store_rows`` into a DTensor plane whose sequence (dim 1) is
    sharded: each rank writes, into its own shard, the rows that fall in
    its key range, and no rank's shard moves.  ``start``: the int write
    row shared by the batch, or (b,) per-lane write rows (already
    clamped); ``rows``: the chunk (b, sq, nkv, hd)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = plane.device_mesh
    pl = tuple(plane.placements)
    rl = rows.redistribute(mesh, _kv_query_placements(pl)).to_local() \
        if is_dtensor(rows) else rows
    local = plane.to_local()
    _, off = compute_local_shape_and_global_offset(plane.shape, mesh, pl)
    lo, n = off[1], local.shape[1]
    sq = rl.shape[1]
    if not isinstance(start, torch.Tensor):
        a, b = max(start, lo), min(start + sq, lo + n)
        if a < b:
            store_rows(local, (slice(None), slice(a - lo, b - lo)),
                       rl[:, a - start:b - start])
        return
    start = start[off[0]:off[0] + local.shape[0]] \
        if start.shape[0] != local.shape[0] else start
    at = start[:, None] + torch.arange(sq, device=start.device) - lo
    mine = (at >= 0) & (at < n)
    lane = torch.arange(at.shape[0], device=at.device)[:, None].expand_as(at)
    store_rows(local, (lane[mine], at[mine]), rl[mine])


def _key_sharded(t) -> bool:
    """Whether ``t`` is a DTensor with its dim 1 (a K/V sequence)
    sharded."""
    if not is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == 1 for p in t.placements)


def attention(params: Params, x: torch.Tensor, cfg,
              kv_cache: Optional[dict] = None, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              window: Optional[int] = None,
              xkv: Optional[torch.Tensor] = None, rope: bool = True,
              impl: str = "xla"):
    """Self- or cross-attention layer.  Returns (out, kv_cache).

    Without a cache (forward, training, eval): positions default to
    arange, attention is ``causal`` or not, and ``impl`` routes ``sdpa``
    (the returned cache is None).

    ``xkv`` makes it cross-attention: k and v are projected from ``xkv``
    and, with ``rope``, only q is rotated.  ``rope=False`` rotates
    nothing.  A cross-attention ``kv_cache`` holds the encoder's
    precomputed K/V: it is read, never written, and attended to
    non-causally with plain products (the returned cache is the same).

    kv_cache: {"k": (b, max_s, nkv, hd), "v": ..., "index": int or (b,)
    int64 tensor} — this chunk's rows are written at ``index`` IN PLACE
    (where the JAX package returns an updated copy) and attention runs
    over the filled prefix; the returned cache has ``index`` advanced.  A
    tensor index gives every lane its own write row and causal limit (the
    JAX package's per-slot ``vmap``); like its ``dynamic_update_slice``,
    the write start is clamped so the chunk fits the cache."""
    b, sq, _ = x.shape
    cross = xkv is not None
    q, k, v = _project_qkv(params, x, cfg, xkv)
    if positions is None:
        positions = torch.arange(sq, device=x.device)[None, :].expand(b, sq)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if not cross:
            k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None and cross:
        out = sdpa(q, kv_cache["k"], kv_cache["v"], causal=False)
        out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
        return out @ params["wo"].to(x.dtype), kv_cache
    if kv_cache is None:
        out = sdpa(q, k, v, causal=causal, window=window, impl=impl)
        out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
        return out @ params["wo"].to(x.dtype), None
    idx = kv_cache["index"]
    ck, cv = kv_cache["k"], kv_cache["v"]
    steps = torch.arange(sq, device=x.device)
    if isinstance(idx, torch.Tensor):
        start = torch.clamp(idx, max=ck.shape[1] - sq)
        where = (torch.arange(b, device=x.device)[:, None],
                 start[:, None] + steps)
        qpos = idx[:, None] + steps                          # (b, sq)
    else:
        idx = start = int(idx)
        where = (slice(None), slice(idx, idx + sq))
        qpos = idx + steps                                   # (sq,)
    for plane, new in ((ck, k), (cv, v)):
        if _key_sharded(plane):       # the rank owning each row writes it
            _store_rows_over_key_shards(plane, start, new)
        else:
            store_rows(plane, where, new)
    kvpos = torch.arange(ck.shape[1], device=x.device)
    # unwritten slots are masked by the causal predicate (kvpos <= qpos)
    out = sdpa(q, ck, cv, causal=True, window=window,
               q_positions=qpos, kv_positions=kvpos)
    out = out.reshape(b, sq, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"].to(x.dtype), \
        {"k": ck, "v": cv, "index": idx + sq}


def store_rows(plane: torch.Tensor, index, rows: torch.Tensor) -> None:
    """``plane[index] = rows`` cast to the plane's dtype, in place: a KV
    cache or page write.  An fp8 plane (``kv_cache_dtype=
    "float8_e4m3fn"``: cast on write, upcast on read, as in the JAX
    package) is written as its bytes through ``uint8`` views, which is
    exact and which every PyTorch build indexes."""
    rows = rows.to(plane.dtype)
    if plane.dtype == torch.float8_e4m3fn:
        plane, rows = plane.view(torch.uint8), rows.view(torch.uint8)
    plane[index] = rows


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
    store_rows(pages["k"], (blk, off), k)
    store_rows(pages["v"], (blk, off), v)


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
    """Stacked (layers-first) KV cache for decode.

    ``cfg.kv_cache_dtype="float8_e4m3fn"`` halves the cache's bytes, as in
    the JAX package: rows are cast on write (``store_rows``) and upcast to
    f32 where attention reads them."""
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
    """Rows of the table for ``tokens``, gathered then cast: the same
    numbers as the JAX cast-then-gather, without a compute-dtype copy of
    the whole table.  ``F.embedding`` rather than indexing: DTensor has
    placement rules for it (and its backward) on sharded tokens, where
    some of its versions have none for an indexed write.  A lookup in a
    vocab-sharded table is a masked partial sum, reduced at once: some
    DTensor versions lose its mask across a following op."""
    out = F.embedding(tokens, gather_fsdp(params["table"]))
    if is_dtensor(out) and any(p.is_partial() for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_partial() else p for p in out.placements])
    return out.to(dtype)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in f32.  Over a mesh the residual stream is
    re-gathered along the sequence first (``constrain_batch``): a product
    flattens (b, s), which DTensor cannot do with both dims sharded."""
    x = constrain_batch(x, seq_parallel=False)
    return x.float() @ gather_fsdp(params["table"]).float().t()
