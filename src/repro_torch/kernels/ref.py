"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is compared against, and what a kernel wrapper runs
for a tensor that lies on the CPU (port of ``repro.kernels.ref``)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """Plain GQA attention, the function ``flash_attention_bhsd`` computes.

    q: (b, nh, sq, hd); k/v: (b, nkv, sk, hd).  Query and key positions
    both start at 0 (for ``sq != sk`` the causal diagonal is top-left);
    key ``j`` is visible to query ``i`` iff ``j <= i`` (causal) and ``j >
    i - window`` (window).  f32 logits, masked to -1e30, f32 softmax.
    Returns (b, nh, sq, hd) in q's dtype."""
    b, nh, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    groups = nh // nkv
    qg = q.reshape(b, nkv, groups, sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(b, nh, sq, hd).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, tables, lengths, *, window=None):
    """Gather-based single-token paged attention.

    q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) physical
    block ids; lengths: (n,) valid rows per lane including the current
    token.  Gathers each lane's logical sequence contiguous (the copy the
    kernel exists to avoid), masks rows past ``length`` (and outside the
    window) to -1e30 — masked rows get exactly zero weight, so stale page
    contents never perturb the output — and runs the grouped-GQA f32
    softmax.  Returns (n, nh, hd) in q's dtype."""
    n, nh, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    n_blocks = tables.shape[1]
    groups = nh // nkv
    tables = tables.long()
    k = k_pages[tables].reshape(n, n_blocks * bs, nkv, hd)
    v = v_pages[tables].reshape(n, n_blocks * bs, nkv, hd)
    qg = q.reshape(n, nkv, groups, hd).float()
    logits = torch.einsum("nkgh,nskh->nkgs", qg, k.float()) / math.sqrt(hd)
    kv_pos = torch.arange(n_blocks * bs, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()[:, None]
    mask = kv_pos < lengths
    if window is not None:
        mask &= kv_pos > (lengths - 1) - window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nkgs,nskh->nkgh", probs, v.float())
    return out.reshape(n, nh, hd).to(q.dtype)


def _verify_mask(lengths, kk, n_rows, window, device):
    """(n, k, S) mask of the rows query ``i`` of each lane attends:
    ``[0, lengths + i]``, inside the window when there is one."""
    positions = lengths.to(device).long()[:, None] \
        + torch.arange(kk, device=device)[None, :]                 # (n, k)
    kv_pos = torch.arange(n_rows, device=device)[None, None, :]
    mask = kv_pos <= positions[:, :, None]
    if window is not None:
        mask &= kv_pos > positions[:, :, None] - window
    return mask


def _verify_attend(q, k, v, mask):
    """Grouped-GQA f32 softmax of k query positions per lane over gathered
    f32 K/V rows.  q: (n, k, nh, hd); k/v: (n, S, nkv, hd) f32; mask:
    (n, k, S).  Returns (n, k, nh, hd) in q's dtype."""
    n, kk, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(n, kk, nkv, nh // nkv, hd).float()
    logits = torch.einsum("nqkgh,nskh->nkgqs", qg, k) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nkgqs,nskh->nqkgh", probs, v)
    return out.reshape(n, kk, nh, hd).to(q.dtype)


def paged_verify_ref(q, k_pages, v_pages, tables, lengths, *, window=None):
    """Gather-based multi-query (speculative verify) paged attention.

    q: (n, k, nh, hd) — k query positions per lane, position ``i`` at
    logical row ``lengths[lane] + i`` (its K/V row already written);
    k/v_pages: (P, bs, nkv, hd); tables: (n, B); lengths: (n,) rows
    committed BEFORE the round, so query ``i`` attends ``[0, lengths +
    i]``.  Returns (n, k, nh, hd) in q's dtype."""
    n, kk, _, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    nb = tables.shape[1]
    tables = tables.long()
    k = k_pages[tables].reshape(n, nb * bs, nkv, hd).float()
    v = v_pages[tables].reshape(n, nb * bs, nkv, hd).float()
    mask = _verify_mask(lengths, kk, nb * bs, window, q.device)
    return _verify_attend(q, k, v, mask)


# ---------------------------------------------------------------------------
# int8 KV quantization (per-row symmetric; scales stored beside the pages)
# ---------------------------------------------------------------------------

QUANT_EPS = 1e-8


def quantize_kv(x):
    """Symmetric per-row int8 quantization over the trailing (head_dim)
    axis: ``scale = max(max|x|, 1e-8) / 127`` in f32 (all-zero rows —
    fresh pages, the garbage block — round-trip to exact zeros), values
    ``x / scale`` rounded half to even and clipped to ±127.  Gives the JAX
    package's int8 values bit for bit on f32 input: the division is a true
    f32 division, not a product with the reciprocal.  Returns ``(q int8,
    scale f32)``, ``scale`` shaped like ``x`` without its last axis."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale):
    """Inverse of ``quantize_kv``: f32 rows from int8 values + scales."""
    return q.float() * scale[..., None].float()


def _gather_dequant(pages, scales, tables):
    n, nb = tables.shape
    _, bs, nkv, hd = pages.shape
    return dequantize_kv(pages[tables].reshape(n, nb * bs, nkv, hd),
                         scales[tables].reshape(n, nb * bs, nkv))


def paged_attention_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, *, window=None):
    """Gather-based single-token paged attention over int8 pages.

    k/v_pages: (P, bs, nkv, hd) int8; k/v_scales: (P, bs, nkv) f32 per-row
    scales.  Gathers the int8 rows + scales through the table, dequantizes
    them and runs ``paged_attention_ref``'s masked f32 softmax.  Returns
    (n, nh, hd) in q's dtype."""
    n, nh, hd = q.shape
    nb = tables.shape[1]
    bs, nkv = k_pages.shape[1], k_pages.shape[2]
    tables = tables.long()
    k = _gather_dequant(k_pages, k_scales, tables)
    v = _gather_dequant(v_pages, v_scales, tables)
    qg = q.reshape(n, nkv, nh // nkv, hd).float()
    logits = torch.einsum("nkgh,nskh->nkgs", qg, k) / math.sqrt(hd)
    kv_pos = torch.arange(nb * bs, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()[:, None]
    mask = kv_pos < lengths
    if window is not None:
        mask &= kv_pos > (lengths - 1) - window
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("nkgs,nskh->nkgh", probs, v)
    return out.reshape(n, nh, hd).to(q.dtype)


def paged_verify_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                           tables, lengths, *, window=None):
    """Multi-query verify over int8 pages: gather + dequantize, then the
    ``paged_verify_ref`` math.  This is the int8 verify path itself, as in
    the JAX package: no kernel is worth its surface at draft depths k <= 8
    (``repro.kernels.ref.paged_verify_quant_ref``)."""
    kk = q.shape[1]
    nb = tables.shape[1]
    bs = k_pages.shape[1]
    tables = tables.long()
    k = _gather_dequant(k_pages, k_scales, tables)
    v = _gather_dequant(v_pages, v_scales, tables)
    mask = _verify_mask(lengths, kk, nb * bs, window, q.device)
    return _verify_attend(q, k, v, mask)
