"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is compared against, and what a kernel wrapper runs
for a tensor that lies on the CPU (port of ``repro.kernels.ref``)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
