"""Plain PyTorch versions of the port's kernels: the ground truth each
hand-written kernel is compared against, and what a kernel wrapper runs
for a tensor that lies on the CPU (port of ``repro.kernels.ref``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def gather_blocks(pages, tables):
    """``pages[tables]``: each lane's physical blocks, in table order.  fp8
    pages (the fp8 KV cache) are gathered as their bytes through ``uint8``
    views, which is exact and which every PyTorch build indexes."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[tables].view(pages.dtype)
    return pages[tables]


def paged_attention_ref(q, k_pages, v_pages, tables, lengths, *, window=None):
    """Gather-based single-token paged attention.

    q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) physical
    block ids; lengths: (n,) valid rows per lane including the current
    token.  Pages may be f32, bf16 or fp8 e4m3 (upcast to f32 as they are
    read, as the JAX kernels' ``.astype(f32)``).  Gathers each lane's
    logical sequence contiguous (the copy the kernel exists to avoid),
    masks rows past ``length`` (and outside the
    window) to -1e30 — masked rows get exactly zero weight, so stale page
    contents never perturb the output — and runs the grouped-GQA f32
    softmax.  Returns (n, nh, hd) in q's dtype."""
    n, nh, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    n_blocks = tables.shape[1]
    groups = nh // nkv
    tables = tables.long()
    k = gather_blocks(k_pages, tables).reshape(n, n_blocks * bs, nkv, hd)
    v = gather_blocks(v_pages, tables).reshape(n, n_blocks * bs, nkv, hd)
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
    k = gather_blocks(k_pages, tables).reshape(n, nb * bs, nkv, hd).float()
    v = gather_blocks(v_pages, tables).reshape(n, nb * bs, nkv, hd).float()
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


# ---------------------------------------------------------------------------
# RMSNorm, SwiGLU and the fused paged decode layer
# ---------------------------------------------------------------------------

def rms_norm_ref(x, w, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis in f32, cast
    back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def swiglu_ref(x, w_gate, w_up, w_down):
    """``silu(x @ Wg) * (x @ Wu) @ Wd`` in f32, cast back to x's dtype."""
    x32 = x.float()
    g = x32 @ w_gate.float()
    u = x32 @ w_up.float()
    return ((F.silu(g) * u) @ w_down.float()).to(x.dtype)


def fused_decode_layer_ref(h, q, k_pages, v_pages, tables, lengths, wo,
                           mlp_scale, w_gate, w_up, w_down, *, window=None,
                           eps: float = 1e-6):
    """The fused paged decode layer: paged attention through the block
    table, output projection + residual, RMSNorm, SwiGLU and the second
    residual — the whole per-layer epilogue after the QKV projection,
    rope and the KV scatter (which stay outside: they write the pages).

    h: (n, d) residual stream; q: (n, nh, hd) roped queries; lengths:
    valid rows per lane INCLUDING the current token (the
    ``paged_attention_ref`` convention).  The attention output comes back
    in q's dtype, as in the JAX oracle; everything after it is f32, cast
    once to h's dtype."""
    n, nh, hd = q.shape
    attn = paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                               window=window)
    h1 = h.float() + attn.reshape(n, nh * hd).float() @ wo.float()
    var = h1.square().mean(dim=-1, keepdim=True)
    hn = h1 * torch.rsqrt(var + eps) * mlp_scale.float()
    g = hn @ w_gate.float()
    u = hn @ w_up.float()
    out = h1 + (F.silu(g) * u) @ w_down.float()
    return out.to(h.dtype)


# ---------------------------------------------------------------------------
# SSD (Mamba2 state-space duality) scan
# ---------------------------------------------------------------------------

def ssd_scan_ref(x, log_a, b_coef, c_coef, *, chunk: int):
    """Sequential-recurrence oracle (O(s) loop, independent of the chunked
    algorithm): ``S_t = exp(a_t) S_{t-1} + x_t B_t^T; y_t = S_t . C_t``.

    x: (b, s, h, p); log_a: (b, s, h); b_coef / c_coef: (b, s, h, n).
    ``chunk`` is unused (the signature of the kernel it checks).  f32
    state; returns y in x's dtype."""
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = state * torch.exp(log_a[:, t].float())[..., None, None] \
            + x[:, t].float()[..., None] * b_coef[:, t].float()[..., None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c_coef[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x, log_a, b_coef, c_coef, chunk: int,
                    initial_state=None):
    """The chunked SSD scan in plain products — the function
    ``ssd_scan.ssd_scan_bshpn`` computes, and the body of
    ``models.ssm.ssd_chunked`` without its kernel switch.

    Quadratic within a chunk (``(C B^T ⊙ decay) x``, the decay masked
    BEFORE the exp), a linear recurrence of the (p, n) f32 state across
    chunks.  x: (b, s, h, p) with ``s % chunk == 0``; log_a: (b, s, h);
    b_coef / c_coef: (b, s, h, n); initial_state: None or (b, h, p, n).
    Returns ``(y (b, s, h, p) in x's dtype, final_state (b, h, p, n)
    f32)``."""
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, h, p).to(f32)
    ac = log_a.reshape(bsz, nc, chunk, h).to(f32)
    bc = b_coef.reshape(bsz, nc, chunk, h, n).to(f32)
    cc = c_coef.reshape(bsz, nc, chunk, h, n).to(f32)

    a_cum = torch.cumsum(ac, dim=2)                          # (b,nc,Q,h)
    a_tot = a_cum[:, :, -1]                                  # (b,nc,h)

    # intra-chunk: L[i,j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0
    li = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # (b,nc,Q,Q,h)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: the i<j region has li > 0 and exp overflows (its
    # gradient would be inf * 0 = NaN)
    li = torch.where(mask[None, None, :, :, None], li,
                     torch.full_like(li, NEG_INF))
    decay = torch.exp(li)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cc, bc) * decay
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # state contribution of chunk c: sum_j exp(a_tot - a_cum[j]) B_j x_j^T
    w = torch.exp(a_tot[:, :, None, :] - a_cum)              # (b,nc,Q,h)
    chunk_states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bc, xc)

    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    decay_chunk = torch.exp(a_tot)                           # (b,nc,h)
    prev_states = []
    for c in range(nc):             # emit the state BEFORE each chunk
        prev_states.append(state)
        state = state * decay_chunk[:, c, :, None, None] + chunk_states[:, c]
    prev = torch.stack(prev_states, dim=1)                   # (b,nc,h,p,n)

    y_off = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(a_cum), cc,
                         prev)
    y = (y_diag + y_off).reshape(bsz, s, h, p).to(x.dtype)
    return y, state
