"""Paged attention for one decode token per lane: the wrapper around the
hand-written Hopper kernel ``csrc/paged_attention.cu``.

Replaces the TPU kernel ``paged_attention_lanes`` in
``src/repro/kernels/paged_attention.py``.  What bounds it on an H100 is
the bytes: a launch reads ``sum_lanes ceil(len/bs)·bs·nkv·hd·2·itemsize``
bytes of K/V pages and does a handful of flops per byte, so its floor is
those bytes over 3.35 TB/s; at full width and short contexts the launch
latency matters as much as the bytes.  The design notes are in the CUDA
source.

For a CUDA tensor the wrapper launches the kernel or raises; it never
falls back.  For a tensor on the CPU, where no kernel exists, it runs the
plain version ``ref.paged_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8                  # kWarps in the CUDA source
_MAX_GROUPS = 8             # kMaxGroups
_SMEM_LIMIT = 48 * 1024


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, tables, lengths, window):
    if q.dim() != 3 or k_pages.dim() != 4 or tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("expected q (n, nh, hd), pages (P, bs, nkv, hd), "
                         "tables (n, B), lengths (n,)")
    n, nh, hd = q.shape
    _, bs, nkv, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q's head_dim "
                         f"{hd}")
    if tables.shape[0] != n or lengths.shape[0] != n:
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not cover {n} lanes")
    if nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: expected None or >= 1")
    return n, nh, hd, bs, nkv


def paged_attention_lanes(q, k_pages, v_pages, tables, lengths, *,
                          window=None):
    """q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) int32
    physical block ids (every entry a valid block — pad with the garbage
    block); lengths: (n,) int32 valid rows per lane INCLUDING the current
    token, each >= 1.  Returns (n, nh, hd) in q's dtype.  On CUDA tensors
    each call is one kernel launch, counted in
    ``paged_attention_lanes.launches``."""
    n, nh, hd, bs, nkv = _check(q, k_pages, v_pages, tables, lengths, window)
    devices = {t.device for t in (q, k_pages, v_pages, tables, lengths)}
    if devices == {torch.device("cpu")}:
        return paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                                   window=window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"paged_attention_lanes: tensors on {devices}; "
                         "expected all on one CUDA device (or all on the "
                         "CPU for the plain version)")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in _DTYPE_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention_lanes: q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_lanes: {name} is not "
                             "contiguous")
    groups = nh // nkv
    smem = 4 * _WARPS * groups * (hd + 2)     # the warps' merge buffers
    dpl = next(d for d in (1, 2, 4, 8, 16) if hd <= 32 * d)  # dims per lane
    if hd > 256 or hd % dpl or groups > _MAX_GROUPS or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention_lanes: head_dim {hd} with "
                         f"{groups} query heads per KV head is not what the "
                         f"kernel takes (head_dim <= 256 and a multiple of "
                         f"{dpl}, groups <= {_MAX_GROUPS}, {_SMEM_LIMIT} B "
                         "of shared memory)")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % (dpl * t.element_size()):
            raise ValueError(f"paged_attention_lanes: {name} is not aligned "
                             f"to {dpl * t.element_size()} bytes (the "
                             "kernel's vector loads)")
    out = torch.empty_like(q)
    if n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 n, nh, nkv, hd, bs, tables.shape[1],
                 0 if window is None else int(window),
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pages.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention_lanes.launches += 1
    return out


paged_attention_lanes.launches = 0
