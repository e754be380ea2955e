"""Multi-query paged attention for speculative-decode verify: the wrapper
around the hand-written Hopper kernel ``csrc/paged_verify.cu``.

Replaces the TPU kernel ``paged_verify_lanes`` in
``src/repro/kernels/paged_verify.py``.  Each lane carries k query
positions; query ``i`` attends the rows ``[0, lengths + i]``.  What bounds
it on an H100 is the bytes: a call reads each lane's K/V rows once (f32,
bf16 or fp8 e4m3 pages, each element read as f32 in the kernel) and
does ~4·k·groups flops per element read, so its floor is those bytes over
3.35 TB/s.  The kernel splits each lane's rows into fixed splits of 256
rows (grid ``(kv_head, lane, split)``) and merges the splits' partial
softmax states in a second launch, in a fixed order; the wrapper allocates
the f32 scratch between them.  The design notes are in the CUDA source.

One launch holds at most ``kMaxRows`` = 64 query rows (k * groups) per
(lane, KV head).  A call with more is launched over consecutive chunks of
``64 // groups`` queries, each with ``lengths`` advanced by the chunk's
offset: query i attends ``[0, lengths + i]``, so the chunks together are
the whole call (``query_chunk``).

For a CUDA tensor the wrapper launches the kernel or raises; it never
falls back.  For a tensor on the CPU, where no kernel exists, it runs the
plain version ``ref.paged_verify_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (KV_DTYPE_CODES,
                                                 check_cuda_operands, on_cpu)
from repro_torch.kernels.ref import paged_verify_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 64              # kMaxRows in the CUDA source: k * groups


def _lib():
    lib = _build.load("paged_verify")
    fn = lib.paged_verify_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paged_verify_splits.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.paged_verify_splits.restype = ctypes.c_int
    return lib


def paged_verify_lanes(q, k_pages, v_pages, tables, lengths, *,
                       window=None):
    """q: (n, k, nh, hd) roped queries whose K/V rows are already written;
    k/v_pages: (P, bs, nkv, hd); tables: (n, B) int32 physical block ids
    (every entry a valid block — pad with the garbage block); lengths: (n,)
    int32 rows committed BEFORE the round (query ``i`` attends through row
    ``lengths + i``).  Returns (n, k, nh, hd) in q's dtype.  On CUDA
    tensors each call is counted once in ``paged_verify_lanes.launches``;
    it is two CUDA launches (the split kernel and the merge) for each
    query chunk (``query_chunk``).  The number
    of splits follows from the table's width, never from ``lengths``, so
    the call does not sync the device."""
    if q.dim() != 4 or k_pages.dim() != 4 or tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("expected q (n, k, nh, hd), pages (P, bs, nkv, hd),"
                         " tables (n, B), lengths (n,)")
    n, kk, nh, hd = q.shape
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
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "tables": tables, "lengths": lengths}
    if on_cpu(named):
        return paged_verify_ref(q, k_pages, v_pages, tables, lengths,
                                window=window)
    check_cuda_operands("paged_verify_lanes", named)
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in KV_DTYPE_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_verify_lanes: q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}; the kernel takes "
                        "float32 or bfloat16 q over float32, bfloat16 or "
                        "float8_e4m3fn pages")
    groups = nh // nkv
    item = k_pages.element_size()
    vec = 16 // item                          # elements per 16-B load
    dpl = next(d for d in (1, 2, 4, 8, 16) if hd <= 32 * d)  # dims per lane
    if groups > _MAX_ROWS or hd > 256 or hd % vec or hd % dpl:
        raise ValueError(f"paged_verify_lanes: {groups} heads per KV head "
                         f"at head_dim {hd} is not what the kernel takes "
                         f"(groups <= {_MAX_ROWS}, head_dim <= 256 and a "
                         f"multiple of {max(vec, dpl)})")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_verify_lanes: {name} is not aligned to "
                             "16 bytes (the kernel's vector loads)")
    out = torch.empty_like(q)
    if n == 0:
        return out
    chunk = query_chunk(kk, groups)
    if chunk == kk:
        _launch(q, k_pages, v_pages, tables, lengths, out, window)
    else:
        # query i of the chunk at c0 is query c0 + i of the call: it
        # attends [0, lengths + c0 + i], so lengths advance by c0
        for c0 in range(0, kk, chunk):
            qc = q[:, c0:c0 + chunk].contiguous()
            oc = torch.empty_like(qc)
            _launch(qc, k_pages, v_pages, tables, lengths + c0, oc, window)
            out[:, c0:c0 + chunk] = oc
    paged_verify_lanes.launches += 1
    return out


paged_verify_lanes.launches = 0


def query_chunk(k: int, groups: int) -> int:
    """Queries per kernel launch: all k when k * groups rows fit the
    kernel's ``kMaxRows``, else the most that do (a call of k queries is
    then ``ceil(k / chunk)`` launches over consecutive query chunks)."""
    return k if k * groups <= _MAX_ROWS else max(_MAX_ROWS // groups, 1)


def _launch(q, k_pages, v_pages, tables, lengths, out, window):
    """One launch of the split kernel and its merge over all of q's
    queries (k * groups <= kMaxRows)."""
    n, kk, nh, hd = q.shape
    _, bs, nkv, _ = k_pages.shape
    rows = kk * (nh // nkv)
    lib = _lib()
    splits = lib.paged_verify_splits(tables.shape[1], bs)
    # per (lane, KV head, split, query row): (m, l), and acc over head_dim
    part_ml = torch.empty((n, nkv, splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((n, nkv, splits, rows, hd), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = lib.paged_verify_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(),
            n, kk, nh, nkv, hd, bs, tables.shape[1],
            0 if window is None else int(window),
            _DTYPE_CODES[q.dtype], KV_DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_verify kernel launch failed: CUDA error "
                           f"{err}")
