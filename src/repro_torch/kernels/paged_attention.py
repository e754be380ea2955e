"""Paged attention for one decode token per lane: the wrappers around the
hand-written Hopper kernels of ``csrc/paged_attention.cu``, over fp pages
(``paged_attention_lanes``: f32, bf16 or fp8 e4m3, each element read as
f32 in the kernel) and over int8 pages with per-row scales
(``paged_attention_quant_lanes``).

Replace the TPU kernels ``paged_attention_lanes`` and
``paged_attention_quant_lanes`` in ``src/repro/kernels/paged_attention.py``.
What bounds them on an H100 is the bytes: a call reads each lane's
attended K/V rows once (``hd·itemsize`` bytes a row and KV head — one
byte an element for fp8 pages —, or
``hd + 4`` for an int8 row and its scale, for K and for V) and does a
handful of flops per byte, so its floor is those bytes over 3.35 TB/s.

Both run one split-KV design: each lane's logical rows are cut into fixed
splits of ``SPLIT_ROWS`` = 128 (grid ``(kv_head, lane, split)``), each
split writes a partial softmax state per query head, and a second launch
merges the splits in a fixed order, so a call repeats bit for bit.  The
number of splits follows from the table's width, never from ``lengths``,
so a call does not sync the device.  The wrapper allocates the f32
scratch between the two launches: per (lane, KV head, split, query head)
an (m, l) pair and an ``hd``-wide accumulator, ``n·nh·splits·(hd + 2)``
floats in one buffer.  The design notes are in the CUDA source.

For a CUDA tensor a wrapper launches the kernel or raises; it never falls
back.  For a tensor on the CPU, where no kernel exists, it runs the plain
version (``ref.paged_attention_ref`` / ``ref.paged_attention_quant_ref``).

The fused decode layer (``fused_decode.py``) runs the same split kernel and
merge for its attention phase, and takes the same shape check.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (paged_attention_quant_ref,
                                     paged_attention_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# pages also take fp8 e4m3 (the fp8 KV cache), read as f32 in the kernel
KV_DTYPE_CODES = {**_DTYPE_CODES, torch.float8_e4m3fn: 2}
_MAX_GROUPS = 16            # kMaxGroups in csrc/paged_decode.cuh
SPLIT_ROWS = 128            # kSplit


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention_fwd.argtypes is None:
        lib.paged_attention_fwd.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.paged_attention_fwd.restype = ctypes.c_int
        lib.paged_attention_quant_fwd.argtypes = [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.paged_attention_quant_fwd.restype = ctypes.c_int
        lib.paged_attention_splits.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.paged_attention_splits.restype = ctypes.c_int
    return lib


def n_splits(n_table: int, bs: int) -> int:
    """Splits of a call whose tables are ``n_table`` blocks of ``bs`` rows:
    ``ceil(n_table * bs / SPLIT_ROWS)``, at least one (asks the built
    library, so it needs ``nvcc`` or a build)."""
    return _lib().paged_attention_splits(n_table, bs)


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


def on_cpu(named: dict) -> bool:
    """True when every operand lies on the CPU: the one case a kernel
    wrapper runs its plain version."""
    return {t.device for t in named.values()} == {torch.device("cpu")}


def check_cuda_operands(kernel: str, named: dict) -> None:
    """Raise unless every operand lies on one CUDA device, is contiguous,
    and the tables / lengths are int32."""
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: tensors on {devices}; expected all on "
                         "one CUDA device (or all on the CPU for the plain "
                         "version)")
    if named["tables"].dtype != torch.int32 \
            or named["lengths"].dtype != torch.int32:
        raise TypeError(f"{kernel}: tables and lengths must be int32")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def _check_split_shape(kernel, nh, nkv, hd, k_pages, v_pages) -> None:
    """Raise unless the split-KV kernel takes this shape: groups <= 16,
    head_dim <= 256, each page row a whole number of 16-byte copies, the
    lanes' head dims in p.v whole vectors, pages 16-byte aligned."""
    groups = nh // nkv
    vec = 16 // k_pages.element_size()        # elements per 16-byte copy
    dpl = next(d for d in (1, 2, 4, 8, 16) if hd <= 32 * d)  # dims per lane
    if hd > 256 or hd % vec or hd % dpl or groups > _MAX_GROUPS:
        raise ValueError(f"{kernel}: head_dim {hd} with {groups} query "
                         f"heads per KV head is not what the kernel takes "
                         f"(head_dim <= 256 and a multiple of "
                         f"{max(vec, dpl)}: a page row of "
                         f"{k_pages.dtype} must be whole 16-byte "
                         f"asynchronous copies; groups <= {_MAX_GROUPS})")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not aligned to 16 bytes "
                             "(the kernel's asynchronous copies)")


def _scratch(n, nh, hd, splits, device):
    """The f32 partials of a call, in one buffer: (m, l) pairs for every
    (lane, KV head, split, query head), then their hd-wide accumulators."""
    rows = n * nh * splits
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
    return part[:2 * rows], part[2 * rows:]


def paged_attention_lanes(q, k_pages, v_pages, tables, lengths, *,
                          window=None):
    """q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) int32
    physical block ids (every entry a valid block — pad with the garbage
    block); lengths: (n,) int32 valid rows per lane INCLUDING the current
    token, each >= 1.  Returns (n, nh, hd) in q's dtype.  On CUDA tensors
    each call is counted once in ``paged_attention_lanes.launches``; it is
    two CUDA launches (the split kernel and the merge)."""
    n, nh, hd, bs, nkv = _check(q, k_pages, v_pages, tables, lengths, window)
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "tables": tables, "lengths": lengths}
    if on_cpu(named):
        return paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                                   window=window)
    check_cuda_operands("paged_attention_lanes", named)
    if q.dtype not in _DTYPE_CODES or k_pages.dtype not in KV_DTYPE_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention_lanes: q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}; the kernel takes "
                        "float32 or bfloat16 q over float32, bfloat16 or "
                        "float8_e4m3fn pages")
    _check_split_shape("paged_attention_lanes", nh, nkv, hd, k_pages,
                       v_pages)
    out = torch.empty_like(q)
    if n == 0:
        return out
    lib = _lib()
    part_ml, part_acc = _scratch(n, nh, hd, n_splits(tables.shape[1], bs),
                                 q.device)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(),
            n, nh, nkv, hd, bs, tables.shape[1],
            0 if window is None else int(window),
            _DTYPE_CODES[q.dtype], KV_DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention_lanes.launches += 1
    return out


paged_attention_lanes.launches = 0


def paged_attention_quant_lanes(q, k_pages, v_pages, k_scales, v_scales,
                                tables, lengths, *, window=None):
    """int8-KV twin of ``paged_attention_lanes``: k/v_pages are (P, bs,
    nkv, hd) int8 and k/v_scales (P, bs, nkv) float32 per-row scales
    (``ref.quantize_kv``), dequantized in registers inside the kernel.
    Returns (n, nh, hd) in q's dtype.  On CUDA tensors each call is
    counted once in ``paged_attention_quant_lanes.launches``; it is two
    CUDA launches (the split kernel and the merge)."""
    n, nh, hd, bs, nkv = _check(q, k_pages, v_pages, tables, lengths, window)
    P = k_pages.shape[0]
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(t.shape) != (P, bs, nkv):
            raise ValueError(f"paged_attention_quant_lanes: {name} "
                             f"{tuple(t.shape)}; expected {(P, bs, nkv)}")
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "k_scales": k_scales, "v_scales": v_scales, "tables": tables,
             "lengths": lengths}
    if on_cpu(named):
        return paged_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                         v_scales, tables, lengths,
                                         window=window)
    check_cuda_operands("paged_attention_quant_lanes", named)
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8 \
            or k_scales.dtype != torch.float32 \
            or v_scales.dtype != torch.float32:
        raise TypeError(f"paged_attention_quant_lanes: q {q.dtype}, pages "
                        f"{k_pages.dtype}/{v_pages.dtype}, scales "
                        f"{k_scales.dtype}/{v_scales.dtype}; the kernel "
                        "takes float32 or bfloat16 q over int8 pages with "
                        "float32 scales")
    _check_split_shape("paged_attention_quant_lanes", nh, nkv, hd, k_pages,
                       v_pages)
    out = torch.empty_like(q)
    if n == 0:
        return out
    lib = _lib()
    part_ml, part_acc = _scratch(n, nh, hd, n_splits(tables.shape[1], bs),
                                 q.device)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_quant_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(),
            n, nh, nkv, hd, bs, tables.shape[1],
            0 if window is None else int(window),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_quant kernel launch failed: "
                           f"CUDA error {err}")
    paged_attention_quant_lanes.launches += 1
    return out


paged_attention_quant_lanes.launches = 0
