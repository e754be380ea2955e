"""The fused paged decode layer: the wrapper around the hand-written
Hopper kernel ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``fused_decode_layer`` in
``src/repro/kernels/fused_decode.py``: paged attention over all of a
lane's heads, the ``wo`` projection and residual, RMSNorm, SwiGLU and the
second residual, in f32, cast once to h's dtype.  What bounds it on an
H100 is the bytes: the layer's four weight matrices (23 MB in bf16 at
qwen3-0.6b's widths), read once for all lanes, plus the K/V rows the lanes
attend to (f32, bf16 or fp8 e4m3 pages, read as f32 in the kernel).  One
call is a fixed chain of 8 kernel launches issued by one C call: the
split-KV decode attention and its merge (the kernels of
``paged_attention_lanes``), then the products and row passes as
programmatic dependent launches, the products streaming their weights
through a ring (bf16 on the tensor cores, with each activation split into
two bf16 parts; f32 on the CUDA cores).  The design notes are in the CUDA
sources.

For CUDA tensors the wrapper launches the kernel chain or raises; it never
falls back.  For tensors on the CPU, where no kernel exists, it runs the
plain version ``ref.fused_decode_layer_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (KV_DTYPE_CODES, _check,
                                                 _check_split_shape,
                                                 check_cuda_operands, on_cpu)
from repro_torch.kernels.ref import fused_decode_layer_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("fused_decode")
    fn = lib.fused_decode_layer_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.fused_decode_workspace_floats
        ws.argtypes = [ctypes.c_int] * 8
        ws.restype = ctypes.c_longlong
    return lib


def fused_decode_layer(h, q, k_pages, v_pages, tables, lengths, wo,
                       mlp_scale, w_gate, w_up, w_down, *, window=None,
                       eps: float = 1e-6):
    """h: (n, d) residual stream; q: (n, nh, hd) roped queries whose K/V
    rows are already written; k/v_pages: (P, bs, nkv, hd); tables: (n, B)
    int32 physical block ids (pad with the garbage block); lengths: (n,)
    int32 valid rows per lane INCLUDING the current token, each >= 1; wo:
    (nh*hd, d); mlp_scale: (d,); w_gate/w_up: (d, f); w_down: (f, d).  h,
    q, the weights and the scale share one dtype (the caller casts them).
    Returns the next (n, d) residual in h's dtype.  On CUDA tensors each
    call is one kernel chain (8 CUDA launches), counted once in
    ``fused_decode_layer.launches``."""
    n, nh, hd, bs, nkv = _check(q, k_pages, v_pages, tables, lengths,
                                window)
    if h.dim() != 2 or h.shape[0] != n:
        raise ValueError(f"h {tuple(h.shape)}: expected ({n}, d)")
    d = h.shape[1]
    f = w_gate.shape[-1]
    shapes = {"wo": (wo, (nh * hd, d)), "mlp_scale": (mlp_scale, (d,)),
              "w_gate": (w_gate, (d, f)), "w_up": (w_up, (d, f)),
              "w_down": (w_down, (f, d))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"fused_decode_layer: {name} {tuple(t.shape)}; "
                             f"expected {want}")
    named = {"h": h, "q": q, "k_pages": k_pages, "v_pages": v_pages,
             "tables": tables, "lengths": lengths,
             **{name: t for name, (t, _) in shapes.items()}}
    if on_cpu(named):
        return fused_decode_layer_ref(h, q, k_pages, v_pages, tables,
                                      lengths, wo, mlp_scale, w_gate, w_up,
                                      w_down, window=window, eps=eps)
    check_cuda_operands("fused_decode_layer", named)
    act = {t.dtype for t in (h, q, wo, mlp_scale, w_gate, w_up, w_down)}
    if len(act) != 1 or h.dtype not in _DTYPE_CODES \
            or k_pages.dtype not in KV_DTYPE_CODES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"fused_decode_layer: h/q/weights "
                        f"{sorted(map(str, act))}, pages {k_pages.dtype}/"
                        f"{v_pages.dtype}; the kernel "
                        "takes one float32 or bfloat16 dtype for h, q, the "
                        "weights and the scale, and float32, bfloat16 or "
                        "float8_e4m3fn pages")
    _check_split_shape("fused_decode_layer", nh, nkv, hd, k_pages, v_pages)
    if (nh * hd) % 4 or d % 8 or f % 8:
        raise ValueError(f"fused_decode_layer: nh*hd {nh * hd}, d {d}, f {f}"
                         "; the kernel takes nh*hd % 4 == 0 and d, f "
                         "multiples of 8 (its vector loads)")
    for name, t in named.items():
        if name not in ("tables", "lengths") and t.data_ptr() % 16:
            raise ValueError(f"fused_decode_layer: {name} is not 16-byte "
                             "aligned (the kernel's vector loads)")
    out = torch.empty_like(h)
    if n == 0:
        return out
    lib = _lib()
    ws = torch.empty(lib.fused_decode_workspace_floats(
        n, nh, nkv, hd, bs, tables.shape[1], d, f), dtype=torch.float32,
        device=h.device)
    with torch.cuda.device(h.device):
        err = lib.fused_decode_layer_fwd(
            h.data_ptr(), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            wo.data_ptr(), mlp_scale.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), out.data_ptr(),
            ws.data_ptr(), n, nh, nkv, hd, bs, tables.shape[1], d, f,
            0 if window is None else int(window), float(eps),
            _DTYPE_CODES[h.dtype], KV_DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_layer kernel launch failed: CUDA "
                           f"error {err}")
    fused_decode_layer.launches += 1
    return out


fused_decode_layer.launches = 0
