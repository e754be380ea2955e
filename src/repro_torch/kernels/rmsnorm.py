"""RMSNorm over the last axis of a (rows, d) matrix: the wrapper around the
hand-written Hopper kernel ``csrc/rmsnorm.cu``.

Replaces the TPU kernel ``rms_norm_2d`` in ``src/repro/kernels/rmsnorm.py``.
What bounds it on an H100 is the bytes: x read once and the output written
once (the scale is d values, read from cache).  The design notes are in
the CUDA source.

For a CUDA tensor the wrapper launches the kernel or raises; it never falls
back.  For tensors on the CPU, where no kernel exists, it runs the plain
version ``ref.rms_norm_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import on_cpu
from repro_torch.kernels.ref import rms_norm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = _build.load("rmsnorm").rms_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rms_norm_2d(x, w, *, eps: float = 1e-6):
    """x: (rows, d); w: (d,).  Returns ``x * rsqrt(mean(x^2) + eps) * w``
    computed in f32, in x's dtype.  On CUDA tensors each call is one
    kernel launch, counted in ``rms_norm_2d.launches``."""
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (rows, d) and w (d,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    named = {"x": x, "w": w}
    if on_cpu(named):
        return rms_norm_ref(x, w, eps=eps)
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"rms_norm_2d: tensors on {devices}; expected all "
                         "on one CUDA device (or all on the CPU for the "
                         "plain version)")
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm_2d: x {x.dtype}, w {w.dtype}; the kernel "
                        "takes float32 or bfloat16")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"rms_norm_2d: {name} is not contiguous")
    out = torch.empty_like(x)
    rows, d = x.shape
    if rows == 0 or d == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {err}")
    rms_norm_2d.launches += 1
    return out


rms_norm_2d.launches = 0
