"""GQA flash attention (causal / sliding window, f32 online softmax): the
wrapper around the hand-written Hopper kernel ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_bhsd`` in
``src/repro/kernels/flash_attention.py``.  What bounds it on an H100, at
the shapes the eval path gives it, is the flops of q.k and p.v over the
visible (query, key) pairs; the design notes are in the CUDA source.

The kernel is forward-only, as the TPU kernel is: the JAX package has no
gradient through ``flash_attention_bhsd`` (``jax.grad`` through its
``pallas_call`` raises), so this wrapper refuses inputs that need one, on
every device, and training runs the default ``attn_impl``.

For a CUDA tensor the wrapper launches the kernel or raises; it never
falls back.  For a tensor on the CPU, where no kernel exists, it runs the
plain version ``ref.flash_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import on_cpu
from repro_torch.kernels.ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def refuse_grad(*tensors, name: str = "flash_attention_bhsd") -> None:
    """Raise when autograd would need a gradient through kernel ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        advice = ("train with the default attn_impl='xla'"
                  if name == "flash_attention_bhsd" else
                  "train with the default use_kernel=False")
        raise RuntimeError(
            f"{name} has no gradient: the JAX package cannot differentiate "
            "it either (jax.grad through its pallas_call raises), so it "
            f"runs only on forward-only paths; {advice}, or call it under "
            "torch.no_grad()")


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window=None):
    """q: (b, nh, sq, hd); k/v: (b, nkv, sk, hd), any strides with a
    contiguous head_dim axis (the layer layout's transposed views need no
    copy).  Returns (b, nh, sq, hd) in q's dtype, laid out in memory as
    (b, sq, nh, hd), so the transpose back to the layer layout is free.
    On CUDA tensors each call is one kernel launch, counted in
    ``flash_attention_bhsd.launches``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, nh, sq, hd), k/v (b, nkv, sk, hd)")
    b, nh, sq, hd = q.shape
    _, nkv, sk, hd_k = k.shape
    if v.shape != k.shape or hd_k != hd or k.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if nh % nkv:
        raise ValueError(f"n_heads {nh} not a multiple of n_kv_heads {nkv}")
    if window is not None and window < 1:
        raise ValueError(f"window={window}: expected None or >= 1")
    refuse_grad(q, k, v)
    named = {"q": q, "k": k, "v": v}
    if on_cpu(named):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: tensors on {devices}; "
                         "expected all on one CUDA device (or all on the "
                         "CPU for the plain version)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bhsd: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}; the kernel takes one dtype, float32 "
                        "or bfloat16")
    item = q.element_size()
    vec = 16 // item
    dpl = next(d for d in (1, 2, 4, 8, 16) if hd <= 32 * d)  # dims per lane
    if hd > 256 or hd % vec or hd % dpl:
        raise ValueError(f"flash_attention_bhsd: head_dim {hd} is not what "
                         f"the kernel takes (<= 256, a multiple of "
                         f"{max(vec, dpl)})")
    for name, t in named.items():
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_bhsd: {name} needs a "
                             "contiguous head_dim axis, 16-byte alignment "
                             f"and strides that are multiples of {vec} "
                             "elements (the kernel's vector loads)")
    out = torch.empty((b, sq, nh, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("flash_attention_bhsd: no keys (sk == 0)")
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, sq, sk, nh, nkv, hd, int(causal),
                 0 if window is None else int(window), _DTYPE_CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
