"""Public kernel entry points (port of ``repro.kernels.ops``).

``impl`` names the implementation: ``"cuda"`` is the hand-written Hopper
kernel, ``"ref"`` the plain PyTorch version.  The default follows the
tensors' device, as the JAX package's default follows its backend: the
kernel for a CUDA device, the plain version on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                 refuse_grad)
from repro_torch.kernels.fused_decode import \
    fused_decode_layer as _fused_layer
from repro_torch.kernels.paged_attention import (paged_attention_lanes,
                                                 paged_attention_quant_lanes)
from repro_torch.kernels.paged_verify import paged_verify_lanes
from repro_torch.kernels.rmsnorm import rms_norm_2d
from repro_torch.kernels.swiglu import swiglu_2d

IMPLS = ("cuda", "ref")


def default_paged_impl(device) -> str:
    """Engine-facing policy: the CUDA kernel on a CUDA device, the plain
    version on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    impl=None):
    """Flash attention in the layer layout: q (b, sq, nh, hd), k/v (b, sk,
    nkv, hd) -> (b, sq, nh, hd).  The kernel reads these through
    transposed views (strides), so no transposed copy is made.  Forward
    only, on every device and with either ``impl``: inputs that need a
    gradient raise, as the JAX package cannot differentiate the TPU
    kernel.  ``impl``: 'cuda' | 'ref' | None (by device)."""
    refuse_grad(q, k, v)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _impl("flash_attention", impl, q) == "ref":
        out = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                      window=window)
    else:
        out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, tables, lengths, *, window=None,
                    impl=None):
    """Single-token attention through a block table.

    q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) int32
    physical block ids (pad unused entries with a valid block — they are
    masked); lengths: (n,) int32 valid rows per lane including the current
    token.  ``impl``: 'cuda' | 'ref' | None (by device).  'cuda' on CPU
    tensors raises: there is no kernel to run there.
    """
    if _impl("paged_attention", impl, q) == "ref":
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                                       window=window)
    return paged_attention_lanes(q, k_pages, v_pages, tables, lengths,
                                 window=window)


def paged_verify(q, k_pages, v_pages, tables, lengths, *, window=None,
                 impl=None):
    """Multi-query (speculative verify) attention through a block table.

    q: (n, k, nh, hd) — all k draft positions per lane, their K/V rows
    already written; tables as ``paged_attention``; lengths: (n,) rows
    committed BEFORE the round (query ``i`` attends through logical row
    ``lengths + i``).  ``impl``: 'cuda' | 'ref' | None (by device)."""
    if _impl("paged_verify", impl, q) == "ref":
        return ref.paged_verify_ref(q, k_pages, v_pages, tables, lengths,
                                    window=window)
    return paged_verify_lanes(q, k_pages, v_pages, tables, lengths,
                              window=window)


def paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, *, window=None, impl=None):
    """int8-KV single-token attention: pages are int8 with per-row f32
    scales (the ``ref.quantize_kv`` layout), dequantized inside the kernel
    (or on the gathered rows by the plain version).  Otherwise as
    ``paged_attention``."""
    if _impl("paged_attention_quant", impl, q) == "ref":
        return ref.paged_attention_quant_ref(
            q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
            window=window)
    return paged_attention_quant_lanes(q, k_pages, v_pages, k_scales,
                                       v_scales, tables, lengths,
                                       window=window)


def fused_decode_layer(h, q, k_pages, v_pages, tables, lengths, wo,
                       mlp_scale, w_gate, w_up, w_down, *, window=None,
                       eps: float = 1e-6, impl=None):
    """Fused paged decode layer: attention through the block table, the
    wo projection and residual, RMSNorm, SwiGLU and the second residual
    (``fused_decode.fused_decode_layer``; shapes there).  ``impl``:
    'cuda' | 'ref' | None (by device)."""
    args = (h, q, k_pages, v_pages, tables, lengths, wo, mlp_scale, w_gate,
            w_up, w_down)
    if _impl("fused_decode_layer", impl, q) == "ref":
        return ref.fused_decode_layer_ref(*args, window=window, eps=eps)
    return _fused_layer(*args, window=window, eps=eps)


def rms_norm(x, w, *, eps: float = 1e-6, impl=None):
    """RMSNorm over the last axis of x (any leading shape); w: (d,).
    ``impl``: 'cuda' | 'ref' | None (by device)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _impl("rms_norm", impl, x) == "ref":
        y = ref.rms_norm_ref(x2, w, eps=eps)
    else:
        y = rms_norm_2d(x2.contiguous(), w.contiguous(), eps=eps)
    return y.reshape(shape)


def swiglu(x, w_gate, w_up, w_down, *, impl=None):
    """SwiGLU MLP over the last axis of x (any leading shape); w_gate/w_up:
    (d, f); w_down: (f, d), of x's dtype.  ``impl``: 'cuda' | 'ref' | None
    (by device)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _impl("swiglu", impl, x) == "ref":
        y = ref.swiglu_ref(x2, w_gate, w_up, w_down)
    else:
        y = swiglu_2d(x2.contiguous(), w_gate.contiguous(),
                      w_up.contiguous(), w_down.contiguous())
    return y.reshape(*shape[:-1], w_down.shape[-1])


def _impl(op: str, impl, q) -> str:
    """Resolve ``impl`` for ``op`` on ``q``'s device; 'cuda' on CPU
    tensors raises: there is no kernel to run there."""
    impl = impl or default_paged_impl(q.device)
    if impl not in IMPLS:
        raise ValueError(f"{op} impl={impl!r}: expected one of {IMPLS}")
    if impl == "cuda" and q.device.type != "cuda":
        raise ValueError(f"{op} impl='cuda' needs CUDA tensors; got "
                         f"{q.device} (use impl='ref' on the CPU)")
    return impl
