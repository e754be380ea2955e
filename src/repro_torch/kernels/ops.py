"""Public kernel entry points (port of ``repro.kernels.ops``).

``impl`` names the implementation: ``"cuda"`` is the hand-written Hopper
kernel, ``"ref"`` the plain PyTorch version.  The default follows the
tensors' device, as the JAX package's default follows its backend: the
kernel for a CUDA device, the plain version on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention_lanes

IMPLS = ("cuda", "ref")


def default_paged_impl(device) -> str:
    """Engine-facing policy: the CUDA kernel on a CUDA device, the plain
    version on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def paged_attention(q, k_pages, v_pages, tables, lengths, *, window=None,
                    impl=None):
    """Single-token attention through a block table.

    q: (n, nh, hd); k/v_pages: (P, bs, nkv, hd); tables: (n, B) int32
    physical block ids (pad unused entries with a valid block — they are
    masked); lengths: (n,) int32 valid rows per lane including the current
    token.  ``impl``: 'cuda' | 'ref' | None (by device).  'cuda' on CPU
    tensors raises: there is no kernel to run there.
    """
    impl = impl or default_paged_impl(q.device)
    if impl == "ref":
        return ref.paged_attention_ref(q, k_pages, v_pages, tables, lengths,
                                       window=window)
    if impl != "cuda":
        raise ValueError(f"paged_attention impl={impl!r}: expected one of "
                         f"{IMPLS}")
    if q.device.type != "cuda":
        raise ValueError("paged_attention impl='cuda' needs CUDA tensors; "
                         f"got {q.device} (use impl='ref' on the CPU)")
    return paged_attention_lanes(q, k_pages, v_pages, tables, lengths,
                                 window=window)
