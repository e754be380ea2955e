"""Parameter bridge between numpy trees and the port's tensor trees.

Parameters keep the JAX package's layout (nested dicts, stacked layers on
axis 0, weights ``(in, out)``), so crossing over is a leaf-by-leaf
conversion for every family: the dense, vlm and MoE layers, the xLSTM
groups (the sLSTM recurrent ``r`` of ``(G, h, p, 4p)`` included), the
zamba2 Mamba2 stack with its unstacked ``shared_attn`` subtree, and the
encoder-decoder's stacked ``encoder`` / ``decoder`` trees with the
learned ``dec_pos`` table.  A caller holding JAX parameters passes
``jax.tree.map(np.asarray, params)``: the port itself never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype


# the JAX config's attn_impl spellings -> the port's (configs/base.py):
# XLA attention is the plain path, either Pallas mode the flash kernel
_ATTN_IMPLS = {"xla": "xla", "pallas": "cuda", "pallas_interpret": "cuda"}


def attn_impl_from_jax(name: str) -> str:
    """The port's ``attn_impl`` for a JAX ``ArchConfig.attn_impl``."""
    if name not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl={name!r}: the JAX package knows "
                         f"{sorted(_ATTN_IMPLS)}")
    return _ATTN_IMPLS[name]


# the JAX ServeJob.verify_impl spellings -> the port's spec-backend impls:
# the Pallas kernel is the CUDA kernel, the jnp gather path the plain one
_VERIFY_IMPLS = {"pallas": "cuda", "jnp": "ref"}


def verify_impl_from_jax(name):
    """The port's ``verify_impl`` for a JAX ``ServeJob.verify_impl``
    (None stays None: verify follows the decode impl).  The Pallas
    interpreter mode has no counterpart in the port and raises."""
    if name is None:
        return None
    if name not in _VERIFY_IMPLS:
        raise ValueError(
            f"verify_impl={name!r}: the port verifies through 'cuda' (the "
            "kernel, on a card) or 'ref' (the plain version); of the JAX "
            f"spellings it maps {sorted(_VERIFY_IMPLS)}, and the Pallas "
            "interpreter mode has no counterpart")
    return _VERIFY_IMPLS[name]


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(tree, *, device="cuda", dtype=None):
    """numpy tree -> tensor tree on ``device``.  ``dtype`` (a name such as
    ``"float32"``) casts every leaf; None keeps each leaf's own dtype.
    numpy has no bfloat16, so bf16 arrays (``ml_dtypes``) are read through
    float32, which holds them exactly."""
    device = resolve_device(device)
    want = torch_dtype(dtype) if dtype is not None else None

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))    # an owned, writable copy
        if want is not None:
            t = t.to(want)
        return t.to(device)

    return _map(tree, conv)


def params_to_numpy(tree):
    """tensor tree -> numpy tree on the host (bf16 leaves as float32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(tree, conv)
