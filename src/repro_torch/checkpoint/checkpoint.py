"""Checkpoints in the JAX package's format (port of
``repro.checkpoint.checkpoint``), so that a checkpoint written by either
package restores in the other.

Format: one directory per step containing
  * ``manifest.json`` — ``step``, ``metadata`` and ``leaves``: each
    leaf's shape and dtype, keyed by its tree path
  * ``arrays.npz``    — the leaves keyed by tree path (dict keys and
    sequence indices joined by ``/``; dict keys in sorted order, as
    ``jax.tree_util`` flattens them)

bfloat16 has no numpy dtype here (the JAX package stores ``ml_dtypes``
arrays), so a bf16 leaf is stored as its ``uint16`` bits with dtype
``"bfloat16"`` in the manifest, as the JAX package does; the bits cross
through ``int16`` views on both sides, so no ``ml_dtypes`` is needed.
Leaves may be tensors on any device, numpy arrays or numbers; ``restore``
returns CPU tensors, so the caller decides placement.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree, path=()) -> dict[str, Any]:
    """``{"/"-joined path: leaf}`` in ``jax.tree_util``'s order: dict keys
    sorted, tuples and lists by index, ``None`` an empty subtree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten_with_paths(tree[k], path + (k,)))
        return flat
    if isinstance(tree, (tuple, list)):
        flat = {}
        for i, v in enumerate(tree):
            flat.update(_flatten_with_paths(v, path + (i,)))
        return flat
    return {_key(path): tree}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array stored in ``arrays.npz`` and its manifest
    dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, tree, *, step: int = 0,
         metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _flatten_with_paths(tree).items():
        arr, dtype = _to_numpy(leaf)
        arrays[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(os.path.join(directory, "arrays.npz"), **arrays)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return directory


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, like=None) -> tuple[Any, dict]:
    """Returns (tree, manifest): CPU tensors in each leaf's stored dtype.
    If ``like`` is given, the leaves are placed in its tree structure
    (its leaves are not read); otherwise the flat ``{path: tensor}`` dict
    is returned."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        flat = {key: _to_tensor(z[key], meta["dtype"])
                for key, meta in manifest["leaves"].items()}
    if like is None:
        return flat, manifest
    missing = set(_flatten_with_paths(like)) - set(flat)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")

    def build(tree, path):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(build(v, path + (i,))
                              for i, v in enumerate(tree))
        return flat[_key(path)]

    return build(like, ()), manifest


def latest_step(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))
