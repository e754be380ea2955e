"""Per-family sharding rules, FSDP + tensor parallel (port of
``repro.sharding.specs``), turned into DTensor placements.

Mesh axes: ``('data', 'model')`` on one pod, ``('pod', 'data', 'model')``
across pods (``launch/mesh.py``).  Batch shards over (pod, data); weights
take a ZeRO-3/FSDP-style layout — large matrices shard their *input* dim
over ('pod', 'data') and their *output* dim over 'model' — so the bytes
each device holds fall with the device count.  MoE expert banks shard the
expert axis over 'model' when the expert count divides it, else fall back
to (d, f) sharding.

Every rule is a *candidate list*; ``param_specs`` picks the first
candidate whose sharded dims divide evenly on the mesh.  The lists are
the JAX package's, unchanged.

A spec is the port's own ``P``: per tensor dim an axis name, a tuple of
names, or None.  ``to_placements`` turns it into one placement per mesh
dim — ``Shard(i)`` on every mesh dim that tensor dim ``i`` names,
``Replicate()`` on the rest — and ``distribute`` lays a tree out by
them.  A mesh is a ``DeviceMesh`` or anything with a ``shape`` dict and
``axis_names`` (the JAX package's tests mock one so).
"""

from __future__ import annotations

import inspect
from typing import Any, Sequence


class P(tuple):
    """A partition spec: one entry per tensor dim, each an axis name, a
    tuple of axis names (major to minor) or None (the dim is whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Placements(tuple):
    """One DTensor placement per mesh dim (a leaf of a placement tree)."""


_LEAVES = (P, Placements)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.shape))


def fsdp_axes(mesh) -> Any:
    """The axis (or axis tuple) used for FSDP weight sharding."""
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def batch_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def shard_index(mesh, axis) -> int:
    """This rank's shard index along an axis or a tuple of axes (major to
    minor) of a ``DeviceMesh``."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def spec_fits(mesh, spec: P, shape: Sequence[int]) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = _axis_size(mesh, axis)
        if n > 1 and dim % n != 0:
            return False
    return True


def pick_spec(mesh, candidates: Sequence[P], shape: Sequence[int]) -> P:
    for c in candidates:
        if spec_fits(mesh, c, shape):
            return c
    return P(*([None] * len(shape)))


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def leaves_with_path(tree, path=()):
    """``(path, leaf)`` pairs in tree order (dict keys, sequence
    indices); a ``P`` or a ``Placements`` is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, _LEAVES):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def _map_with_path(fn, tree, path=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, _LEAVES):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (a DTensor built
    from shards states its global ones)."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree, in tree order."""
    return [s for _, s in leaves_with_path(spec_tree)]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_candidates(key: str, ndim: int, mesh) -> list[P]:
    F = fsdp_axes(mesh)
    stacked = any(s in key for s in ("layers/", "encoder/", "decoder/"))

    def S(*spec):
        """Prepend the stacked layer axis (always replicated)."""
        return P(None, *spec) if stacked else P(*spec)

    # embeddings: vocab over model, features over fsdp
    if key.endswith("embed/table"):
        return [P("model", F), P(None, F), P("model", None), P(None, None)]
    if key.endswith("dec_pos"):
        return [P(None, F), P(None, None)]

    # MoE expert banks (L, E, d, f): expert-parallel first, FSDP fallback
    if key.endswith(("/w_gate", "/w_up")) and ndim == (4 if stacked else 3):
        return [S("model", F, None), S(None, F, "model"), S(None, F, None)]
    if key.endswith("/w_down") and ndim == (4 if stacked else 3):
        return [S("model", None, F), S(None, "model", F), S(None, None, F)]
    if key.endswith("/router"):
        return [S(F, None), S(None, None)]

    # projections: in-dim over fsdp, out-dim over model (ZeRO-3 + TP)
    if key.endswith(("/wq", "/wk", "/wv", "/w_gate", "/w_up", "/w_in",
                     "/in_proj", "/up_proj")):
        return [S(F, "model"), S(F, None), S(None, "model"), S(None, None)]
    if key.endswith(("/wo", "/w_down", "/w_out", "/out_proj", "/down_proj")):
        return [S("model", F), S(None, F), S("model", None), S(None, None)]
    if key.endswith(("/bq", "/bk", "/bv", "/b_in")):
        return [S("model"), S(None)]

    # xLSTM internals
    if key.endswith("/w_gates"):
        return [S(F, None), S(None, None)]
    if key.endswith("/r"):          # (h, p, 4p) block-recurrent
        return [S("model", None, None), S(None, "model", None),
                S(None, None, None)]

    # conv / gates / norms / scalars: replicate (tiny)
    return [P(*([None] * ndim))]


def param_specs(cfg, params_tree, mesh) -> Any:
    def one(path, leaf):
        shape = _shape(leaf)
        cands = _param_candidates(_path_key(path), len(shape), mesh)
        return pick_spec(mesh, cands, shape)
    return _map_with_path(one, params_tree)


# ---------------------------------------------------------------------------
# batch / optimizer / decode-state rules
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch_tree, mesh) -> Any:
    B = batch_axes(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        cands = [P(B, *([None] * (len(shape) - 1)))]
        return pick_spec(mesh, cands, shape)

    return _map_with_path(one, batch_tree)


def opt_state_specs(cfg, opt_state_tree, mesh) -> Any:
    def one(path, leaf):
        key = _path_key(path)
        shape = _shape(leaf)
        if key.endswith("step") or len(shape) == 0:
            return P()
        stripped = key.split("/", 1)[1] if "/" in key else key
        cands = _param_candidates(stripped, len(shape), mesh)
        return pick_spec(mesh, cands, shape)
    return _map_with_path(one, opt_state_tree)


def decode_state_specs(cfg, state_tree, mesh) -> Any:
    """KV caches: batch→data, kv-heads→model; when batch is unshardable
    (long_500k's batch=1) shard the *sequence* dim over data instead."""
    B = batch_axes(mesh)

    def one(path, leaf):
        key = _path_key(path)
        shape = _shape(leaf)
        nd = len(shape)
        if key.endswith("/index") or key.endswith("pos") or nd == 0:
            return P()
        if nd == 5:      # stacked kv cache (L, b, s, h, hd)
            # kv-heads over 'model' when they divide; else the cache
            # *sequence* over 'model' (context parallelism for decode);
            # long_500k (batch=1): seq takes every axis
            Bt = B if isinstance(B, tuple) else (B,)
            seq_all = Bt + ("model",)
            cands = [P(None, B, None, "model", None),
                     P(None, B, "model", None, None),
                     P(None, None, seq_all, None, None),
                     P(None, None, B, "model", None),
                     P(None, None, B, None, None),
                     P(None, B, None, None, None)]
            return pick_spec(mesh, cands, shape)
        if nd >= 3:      # per-layer recurrent states (L, b, h, ...)
            cands = [P(None, B, "model", *([None] * (nd - 3))),
                     P(None, B, *([None] * (nd - 2))),
                     P(None, None, "model", *([None] * (nd - 3))),
                     P(*([None] * nd))]
            return pick_spec(mesh, cands, shape)
        return P(*([None] * nd))

    return _map_with_path(one, state_tree)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def spec_placements(mesh, spec: P) -> Placements:
    """One placement per mesh dim: ``Shard(i)`` where tensor dim ``i``
    names the mesh dim (a tuple entry names several, major to minor,
    which must follow the mesh's own order), else ``Replicate()``.  A
    mesh dim of size 1 is ``Replicate()`` whatever the spec says: the
    same layout, and DTensor then never has to merge "sharded" dims in a
    reshape (which some of its versions refuse)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    owner: dict[str, int] = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, (tuple, list)) else (entry,)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {group} do not follow "
                             f"the mesh's order {names}")
        for a in group:
            owner[a] = i
    return Placements(Shard(owner[a]) if a in owner and sizes[a] > 1
                      else Replicate() for a in names)


def to_placements(mesh, spec_tree) -> Any:
    """A spec tree as a tree of ``Placements`` (the port's
    ``to_shardings``)."""
    return _map_with_path(lambda _, s: spec_placements(mesh, s), spec_tree)


def _distribute_leaf(mesh, leaf, spec):
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
        return leaf           # ints and 0-d tensors: the same on every rank
    placements = spec_placements(mesh, spec)
    if isinstance(leaf, DTensor):
        return leaf.redistribute(mesh, placements)
    if "src_data_rank" in inspect.signature(distribute_tensor).parameters:
        # every rank holds the same full tensor: keep its own shard,
        # no scatter from rank 0
        return distribute_tensor(leaf, mesh, placements, src_data_rank=None)
    return distribute_tensor(leaf, mesh, placements)


def distribute(mesh, tree, spec_tree) -> Any:
    """``tree`` laid out over ``mesh`` by ``spec_tree`` (as returned by
    ``param_specs``, ``opt_state_specs``, ``batch_specs`` or
    ``decode_state_specs``): every tensor of rank >= 1 becomes a DTensor
    placed by its spec.  Every rank passes the same full tensors (the
    same seed, the same batch) and keeps its own shard of each; a DTensor
    is redistributed.  Ints and 0-d tensors stay as they are: they are
    replicated by nature."""
    specs = iter(spec_leaves(spec_tree))
    return _map_with_path(lambda _, leaf: _distribute_leaf(
        mesh, leaf, next(specs)), tree)


def full_tensors(tree) -> Any:
    """``tree`` with every DTensor gathered to its full tensor (a
    collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    return _map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
