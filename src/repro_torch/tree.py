"""Nested-container helpers: what ``jax.tree`` gives the JAX package.

A tree is a dict, tuple or list of trees, a ``None`` (an empty subtree,
as in JAX) or a leaf (a tensor, an array or a number).  Dicts keep their
key order, so two trees built the same way flatten the same way.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure; ``None`` subtrees stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order (``None`` subtrees have none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
