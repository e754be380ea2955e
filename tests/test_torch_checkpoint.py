"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's format.

* ``tests/test_substrates.py``'s two checkpoint cases on the port: a
  mixed tree (f32, bf16, an int32 scalar) round-trips with its values and
  dtypes, and ``latest_step`` picks the highest ``step_N``.
* Both directions between the packages, bit for bit with dtypes kept, on
  a qwen3-0.6b smoke parameter tree (f32 params; a bf16 copy of them) and
  its AdamW state: JAX saves and the port restores, the port saves and
  JAX restores — same manifest, same leaf keys.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import json

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.optim import OptimizerConfig, init_state
from repro_torch.tree import tree_leaves


def test_checkpoint_roundtrip(tmp_path):
    tree = {"layers": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.ones((3,), dtype=torch.bfloat16)},
            "step_count": torch.tensor(7, dtype=torch.int32)}
    d = ckpt.save(str(tmp_path / "step_5"), tree, step=5,
                  metadata={"note": "test"})
    restored, manifest = ckpt.restore(d, like=tree)
    assert manifest["step"] == 5 and manifest["metadata"] == {"note": "test"}
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    flat, _ = ckpt.restore(d)
    assert set(flat) == {"layers/b", "layers/w", "step_count"}
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.restore(d, like={**tree, "extra": torch.zeros(1)})


def test_checkpoint_latest_step(tmp_path):
    for s in (10, 5, 20):
        ckpt.save(str(tmp_path / f"step_{s}"), {"x": torch.zeros(1)}, step=s)
    assert ckpt.latest_step(str(tmp_path)).endswith("step_20")
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def _state_tree():
    """qwen3-0.6b smoke params (f32), their bf16 copy and AdamW state."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_state(OptimizerConfig(kind="adamw"), params)
    g = torch.Generator().manual_seed(1)
    for leaf in tree_leaves(opt["mu"]) + tree_leaves(opt["nu"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    return {"params": params, "bf16": api.prepare_params(cfg, params, "cpu"),
            "opt": opt}


def _jax_tree(tree):
    """The same tree as JAX arrays (bf16 leaves through f32, exact)."""
    import jax
    import jax.numpy as jnp

    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(conv, tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _bits(t):
    """A tensor's or array's raw bits and dtype name."""
    if isinstance(t, torch.Tensor):
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages_bit_for_bit(writer, tmp_path):
    import jax
    from repro import checkpoint as jckpt
    tree = _state_tree()
    jtree = _jax_tree(tree)
    d = str(tmp_path / "step_3")
    if writer == "jax":
        jckpt.save(d, jtree, step=3, metadata={"arch": "qwen3-0.6b"})
        got, manifest = ckpt.restore(d, like=tree)
        pairs = zip(_flatten_with_paths(got).values(),
                    jax.tree.leaves(jtree))
    else:
        ckpt.save(d, tree, step=3, metadata={"arch": "qwen3-0.6b"})
        got, manifest = jckpt.restore(d, like=jtree)
        # both sides in jax.tree_util's order (dict keys sorted)
        pairs = zip(jax.tree.leaves(got), _flatten_with_paths(tree).values())
    assert manifest["step"] == 3 and manifest["metadata"]["arch"] == \
        "qwen3-0.6b"
    n = 0
    for a, b in pairs:
        (ab, an), (bb, bn) = _bits(a), _bits(b)
        assert an == bn
        np.testing.assert_array_equal(ab, bb)
        n += 1
    assert n == len(tree_leaves(tree)) > 10
    # either writer produces the other's manifest, key for key
    other = str(tmp_path / "other")
    if writer == "jax":
        ckpt.save(other, tree, step=3, metadata={"arch": "qwen3-0.6b"})
    else:
        jckpt.save(other, jtree, step=3, metadata={"arch": "qwen3-0.6b"})
    with open(f"{d}/manifest.json") as f, \
            open(f"{other}/manifest.json") as g:
        assert json.load(f) == json.load(g)
