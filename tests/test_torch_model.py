"""The port's dense decoder against the JAX package's, on bridged params.

``qwen3-0.6b`` smoke with ``dtype`` and ``kv_cache_dtype`` set to float32
on both sides; the JAX parameters cross over as numpy
(``params_from_numpy``).  Prefill logits (``decode_step`` over a
contiguous cache) and three ``paged_decode_step`` logits must agree within
2e-4, the tolerance of ``tests/test_kernel_oracles.py`` for matmul chains
(f32 products summed in another order by XLA and by PyTorch).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import api

MM_TOL = 2e-4


@pytest.fixture(scope="module")
def bridged():
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, device="cpu"), tree


def _close(out, exp, tol=MM_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def test_params_round_trip_through_numpy(bridged):
    *_, params, tree = bridged
    back = params_to_numpy(params)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)


def test_prefill_logits_match_jax(bridged):
    jcfg, jparams, cfg, params, _ = bridged
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jstate = japi.init_decode_state(jcfg, 2, 16)
    jlogits, jstate = japi.decode_step(jcfg, jparams, jstate,
                                       jnp.asarray(tokens))
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    with torch.no_grad():
        logits, state = api.decode_step(cfg, params, state,
                                        torch.from_numpy(tokens).long())
    assert logits.shape == (2, 12, cfg.vocab_size)
    _close(logits.numpy(), jlogits)
    assert state["kv"]["index"] == int(jstate["kv"]["index"]) == 12
    _close(state["kv"]["k"].numpy(), jstate["kv"]["k"])
    _close(state["kv"]["v"].numpy(), jstate["kv"]["v"])


def test_paged_decode_logits_match_jax(bridged):
    """Three decode steps through block tables, two live lanes plus one
    inactive lane on the garbage block; logits per step and the pages
    outside garbage block 0 agree."""
    jcfg, jparams, cfg, params, _ = bridged
    rng = np.random.default_rng(1)
    L, P, bs = cfg.n_layers, 12, 4
    shape = (L, P, bs, cfg.n_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape, np.float32) * 0.5
    vp = rng.standard_normal(shape, np.float32) * 0.5
    tables = np.zeros((3, 5), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :5] = [2, 5, 11, 4, 8]
    lengths = np.asarray([5, 11, 0], np.int32)
    jpages = {"k": jnp.asarray(kp), "v": jnp.asarray(vp)}
    pages = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())}
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (3, 1), dtype=np.int32)
        jlogits, jpages = japi.paged_decode_step(
            jcfg, jparams, jpages, jnp.asarray(tables), jnp.asarray(lengths),
            jnp.asarray(tokens), impl="jnp")
        with torch.no_grad():
            logits = api.paged_decode_step(
                cfg, params, pages, torch.from_numpy(tables),
                torch.from_numpy(lengths), torch.from_numpy(tokens).long(),
                impl="ref")
        assert logits.shape == (3, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        _close(logits.numpy(), jlogits)
        lengths[:2] += 1
    for name in ("k", "v"):
        _close(pages[name][:, 1:].numpy(), jpages[name][:, 1:])
