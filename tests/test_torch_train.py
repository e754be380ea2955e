"""The port's forward, loss, optimizers, train step and data stream against
the JAX package's.

Parameters come from the JAX package's ``init_params`` and cross over as
numpy (``params_from_numpy``); data comes from the numpy-seeded
``SyntheticTokens`` of each package.  ``qwen3-0.6b`` and ``bert-large-1b``
smoke run with ``dtype=float32`` on both sides, so logits and losses
compare at 2e-4, the tolerance of ``tests/test_kernel_oracles.py`` for
matmul chains (f32 products summed in another order by XLA and PyTorch);
single optimizer updates at 2e-5 (f32 elementwise).

With the kernel ``attn_impl`` (the JAX package's ``pallas_interpret``,
the port's ``cuda``, which on CPU tensors runs the kernel's plain
version) a forward matches, and a gradient raises in both packages: the
JAX package cannot differentiate its Pallas kernel.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import FileTokens as JFileTokens
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.training import make_train_step as jmake_train_step
from repro.training.losses import softmax_xent as jsoftmax_xent
from repro_torch.checkpoint.convert import (attn_impl_from_jax,
                                            params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                       SyntheticTokens, as_tensors,
                                       make_dataset)
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.training.losses import softmax_xent
from repro_torch.training.train_loop import make_train_step

MM_TOL = 2e-4
F32_TOL = 2e-5


def _bridge(arch, seed=0, **kw):
    jcfg = jget_config(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32",
        **{k: attn_impl_from_jax(v) if k == "attn_impl" else v
           for k, v in kw.items()})
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(out, exp, tol=MM_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bert-large-1b"])
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_match_jax(arch, last_only):
    jcfg, jparams, cfg, params = _bridge(arch)
    batch = _batch(cfg)
    exp = japi.forward(jcfg, jparams, jax.tree.map(jnp.asarray, batch),
                       last_only=last_only)
    with torch.no_grad():
        out = api.forward(cfg, params, as_tensors(batch, "cpu"),
                          last_only=last_only)
    assert out.shape == exp.shape
    _close(out.numpy(), exp)


def test_kernel_attn_impl_forward_matches_pallas_interpret(monkeypatch):
    """The kernel config routes every layer's cache-free causal attention
    through ``ops.flash_attention``, as the JAX package routes it through
    the Pallas kernel; the logits agree."""
    jcfg, jparams, cfg, params = _bridge("qwen3-0.6b",
                                         attn_impl="pallas_interpret")
    assert cfg.attn_impl == "cuda"
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = _batch(cfg, s=40)
    exp = japi.forward(jcfg, jparams, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        out = api.forward(cfg, params, as_tensors(batch, "cpu"))
    assert len(calls) == cfg.n_layers
    _close(out.numpy(), exp)


def test_gradient_through_the_kernel_impl_raises_in_both_packages():
    jcfg, jparams, cfg, params = _bridge("qwen3-0.6b",
                                         attn_impl="pallas_interpret")
    batch = _batch(cfg, s=16)

    def jloss(p):
        logits = japi.forward(jcfg, p, jax.tree.map(jnp.asarray, batch))
        return jsoftmax_xent(logits, batch["labels"])

    with pytest.raises(Exception):
        jax.grad(jloss)(jparams)
    step = make_train_step(cfg, opt.OptimizerConfig(grad_clip=0.0))
    state = opt.init_state(opt.OptimizerConfig(), params)
    with pytest.raises(RuntimeError, match="no gradient"):
        step(params, state, as_tensors(batch, "cpu"))


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 17), np.float32) * 3
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        exp = jsoftmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m))
        out = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if m is None else torch.from_numpy(m))
        _close(out.numpy(), exp, F32_TOL)


OPT_CASES = [
    dict(kind="adamw", lr=0.1, b1=0.9, b2=0.99, weight_decay=0.0,
         grad_clip=0.0),
    dict(kind="adamw", lr=0.05, grad_clip=1.0, schedule="cosine",
         warmup_steps=2, total_steps=10),
    dict(kind="sgd", lr=0.5, momentum=0.5, weight_decay=0.01, grad_clip=0.0),
    dict(kind="lion", lr=0.1, weight_decay=0.01, grad_clip=0.5,
         schedule="linear_warmup_cosine", warmup_steps=1, total_steps=4),
]


@pytest.mark.parametrize("kw", OPT_CASES,
                         ids=[f"{c['kind']}-{i}" for i, c in
                              enumerate(OPT_CASES)])
def test_optimizer_updates_match_jax(kw):
    """Three updates of one numpy tree (nested, with a scalar leaf) in
    both packages: params and every state leaf agree."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 4), np.float32),
            "b": {"c": rng.standard_normal((3,), np.float32),
                  "d": np.float32(0.5) * np.ones((), np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(
        np.shape(x)).astype(np.float32), tree) for _ in range(3)]
    jcfg, cfg = jopt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    p = params_from_numpy(tree, device="cpu")
    js, s = jopt.init_state(jcfg, jp), opt.init_state(cfg, p)
    for g in grads:
        jp, js = jopt.update(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        p, s = opt.update(cfg, p, params_from_numpy(g, device="cpu"), s)
    for out, exp in ((p, jp), (s, js)):
        for o, e in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), out)), jax.tree.leaves(exp)):
            _close(o, e, F32_TOL)
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 3


@pytest.mark.parametrize("schedule", ["constant", "cosine",
                                      "linear_warmup_cosine"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=2.5, schedule=schedule, warmup_steps=10, total_steps=110,
              min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 60, 110, 500):
        exp = jopt.schedule_lr(jopt.OptimizerConfig(**kw), step)
        out = opt.schedule_lr(opt.OptimizerConfig(**kw), step)
        _close(out.numpy(), exp, F32_TOL)


@pytest.mark.parametrize("arch,accum", [("qwen3-0.6b", 1),
                                        ("bert-large-1b", 1),
                                        ("qwen3-0.6b", 2)])
def test_train_steps_match_jax(arch, accum):
    """Three AdamW steps (global-norm clip on) from the same params on the
    same ``SyntheticTokens`` stream: losses and grad norms agree."""
    jcfg, jparams, cfg, params = _bridge(arch)
    ocfg_kw = dict(kind="adamw", lr=1e-3, grad_clip=1.0)
    jocfg, ocfg = jopt.OptimizerConfig(**ocfg_kw), \
        opt.OptimizerConfig(**ocfg_kw)
    jstep = jax.jit(jmake_train_step(jcfg, jocfg, accum_steps=accum))
    step = make_train_step(cfg, ocfg, accum_steps=accum)
    js, s = jopt.init_state(jocfg, jparams), opt.init_state(ocfg, params)
    dcfg = dict(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size, seed=3)
    jit, it = iter(JSyntheticTokens(JDataConfig(**dcfg))), \
        iter(SyntheticTokens(DataConfig(**dcfg)))
    for _ in range(3):
        jparams, js, jm = jstep(jparams, js, jax.tree.map(jnp.asarray,
                                                         next(jit)))
        params, s, m = step(params, s, as_tensors(next(it), "cpu"))
        _close(m["loss"].numpy(), jm["loss"])
        _close(m["grad_norm"].numpy(), jm["grad_norm"])


def test_synthetic_tokens_same_stream_as_jax():
    dcfg = dict(batch_size=3, seq_len=17, vocab_size=1000, seed=7)
    jit, it = iter(JSyntheticTokens(JDataConfig(**dcfg))), \
        iter(SyntheticTokens(DataConfig(**dcfg)))
    for _ in range(3):
        jb, b = next(jit), next(it)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], jb[k])
            assert b[k].dtype == np.int32


def test_file_tokens_and_prefetcher_match_jax(tmp_path):
    """A uint16 token file gives the JAX package's random crops for the
    same seed; the prefetcher hands them over as int64 tensors."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    dcfg = dict(batch_size=2, seq_len=33, seed=4, path=str(path),
                dtype="uint16")
    jit = iter(JFileTokens(JDataConfig(**dcfg)))
    pre = Prefetcher(iter(make_dataset(DataConfig(**dcfg))), device="cpu")
    for _ in range(3):
        jb, b = next(jit), next(pre)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int64
            np.testing.assert_array_equal(b[k].numpy(), jb[k])
    pre.close()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bert-large-1b"])
def test_param_count_and_dummy_batch(arch):
    jcfg, jparams, cfg, params = _bridge(arch)
    assert api.param_count(params) == japi.param_count(jparams)
    batch = api.make_dummy_batch(cfg, 3, 7, device="cpu")
    assert set(batch) == {"tokens", "labels"}
    for t in batch.values():
        assert t.shape == (3, 7) and t.dtype == torch.int64
        assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size


def test_attn_impl_bridge():
    assert attn_impl_from_jax("xla") == "xla"
    assert attn_impl_from_jax("pallas") == "cuda"
    assert attn_impl_from_jax("pallas_interpret") == "cuda"
    with pytest.raises(ValueError):
        attn_impl_from_jax("mosaic")
    with pytest.raises(ValueError, match="attn_impl"):
        get_config("qwen3-0.6b", smoke=True).replace(attn_impl="pallas")
