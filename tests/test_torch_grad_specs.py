"""``make_grad_step``, ``InputShape``/``INPUT_SHAPES``/``input_specs``,
the ``hydra_torch`` alias and ``examples/quickstart_torch.py`` against
the JAX package's counterparts.

Gradients: float32 configs, the same weights and batch, at 2e-4 (the
matmul-chain tolerance of ``tests/test_kernel_oracles.py``).  Input
specs: JAX's shapes, the port's dtypes (int64 tokens and labels, as its
loaders give), meta tensors.  The quickstart: the port's flow and the
JAX quickstart's flow on the same float32 weights, losses at 3e-4.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import ast
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hydra
from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.core import ModelTask as JModelTask
from repro.core import train_sequential_reference as jtrain_sequential
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.training import make_grad_step as jmake_grad_step
from repro_torch.configs import INPUT_SHAPES, SMOKE_REGISTRY, InputShape
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors
from repro_torch.models import input_specs
from repro_torch.training import make_grad_step
from repro_torch.tree import tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
MM_TOL = 2e-4
SEQ_TOL = 3e-4


def _f32(arch):
    return (jget_config(arch, smoke=True).replace(dtype=jnp.float32),
            get_config(arch, smoke=True).replace(dtype="float32"))


def _weights(jcfg, cfg, seed=0):
    return both_params(jcfg, cfg, seed)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bert-large-1b"])
def test_grad_step_matches_jax_value_and_grad(arch):
    jcfg, cfg = _f32(arch)
    jparams, params = _weights(jcfg, cfg)
    raw = next(iter(SyntheticTokens(DataConfig(
        batch_size=2, seq_len=32, vocab_size=cfg.vocab_size, seed=3))))
    jgrads, jm = jax.jit(jmake_grad_step(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in raw.items()})
    grads, m = make_grad_step(cfg)(params, as_tensors(raw, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=MM_TOL, atol=MM_TOL)
    jleaves = jax.tree.leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, jg in zip(leaves, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg),
                                   rtol=MM_TOL, atol=MM_TOL)


def test_input_shapes_equal_jax():
    assert list(INPUT_SHAPES) == list(JINPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert isinstance(shape, InputShape)
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(JINPUT_SHAPES[name])


@pytest.mark.parametrize("arch", sorted(SMOKE_REGISTRY))
def test_input_specs_have_jax_shapes_and_port_dtypes(arch):
    from repro.models.api import input_specs as jinput_specs
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        jcfg = jget_config(arch, smoke=smoke)
        for shape in INPUT_SHAPES.values():
            for kind in (None, "train", "prefill", "decode"):
                specs = input_specs(cfg, shape, kind=kind)
                jspecs = jinput_specs(jcfg, JINPUT_SHAPES[shape.name],
                                      kind=kind)
                assert {k: tuple(v.shape) for k, v in specs.items()} == \
                    {k: tuple(v.shape) for k, v in jspecs.items()}
                assert all(v.device.type == "meta" and v.dtype == (
                    torch.bfloat16 if k.endswith("embeds") else torch.int64)
                    for k, v in specs.items())


def test_input_specs_of_unported_families_name_their_item():
    """The vlm and audio families are ported: their ``input_specs`` have
    the JAX package's keys and shapes in every kind (bf16 ``embeds`` /
    ``enc_embeds`` beside int64 tokens and labels), and
    ``make_dummy_batch`` gives real tensors of the same keys, shapes and
    dtypes."""
    from repro.models.api import input_specs as jinput_specs
    from repro.models.api import make_dummy_batch as jmake_dummy_batch
    from repro_torch.models.api import make_dummy_batch
    for arch in ("llava-next-mistral-7b", "whisper-medium", "vit-300m"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in INPUT_SHAPES.items():
            for kind in ("train", "prefill", "decode"):
                specs = input_specs(cfg, shape, kind=kind)
                jspecs = jinput_specs(jcfg, JINPUT_SHAPES[name], kind=kind)
                assert {k: tuple(v.shape) for k, v in specs.items()} == \
                    {k: tuple(v.shape) for k, v in jspecs.items()}
        scfg, sjcfg = get_config(arch, smoke=True), jget_config(
            arch, smoke=True)
        batch = make_dummy_batch(scfg, 2, 16, torch.Generator().manual_seed(0),
                                 device="cpu")
        jbatch = jmake_dummy_batch(sjcfg, 2, 16)
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in jbatch.items()}
        for k, v in batch.items():
            assert v.dtype == (torch.bfloat16 if k.endswith("embeds")
                               else torch.int64)
            assert str(jbatch[k].dtype) == (
                "bfloat16" if k.endswith("embeds") else "int32")


def _literal_all(path):
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_hydra_torch_exports_equal_hydra():
    import hydra_torch
    path = REPO / "src" / "hydra_torch" / "__init__.py"
    assert _literal_all(path) == _literal_all(
        REPO / "src" / "hydra" / "__init__.py") == hydra.__all__
    assert all(hasattr(hydra_torch, n) for n in hydra_torch.__all__)
    assert hydra_torch.Session.__module__ == "repro_torch.api.session"


@pytest.mark.parametrize("path", [
    "src/hydra_torch/__init__.py", "examples/quickstart_torch.py",
    "examples/large_model_single_device_torch.py",
    "examples/model_selection_torch.py", "examples/serve_batched_torch.py",
    *sorted(str(p.relative_to(REPO)) for p in (REPO / "tools").glob(
        "*.py"))])
def test_new_entry_points_import_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "hydra"}


def test_quickstart_runs_on_the_cpu_and_matches_the_jax_flow(capsys):
    """``main(device="cpu")`` passes its own assertion; on the same
    float32 weights its losses are the JAX quickstart flow's."""
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", REPO / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    assert qs.main(device="cpu")[0]              # bf16 smoke, as shipped
    jcfg, cfg = _f32("bert-large-1b")
    weights = [_weights(jcfg, cfg, seed) for seed in (0, 1)]
    out = qs.main(device="cpu", cfg=cfg,
                  params=tuple(w[1] for w in weights))
    assert "sequential ref" in capsys.readouterr().out

    def jloader(seed):
        return JSyntheticTokens(JDataConfig(batch_size=2, seq_len=64,
                                            vocab_size=jcfg.vocab_size,
                                            seed=seed))
    session = hydra.Session(hydra.HydraConfig(
        n_devices=2, device_budget_bytes=6 * 10**6), profile=None)
    for seed, lr in ((0, 1e-3), (1, 1e-4)):
        session.submit(hydra.TrainJob(jcfg, jloader(seed), lr=lr, epochs=1,
                                      steps_per_epoch=3, batch=2, seq=64,
                                      params=weights[seed][0]))
    jtrain = session.run(session.plan()).train
    _, jref = jtrain_sequential(JModelTask(
        jcfg, jloader(0), lr=1e-3, epochs=1, steps_per_epoch=3, batch=2,
        seq=64, params=weights[0][0]))
    for mid in (0, 1):
        np.testing.assert_allclose(out[mid], jtrain.losses[mid],
                                   rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(out["reference"], jref, rtol=SEQ_TOL,
                               atol=SEQ_TOL)
