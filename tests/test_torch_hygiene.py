"""Boundaries of the PyTorch port.

* It imports no JAX and nothing of the JAX package: importing every
  ``repro_torch`` module leaves no ``jax``/``repro``/``hydra`` in
  ``sys.modules``, and no source file (nor ``chip_smoke.py``) names them
  in an import statement.
* It never quietly runs on the CPU: without a CUDA device, the default
  device of an entry point (serving, SHARP training, eval) raises, and
  asking for the CUDA kernel on CPU tensors raises.
* What is not ported yet raises ``NotImplementedError`` naming the slice
  or the ROADMAP item it comes with; the options of an item since ported
  (tiered memory, item 5; the probe oracle, item 6) build as the JAX
  package's do.
* Each subpackage exports what the JAX one's ``__all__`` lists, except
  the names of unported items, each listed with its ROADMAP item.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import ast
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "hydra"}


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30      # every module was walked


def test_walk_covers_the_profiler_and_kernel_modules():
    """The import walk above reaches the profiler package and every
    kernel wrapper (pkgutil finds them; nothing here is skipped)."""
    import pkgutil

    import repro_torch
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    for name in ("profiler", "profiler.__main__", "profiler.cost",
                 "profiler.facts", "profiler.probes", "kernels.fused_decode",
                 "kernels.rmsnorm", "kernels.swiglu", "kernels.ops"):
        assert f"repro_torch.{name}" in mods


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_params(cfg, torch.Generator().manual_seed(0))


def _smoke_model():
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("qwen3-0.6b", smoke=True)
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _slot_pool(cfg, params):
    from repro_torch.serving.slots import SlotPool
    return SlotPool(cfg, 2, 16)


def _int8_block_pool(cfg, params):
    from repro_torch.serving.paging import BlockPool
    return BlockPool(cfg, 4, 8, kv_dtype="int8")


def _engine(**kw):
    def build(cfg, params):
        from repro_torch.serving.engine import InferenceEngine
        return InferenceEngine(cfg, params, capacity=2, max_seq=16, **kw)
    return build


def _spec_backend(inner):
    def build(cfg, params):
        from repro_torch.serving.backends import make_backend
        return make_backend("spec", cfg, 2, 16, draft_cfg=cfg,
                            draft_params=params, inner=inner)
    return build


@pytest.mark.parametrize("build", [
    _slot_pool, _int8_block_pool, _engine(backend="slot"),
    _engine(backend="paged", kv_dtype="int8"),
    _engine(backend="spec", spec_inner="paged"),
    _spec_backend("slot"), _spec_backend("paged"),
], ids=["slot-pool", "int8-block-pool", "slot-engine", "int8-engine",
        "spec-engine", "spec-backend-slot", "spec-backend-paged"])
def test_new_entry_points_default_to_cuda(build):
    """The slot pool, int8 pages and speculative backends of the port
    default to CUDA like every other entry point, and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = _smoke_model()
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg, params)


def _session(cfg, params):
    from repro_torch.api import HydraConfig, Session
    return Session(HydraConfig(n_devices=1, device_budget_bytes=10**8))


def _spilled_inference(cfg, params):
    from repro_torch.core.orchestrator import SpilledInference
    return SpilledInference(cfg, params, device_budget_bytes=10**8)


def _sequential_reference(cfg, params):
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)
    return train_sequential_reference(ModelTask(cfg, iter(()),
                                                params=params))


def _host_store(cfg, params):
    from repro_torch.core import partitioner as pt
    from repro_torch.core import shard_graph as sg
    from repro_torch.core.spilling import HostModelStore
    from repro_torch.optim.optimizers import OptimizerConfig
    plan = sg.build_plan(cfg)
    part = pt.partition(cfg, params, plan, budget_bytes=10**8, batch=2,
                        seq=16)
    return HostModelStore(cfg, plan, params, OptimizerConfig(), part)


@pytest.mark.parametrize("build", [_session, _spilled_inference,
                                   _sequential_reference, _host_store],
                         ids=["session", "spilled-inference",
                              "sequential-reference", "host-store"])
def test_training_entry_points_default_to_cuda(build):
    """The SHARP training and eval entry points default to CUDA like the
    serving ones, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = _smoke_model()
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg, params)


def _serve_job(cfg):
    """Ported (item 5): a tiered paged ServeJob submits and plans, its
    tiering in the plan meta (equal to the JAX session's meta in
    ``tests/test_torch_session_serve.py``)."""
    from repro_torch.api import HydraConfig, ServeJob, Session
    sess = Session(HydraConfig(), device="cpu", profile=None)
    jid = sess.submit(ServeJob(cfg, backend="paged", tiered_kv=True))
    meta = sess.plan().job(jid).meta
    assert (meta["backend"], meta["tiered_kv"], meta["prefetch_ticks"]) \
        == ("paged", True, 1)


def _spmd_job(cfg):
    from repro_torch.api import SpmdTrainJob
    SpmdTrainJob(cfg)


def _probe_oracle(cfg):
    from repro_torch.api import HydraConfig, Session
    Session(HydraConfig(partition_oracle="probe"), device="cpu")


def _mesh_train_step(cfg):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.training.train_loop import make_train_step
    started = not dist.is_initialized()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        make_train_step(cfg, OptimizerConfig(), mesh=mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("build,match", [
    (_serve_job, None), (_spmd_job, None),
    (_probe_oracle, None), (_mesh_train_step, None),
], ids=["serve-job", "spmd-job", "probe-oracle", "mesh"])
def test_unported_session_options_raise(build, match):
    """``match`` None: the option has been ported and builds."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-0.6b", smoke=True)
    if match is None:
        build(cfg)
        return
    with pytest.raises(NotImplementedError, match=match):
        build(cfg)


def test_cuda_impl_on_cpu_tensors_raises():
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16), np.float32))
    pages = torch.from_numpy(rng.standard_normal((3, 4, 2, 16), np.float32))
    tables = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(q, pages, pages, tables, lengths, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(q, pages, pages, tables, lengths, impl="pallas")


def _tiered_paged(eng):
    assert eng.backend.name == "paged" and eng.backend.tiered
    assert eng._tiered and eng._demote_on_preempt
    assert eng.summary()["tiered"] is True


def _tiered_slot(eng):
    # the JAX engine drops tiered_kv for the slot backend without a word
    assert eng.backend.name == "slot" and not eng._tiered
    assert "tiered" not in eng.summary()


@pytest.mark.parametrize("kw,check", [
    ({"param_source": object()}, None),
    ({"tiered_kv": True, "backend": "paged"}, _tiered_paged),
    ({"tiered_kv": True}, _tiered_slot),
], ids=["kw0-later slice", "kw1-later slice", "kw2-later slice"])
def test_unported_serving_options_raise(kw, check):
    """The serving options of ROADMAP item 5, ported: they build as the
    JAX engine's do — params and a param source together are the JAX
    engine's ValueError, tiering on a paged backend turns it on, and on
    the slot backend it is dropped."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if check is None:
        with pytest.raises(ValueError,
                           match="pass params or param_source, not both"):
            InferenceEngine(cfg, params, device="cpu", **kw)
        return
    check(InferenceEngine(cfg, params, device="cpu", **kw))


def test_unported_config_raises_key_error():
    """Every config of the JAX package is ported: an unknown name raises
    the JAX package's KeyError, naming what there is."""
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="unknown arch 'llama-3-8b'"):
        get_config("llama-3-8b")
    assert get_config("whisper-medium").family == "audio"


@pytest.mark.parametrize("profile", ["auto", None, "facts", "path"])
def test_session_profile_is_ported(profile, tmp_path, monkeypatch):
    """``Session(profile=...)`` takes what the JAX Session takes: "auto"
    (no profile on disk here: analytic pricing), None, a MachineFacts or a
    path; a fresh profile prices plans as measured.  Anything else is a
    TypeError."""
    from repro_torch.api import Session
    from repro_torch.profiler import MachineFacts, current_fingerprint
    monkeypatch.chdir(tmp_path)           # "auto" finds no profile here
    facts = MachineFacts(fingerprint=current_fingerprint("cpu"))
    facts.transfer = {"h2d": [{"bytes": 1, "seconds": 1e-6},
                              {"bytes": 2, "seconds": 2e-6}]}
    arg = {"facts": facts, "path": facts.save(str(tmp_path / "f.json"))}
    session = Session(device="cpu", profile=arg.get(profile, profile))
    assert session.cost.measured == (profile in ("facts", "path"))
    session.cost.transfer_seconds(10)
    prov = session.cost.provenance_summary()
    assert prov["n_measured"] == (1 if session.cost.measured else 0)
    with pytest.raises(TypeError, match="profile"):
        Session(device="cpu", profile=3)


def test_fused_paged_impl_is_ported():
    """``paged_impl="fused"`` builds a paged engine that reports it;
    ``"fused_interpret"`` (the JAX package's interpreter mode) has no
    meaning in the port and raises a ValueError naming "fused"."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = InferenceEngine(cfg, params, backend="paged", paged_impl="fused",
                          device="cpu")
    assert eng.paged_impl == eng.summary()["paged_impl"] == "fused"
    with pytest.raises(ValueError, match="'fused'"):
        InferenceEngine(cfg, params, backend="paged",
                        paged_impl="fused_interpret", device="cpu")


# JAX exports the port does not have yet, by the ROADMAP Queue 1 item that
# brings each (none since item 9.3's first half)
UNPORTED_EXPORTS: dict = {}


def _literal_all(path):
    """The ``__all__`` list of a module, read from its source (the JAX
    package is never imported here)."""
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("pkg", ["core", "models", "training", "optim",
                                 "data", "checkpoint", "serving", "api",
                                 "configs", "profiler"])
def test_package_exports_match_jax(pkg):
    """``from repro_torch.<pkg> import X`` works wherever ``from
    repro.<pkg> import X`` does, except for the named unported items."""
    jax_all = _literal_all(REPO / "src" / "repro" / pkg / "__init__.py")
    mod = importlib.import_module(f"repro_torch.{pkg}")
    assert all(hasattr(mod, name) for name in mod.__all__)
    unported = UNPORTED_EXPORTS.get(pkg, {})
    assert set(jax_all) - set(mod.__all__) == set(unported)
    assert not any(hasattr(mod, name) for name in unported)
    if pkg == "training":
        assert "make_padded_prefill_into_cache" in mod.__all__
        assert {"make_prefill_step", "decode_window_for"} <= set(mod.__all__)
