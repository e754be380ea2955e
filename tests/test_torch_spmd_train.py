"""The port's training over a device mesh against the JAX package's.

* ``make_train_step(mesh=)`` on a (1, 1) gloo mesh, with JAX's params and
  one ``data/pipeline`` batch (qwen3-0.6b smoke in f32, ``accum`` 1 and
  2): loss, ``grad_norm`` and every new param equal JAX's
  ``make_train_step(mesh=make_mesh((1, 1), ...))`` within 2e-4, the
  tolerance of ``tests/test_kernel_oracles.py`` for matmul chains.
* Four gloo ranks on a (2, 2) mesh (``accum`` 1 and 2): the same step
  equals the port's step without a mesh within 2e-4, and every param's
  local shard has the shape JAX's ``param_specs`` implies on a (2, 2)
  mesh.
* JAX's ``test_train_launcher_end_to_end`` case (``tests/test_system.py``)
  on both packages, the port's on the CPU; the port's final checkpoint
  restores bit for bit in JAX's ``checkpoint.restore``.
* A ``Session(device="cpu")`` with a ``SpmdTrainJob``: its plan meta is
  JAX's, and ``report.spmd`` holds the run's record.

The in-process cases share one gloo world of one rank, started by the
first mesh and ended when the file's tests are done.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_mesh_ranks import run_ranks, spmd_step_rank
from _torch_weights import both_params
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.sharding import specs as jsh
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import specs as sh
from repro_torch.sharding.context import activation_axes
from repro_torch.training.train_loop import make_train_step

MM_TOL = 2e-4


@pytest.fixture(scope="module")
def mesh11():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    yield mesh
    dist.destroy_process_group()


def _close(out, exp, tol=MM_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_step_matches_jax(mesh11, accum):
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(dtype="float32")
    jparams, params = both_params(jcfg, cfg, seed=0)
    raw = next(iter(SyntheticTokens(DataConfig(
        batch_size=4, seq_len=32, vocab_size=cfg.vocab_size, seed=0))))
    jocfg, ocfg = jopt.OptimizerConfig(lr=1e-3), opt.OptimizerConfig(lr=1e-3)

    jstep = jax.jit(jmake_train_step(
        jcfg, jocfg, accum_steps=accum,
        mesh=jmake_mesh((1, 1), ("data", "model"))))
    jp, _, jm = jstep(jparams, jopt.init_state(jocfg, jparams),
                      jax.tree.map(jnp.asarray, raw))

    dp = sh.distribute(mesh11, params, sh.param_specs(cfg, params, mesh11))
    step = make_train_step(cfg, ocfg, accum_steps=accum, mesh=mesh11)
    with activation_axes(mesh11, moe_shardmap=False):
        p, _, m = step(dp, opt.init_state(ocfg, dp), as_tensors(raw, "cpu"))
    _close(float(m["loss"]), float(jm["loss"]))
    _close(float(m["grad_norm"]), float(jm["grad_norm"]))
    full = dict((sh._path_key(k), v) for k, v in
                sh.leaves_with_path(sh.full_tensors(p)))
    jflat = {"/".join(str(getattr(q, "key", q)) for q in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert full.keys() == jflat.keys()
    for k, v in full.items():
        _close(v.numpy(), jflat[k])


@pytest.mark.parametrize("accum", [1, 2])
def test_four_rank_mesh_step_matches_unmeshed(tmp_path, accum):
    run_ranks(spmd_step_rank, 4, tmp_path, "qwen3-0.6b", accum, timeout=300)
    out = torch.load(tmp_path / "spmd_step.pt")
    assert out["loss"] <= MM_TOL and out["grad_norm"] <= MM_TOL
    assert out["params"] <= MM_TOL
    jcfg = jget_config("qwen3-0.6b", smoke=True)
    shapes = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    mock = SimpleNamespace(shape={"data": 2, "model": 2},
                           axis_names=("data", "model"))
    specs = jsh.param_specs(jcfg, shapes, mock)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        key = "/".join(str(getattr(q, "key", q)) for q in path)
        gshape = out_shape = None
        leaf = shapes
        for q in path:
            leaf = leaf[q.key]
        gshape = leaf.shape
        out_shape = tuple(n // jsh._axis_size(mock, a) for n, a in
                          zip(gshape, tuple(spec) + (None,) * len(gshape)))
        assert out["local_shapes"][key] == out_shape, key


class _LaunchArgs:
    arch = "qwen3-0.6b"; smoke = True; steps = 6; batch = 2; seq = 64
    accum = 1; lr = 1e-3; optimizer = "adamw"; seed = 0; data = None
    mesh = "auto"; multi_pod = False; log_every = 2
    ckpt_dir = None; ckpt_every = 100


def test_train_launcher_end_to_end_both_packages(mesh11, tmp_path):
    from repro.checkpoint import restore as jrestore
    from repro.launch.train import train as jtrain
    from repro_torch.checkpoint import restore
    from repro_torch.launch.train import train

    jout = jtrain(_LaunchArgs())
    args = _LaunchArgs()
    args.device, args.ckpt_dir = "cpu", str(tmp_path)
    out = train(args)
    for o in (jout, out):
        assert np.isfinite(o["final_loss"])
        assert o["history"][-1]["loss"] < o["history"][0]["loss"] + 1.0
    assert out.keys() == jout.keys() and out["params"] == jout["params"]
    assert [h["step"] for h in out["history"]] \
        == [h["step"] for h in jout["history"]]

    path = str(tmp_path / f"step_{args.steps}")
    jtree, jman = jrestore(path)
    tree, man = restore(path)
    assert jman["step"] == man["step"] == args.steps
    assert jtree.keys() == tree.keys()
    for k, v in tree.items():
        a = np.asarray(jtree[k])
        assert a.dtype == v.numpy().dtype and a.shape == tuple(v.shape)
        assert a.tobytes() == v.numpy().tobytes(), k


def test_session_spmd_job_plans_and_runs(mesh11):
    from repro.api import Session as JSession
    from repro.api import SpmdTrainJob as JSpmdTrainJob
    from repro_torch.api import Session, SpmdTrainJob

    kw = dict(steps=2, batch=2, seq=32, log_every=1)
    js = JSession()
    jjid = js.submit(JSpmdTrainJob(jget_config("qwen3-0.6b", smoke=True),
                                   **kw))
    sess = Session(device="cpu")
    jid = sess.submit(SpmdTrainJob(get_config("qwen3-0.6b", smoke=True),
                                   **kw))
    assert jid == jjid == "spmd-0"
    assert sess.plan().job(jid).meta == js.plan().job(jjid).meta
    rec = sess.run().spmd[jid]
    assert [h["step"] for h in rec["history"]] == [0, 1]
    assert np.isfinite(rec["final_loss"]) and rec["params"] > 0
    assert sess.poll(jid)["status"] == "done"
