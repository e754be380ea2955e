"""``examples/model_selection_torch.py`` against the JAX example's flow
(``examples/model_selection.py``), as ``tests/test_torch_grad_specs.py``
holds the quickstart.

* ``main(device="cpu")`` as shipped — the whole lr x batch grid of six
  bert-large-1b smoke models under SHARP on 4 virtual devices of 4.5 MB
  — prints every paradigm's line, task parallelism's "CRASH (OOM)", and
  the best configuration; SHARP's makespan is below model
  parallelism's, and pipelining's is not above it.
* On the grid's first two points with the same float32 weights (JAX's
  init through numpy, seeds 0 and 1): both flows cut the same shards,
  train to the same losses (rtol = atol = 3e-4, the quickstart's
  tolerance), make the same task-parallel out-of-memory decision with the
  same message, and pick the same best configuration.  (Makespans are
  measured wall times, so they are compared within each package only.)
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np

import hydra
from repro.configs import get_config as jget_config
from repro.core import baselines as jbl
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.configs import get_config

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 3e-4


def _example():
    spec = importlib.util.spec_from_file_location(
        "model_selection_torch",
        REPO / "examples" / "model_selection_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_flow(jcfg, jparams, grid, budget, n_devices, steps=2, seq=64):
    """The JAX example's ``main`` on given weights and grid."""
    session = hydra.Session(hydra.HydraConfig(
        n_devices=n_devices, device_budget_bytes=budget), profile=None)
    for i, (lr, bs) in enumerate(grid):
        data = JSyntheticTokens(JDataConfig(batch_size=bs, seq_len=seq,
                                            vocab_size=jcfg.vocab_size,
                                            seed=i))
        session.submit(hydra.TrainJob(jcfg, data, lr=lr, epochs=1,
                                      steps_per_epoch=steps, seed=i,
                                      batch=bs, seq=seq, params=jparams[i]))
    train = session.run(session.plan()).train
    models = session.train_execs
    try:
        jbl.task_parallel(models, n_devices, [steps] * len(grid), budget)
        oom = None
    except MemoryError as e:
        oom = str(e)
    best = min(train.losses, key=lambda m: train.losses[m][-1])
    return {"losses": train.losses, "oom": oom, "best": best,
            "shards": [len(m.partition.shards) for m in models]}


def test_example_runs_as_shipped(capsys):
    ex = _example()
    out = ex.main(device="cpu")
    text = capsys.readouterr().out
    for line in ("hydra (SHARP)", "model parallel", "pipeline",
                 "CRASH (OOM)", "best config: model"):
        assert line in text
    assert len(out["losses"]) == len(ex.GRID)
    assert all(np.isfinite(v).all() for v in out["losses"].values())
    assert out["makespan"]["task_parallel"] is None
    ms = out["makespan"]
    assert ms["sharp"] < ms["model_parallel"]
    assert ms["pipeline"] <= ms["model_parallel"]
    assert out["best"][1:] == ex.GRID[out["best"][0]]


def test_example_matches_the_jax_flow():
    ex = _example()
    grid = ex.GRID[:2]
    jcfg = jget_config("bert-large-1b", smoke=True).replace(
        dtype=jnp.float32)
    cfg = get_config("bert-large-1b", smoke=True).replace(dtype="float32")
    weights = [both_params(jcfg, cfg, seed=i) for i in range(len(grid))]
    out = ex.main(device="cpu", cfg=cfg, params=[w[1] for w in weights],
                  grid=grid)
    exp = _jax_flow(jcfg, [w[0] for w in weights], grid, ex.BUDGET,
                    ex.N_DEVICES)
    assert [len(m.partition.shards) for m in out["session"].train_execs] \
        == exp["shards"]
    assert out["losses"].keys() == exp["losses"].keys()
    for mid in exp["losses"]:
        np.testing.assert_allclose(out["losses"][mid], exp["losses"][mid],
                                   rtol=TOL, atol=TOL)
    assert exp["oom"] is not None
    assert out["task_parallel_error"] == exp["oom"]
    assert out["best"][0] == exp["best"]
