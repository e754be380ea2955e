"""``examples/large_model_single_device_torch.py`` against the JAX
example's flow (``examples/large_model_single_device.py``), as
``tests/test_torch_grad_specs.py`` holds the quickstart.

* ``main(device="cpu")`` as shipped (the 8-layer qwen3-0.6b smoke model,
  bf16, 14 MB budget) passes its own check: the model is larger than the
  device.
* On the same float32 weights (JAX's init through numpy) both flows cut
  the same shards — count, first and last segment names, bytes — train
  to the same losses (rtol = atol = 3e-4, the quickstart's tolerance),
  move the same promoted and demoted bytes, and the spilled eval at a
  third of the budget has the same ``n_shards`` and ``bytes_moved`` and
  the same mean loss.  The parity run is the example cut to 4 layers and
  2 steps to stay in time; at the example's 14 MB it still spills (4
  shards).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np

import hydra
from repro.configs import get_config as jget_config
from repro.core.partitioner import tree_bytes as jtree_bytes
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.configs import get_config

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 3e-4
LAYERS, STEPS, BUDGET = 4, 2, 14 * 10**6


def _example():
    spec = importlib.util.spec_from_file_location(
        "large_model_single_device_torch",
        REPO / "examples" / "large_model_single_device_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_flow(jcfg, jparams, budget, steps):
    """The JAX example's ``main`` on given weights, steps and budget."""
    def loader(seed):
        return JSyntheticTokens(JDataConfig(batch_size=2, seq_len=64,
                                            vocab_size=jcfg.vocab_size,
                                            seed=seed))
    session = hydra.Session(hydra.HydraConfig(
        n_devices=1, device_budget_bytes=budget), profile=None)
    session.submit(hydra.TrainJob(jcfg, loader(0), lr=1e-3, epochs=1,
                                  steps_per_epoch=steps, batch=2, seq=64,
                                  params=jparams))
    plan = session.plan()
    m = session.train_execs[0]
    shards = [(s.index, m.plan.segments[s.seg_lo].name,
               m.plan.segments[s.seg_hi - 1].name, s.param_bytes)
              for s in m.partition.shards]
    train = session.run(plan).train
    evaler = hydra.Session(hydra.HydraConfig(
        n_devices=1, device_budget_bytes=budget // 3), profile=None)
    jid = evaler.submit(hydra.EvalJob(jcfg, loader(7), n_batches=1,
                                      params=m.store.model_params(),
                                      batch=2, seq=64))
    return {"model_bytes": jtree_bytes(m.store.params) * 4,
            "shards": shards, "losses": train.losses[0],
            "promoted_bytes": train.transfer[0].promoted_bytes,
            "demoted_bytes": train.transfer[0].demoted_bytes,
            "eval": evaler.run().evals[jid]}


def test_example_runs_as_shipped(capsys):
    shipped = _example().main(device="cpu")
    assert shipped["model_bytes"] > shipped["budget"]
    assert len(shipped["shards"]) >= 2
    assert shipped["eval"]["n_shards"] >= 2
    assert "OK: larger-than-device" in capsys.readouterr().out


def test_example_matches_the_jax_flow():
    ex = _example()
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        n_layers=LAYERS, dtype=jnp.float32)
    cfg = get_config("qwen3-0.6b", smoke=True).replace(n_layers=LAYERS,
                                                       dtype="float32")
    jparams, params = both_params(jcfg, cfg, seed=0)
    out = ex.main(device="cpu", cfg=cfg, params=params, budget=BUDGET,
                  steps=STEPS)
    exp = _jax_flow(jcfg, jparams, BUDGET, STEPS)
    assert len(out["shards"]) >= 2
    assert out["model_bytes"] == exp["model_bytes"] > BUDGET
    assert out["shards"] == exp["shards"]
    np.testing.assert_allclose(out["losses"], exp["losses"], rtol=TOL,
                               atol=TOL)
    assert (out["promoted_bytes"], out["demoted_bytes"]) \
        == (exp["promoted_bytes"], exp["demoted_bytes"])
    for key in ("n_shards", "bytes_moved"):
        assert out["eval"][key] == exp["eval"][key], key
    np.testing.assert_allclose(out["eval"]["mean_loss"],
                               exp["eval"]["mean_loss"], rtol=TOL, atol=TOL)
