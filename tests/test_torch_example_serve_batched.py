"""``examples/serve_batched_torch.py`` against the JAX example's flow
(``examples/serve_batched.py``), as ``tests/test_torch_grad_specs.py``
holds the quickstart.

* ``main(device="cpu")`` as shipped serves three requests on each of
  qwen3-0.6b, mixtral-8x22b (cold) and xlstm-350m smoke under LRTF: every
  request gets its 8 tokens, the cold model promotes its weights, the
  schedule names all three models, and only qwen3-0.6b keeps its
  power-of-two buckets: the other two fall back to exact-length groups
  for the reason JAX's ``why_not("padded_prefill")`` gives.
* On the same float32 weights (JAX's init through numpy) and JAX's own
  ``jax.random`` prompts, both flows generate identical tokens, give each
  model the same number of engine ticks (LRTF orders them by measured
  times, so the order may differ), and report the same completions,
  prefill calls, buckets and cold promotion bytes per model.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import importlib.util
import pathlib
from collections import Counter

import jax.numpy as jnp
import numpy as np

import hydra
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.models.api import family_spec

REPO = pathlib.Path(__file__).resolve().parents[1]
SAME = ("n_completed", "prefill_calls", "bucket_sizes", "cold",
        "promote_bytes")


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_batched_torch", REPO / "examples" / "serve_batched_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "serve_batched", REPO / "examples" / "serve_batched.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_runs_as_shipped(capsys):
    ex = _example()
    out = ex.main(device="cpu")
    assert "schedule:" in capsys.readouterr().out
    assert set(out["tokens"]) == set(ex.ARCHS)
    for toks in out["tokens"].values():
        assert [len(t) for t in toks] == [ex.GEN] * 3
    recs = {r["model"]: r for r in out["serve"].values()}
    assert recs[ex.COLD]["cold"] and recs[ex.COLD]["promote_bytes"] > 0
    assert set(out["schedule"]) == set(ex.ARCHS)
    assert [m for m, r in recs.items() if r["bucket_sizes"]] \
        == ["qwen3-0.6b"]
    for arch in ex.ARCHS[1:]:
        spec = family_spec(get_config(arch, smoke=True))
        jspec = japi.family_spec(jget_config(arch, smoke=True))
        assert not spec.padded_prefill and not jspec.padded_prefill
        assert spec.why_not("padded_prefill") \
            == jspec.why_not("padded_prefill")


def test_example_matches_the_jax_flow():
    ex, jex = _example(), _jax_example()
    jcfgs = [jget_config(a, smoke=True).replace(dtype=jnp.float32)
             for a in ex.ARCHS]
    cfgs = [get_config(a, smoke=True).replace(dtype="float32")
            for a in ex.ARCHS]
    weights = [both_params(j, c, seed=i)
               for i, (j, c) in enumerate(zip(jcfgs, cfgs))]
    prompts = {c.name: [np.asarray(p) for p in
                        jex.prompts_for(j, 3, seed=10 * i)]
               for i, (j, c) in enumerate(zip(jcfgs, cfgs))}

    session = hydra.Session(hydra.HydraConfig(scheduler="lrtf"))
    for i, jcfg in enumerate(jcfgs):
        session.submit(hydra.ServeJob(
            jcfg, seed=i, name=jcfg.name, capacity=4, max_seq=64,
            bucket_sizes="pow2", cold=(jcfg.name == ex.COLD),
            params=weights[i][0]))
    jreqs = {j.name: [session.submit_request(j.name, jnp.asarray(p),
                                             ex.GEN)
                      for p in prompts[j.name]] for j in jcfgs}
    report = session.run()
    jrecs = {r["model"]: r for r in report.serve.values()}

    out = ex.main(device="cpu", cfgs=cfgs, params=[w[1] for w in weights],
                  prompts=prompts)
    recs = {r["model"]: r for r in out["serve"].values()}
    assert out["tokens"] == {m: [list(r.generated) for r in reqs]
                             for m, reqs in jreqs.items()}
    # LRTF orders ticks by measured times; the ticks each model takes
    # are the same
    assert Counter(out["schedule"]) == Counter(report.serve_trace)
    for m in ex.ARCHS:
        assert {k: recs[m].get(k) for k in SAME} \
            == {k: jrecs[m].get(k) for k in SAME}, m
