"""The port's slot ``InferenceEngine`` on the recurrent families against
the JAX package's.

``zamba2-1.2b`` (hybrid: Mamba2 states + the shared block's K/V slots)
and ``xlstm-350m`` (ssm: mLSTM / sLSTM states) smoke in float32 serve the
same prompts submitted on the same ticks, through the slot backend that
both families fall back to.  The port holds one per-lane state where the
JAX package vmaps batch-1 states, so lanes at different positions share
one decode step: the port must give identical token streams, the same
lane assignment tick by tick (hence the same admission order) and the
same ``slot_bytes``, and a request for the paged or speculative backend
must fall back to slot with a ``CapabilityFallbackWarning`` and the same
summary fields as the JAX engine.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models.registry import \
    CapabilityFallbackWarning as JCapabilityFallbackWarning
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.registry import CapabilityFallbackWarning
from repro_torch.serving.engine import InferenceEngine

ARCHS = ["zamba2-1.2b", "xlstm-350m"]
GEN = 5
SCHEDULE = {0: ("a", "b"), 1: ("c",), 3: ("d", "e")}   # tick -> arrivals
LENS = {"a": 9, "b": 4, "c": 9, "d": 6, "e": 3}


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, vocab, n, dtype=np.int32)
            for k, n in LENS.items()}


def _drive(engine, prompts):
    lanes, tick = [], 0
    while engine.has_work() or tick <= max(SCHEDULE):
        for rid in SCHEDULE.get(tick, ()):
            engine.submit(prompts[rid], GEN, request_id=rid)
        engine.step()
        lanes.append({lane: r.request_id
                      for lane, r in engine._active.items()})
        tick += 1
    engine.run()
    return lanes, {r.request_id: list(r.generated) for r in engine.completed}


def _cfgs(arch):
    jcfg = jget_config(arch, smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    prompts = _prompts(cfg.vocab_size)
    kw = dict(capacity=3, max_seq=32)
    jeng = JEngine(jcfg, jparams, **kw)
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jeng=jeng, jrun=_drive(jeng, prompts), eng=eng,
                run=_drive(eng, prompts))


def test_token_streams_are_identical(served):
    jlanes, jtoks = served["jrun"]
    lanes, toks = served["run"]
    assert set(toks) == set(LENS)
    assert all(len(t) == GEN for t in toks.values())
    assert toks == jtoks


def test_admission_order_and_lanes_match_tick_by_tick(served):
    assert served["run"][0] == served["jrun"][0]
    # lanes really held requests at different positions in one step
    assert max(len(t) for t in served["run"][0]) == 3


def test_slot_bytes_and_summary_match(served):
    s, js = served["eng"].summary(), served["jeng"].summary()
    for k in ("slot_bytes", "backend", "requested_backend", "capacity",
              "max_seq", "decode_steps", "prefill_calls", "n_completed",
              "peak_concurrency"):
        assert s[k] == js[k], k
    assert s["backend"] == "slot"


@pytest.mark.parametrize("backend", ["paged", "spec"])
def test_paged_and_spec_fall_back_to_slot_as_in_jax(served, backend):
    """Neither family declares paging or spec_draftable: both engines warn
    and serve from the slot backend, recording what was asked for."""
    cfg, jcfg = served["cfg"], served["jcfg"]
    kw = dict(capacity=2, max_seq=32, backend=backend)
    if backend == "spec":
        kw.update(draft_cfg=cfg, draft_params=served["params"], draft_k=2)
        jkw = dict(kw, draft_cfg=jcfg, draft_params=served["jparams"])
    else:
        jkw = kw
    with pytest.warns(CapabilityFallbackWarning):
        eng = InferenceEngine(cfg, served["params"], device="cpu", **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jeng = JEngine(jcfg, served["jparams"], **jkw)
    assert any(issubclass(w.category, JCapabilityFallbackWarning)
               for w in caught)
    s, js = eng.summary(), jeng.summary()
    assert (s["backend"], s["requested_backend"]) == \
        (js["backend"], js["requested_backend"]) == ("slot", backend)
    prompt = _prompts(cfg.vocab_size)["a"]
    eng.submit(prompt, 3, request_id="x")
    jeng.submit(prompt, 3, request_id="x")
    eng.run()
    jeng.run()
    assert list(eng.completed[0].generated) == \
        list(jeng.completed[0].generated)
