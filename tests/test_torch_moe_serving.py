"""The MoE family served by the port's ``InferenceEngine`` and
``Session``, beside the JAX package's.

mixtral-8x22b smoke in float32 (cache too) serves the same prompts
submitted on the same ticks through the slot backend: identical token
streams and lanes tick by tick (lanes at different positions share one
step; each row routes alone, so they never couple).  The family declares
no paging, no padded prefill and no speculative verify, each with JAX's
reason: a paged or spec request falls back to slot with the warning,
``bucket_sizes`` is dropped (JAX ``tests/test_serving.py``), and a
``ServeJob(paged=True)`` plans JAX's meta with both fallbacks.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_weights import both_params

from repro.api import ServeJob as JServeJob
from repro.api import Session as JSession
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.models import registry as jregistry
from repro.models.registry import \
    CapabilityFallbackWarning as JCapabilityFallbackWarning
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.api import HydraConfig, ServeJob, Session
from repro_torch.configs import get_config
from repro_torch.models import api, registry
from repro_torch.models.registry import CapabilityFallbackWarning
from repro_torch.serving.engine import InferenceEngine

ARCH = "mixtral-8x22b"
GEN = 5
SCHEDULE = {0: ("a", "b"), 1: ("c",), 3: ("d", "e")}   # tick -> arrivals
LENS = {"a": 9, "b": 4, "c": 9, "d": 6, "e": 3}
HC = dict(n_devices=1, device_budget_bytes=60 * 10**6, pilot=False,
          fixed_unit_runtime=1e-3)


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


def _cfgs(arch=ARCH):
    jcfg = jget_config(arch, smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = _cfgs()
    jparams, params = both_params(jcfg, cfg, 2)
    prompts = _prompts(cfg.vocab_size)
    kw = dict(capacity=3, max_seq=32)
    jeng = JEngine(jcfg, jparams, **kw)
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jeng=jeng, jrun=_drive(jeng, prompts), eng=eng,
                run=_drive(eng, prompts))


def test_slot_token_streams_and_lanes_match_jax(served):
    jlanes, jtoks = served["jrun"]
    lanes, toks = served["run"]
    assert set(toks) == set(LENS)
    assert all(len(t) == GEN for t in toks.values())
    assert toks == jtoks
    assert lanes == jlanes
    assert max(len(t) for t in lanes) == 3


def test_slot_summary_matches_jax(served):
    s, js = served["eng"].summary(), served["jeng"].summary()
    for k in ("slot_bytes", "backend", "requested_backend", "capacity",
              "max_seq", "decode_steps", "prefill_calls", "n_completed",
              "peak_concurrency", "bucket_sizes"):
        assert s[k] == js[k], k
    assert s["backend"] == "slot"


@pytest.mark.parametrize("kw", [dict(backend="paged"),
                                dict(backend="spec"),
                                dict(bucket_sizes=(8, 16, 32))],
                         ids=["paged", "spec", "buckets"])
def test_fallbacks_match_jax(served, kw):
    """Paged and spec fall back to slot, buckets are dropped: both engines
    warn the same words and serve the same tokens."""
    cfg, jcfg = served["cfg"], served["jcfg"]
    pkw, jkw = dict(capacity=2, max_seq=32, **kw), dict(capacity=2,
                                                         max_seq=32, **kw)
    if kw.get("backend") == "spec":
        pkw.update(draft_cfg=cfg, draft_params=served["params"], draft_k=2)
        jkw.update(draft_cfg=jcfg, draft_params=served["jparams"],
                   draft_k=2)
    with pytest.warns(CapabilityFallbackWarning) as w:
        eng = InferenceEngine(cfg, served["params"], device="cpu", **pkw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jeng = JEngine(jcfg, served["jparams"], **jkw)
    jmsgs = sorted(str(x.message) for x in caught
                   if issubclass(x.category, JCapabilityFallbackWarning))
    assert sorted(str(x.message) for x in w) == jmsgs
    s, js = eng.summary(), jeng.summary()
    assert (s["backend"], s["requested_backend"]) == \
        (js["backend"], js["requested_backend"])
    assert s["backend"] == "slot" and eng.bucket_sizes is None
    assert jeng.bucket_sizes is None
    prompt = _prompts(cfg.vocab_size)["a"]
    eng.submit(prompt, 3, request_id="x")
    jeng.submit(prompt, 3, request_id="x")
    eng.run()
    jeng.run()
    assert list(eng.completed[0].generated) == \
        list(jeng.completed[0].generated)


def test_family_spec_matches_jax():
    """JAX ``tests/test_registry.py``'s moe cases: flags, notes, decode
    state cost (the K/V cache and its index) and the paged step refusal."""
    spec, jspec = registry.spec("moe"), jregistry.spec("moe")
    assert spec.capabilities() == jspec.capabilities()
    assert spec.notes == jspec.notes
    for cap, on in spec.capabilities().items():
        assert on or spec.why_not(cap) == jspec.why_not(cap)
    jcfg, cfg = _cfgs()
    assert spec.decode_state_bytes(cfg, 2, 32) == \
        jspec.decode_state_bytes(jcfg, 2, 32)
    assert spec.kv_block_bytes(cfg, 8) == jspec.kv_block_bytes(jcfg, 8)
    with pytest.raises(ValueError):
        api.paged_decode_step(cfg, None, None, None, None, None)
    assert "moe" in registry.registered_families()
    assert set(registry.families_with("batched_prefill")) == \
        set(jregistry.families_with("batched_prefill"))
    assert set(registry.families_with("batched_prefill")) == \
        {"dense", "vlm", "moe"}


def _norm(x):
    return json.loads(json.dumps(x, default=float))


def test_paged_serve_job_plans_and_serves_as_jax():
    """``ServeJob(mixtral smoke, paged=True, bucket_sizes=(8, 16))``: the
    same plan meta with both fallbacks and their reasons, the same
    warnings at engine construction, and the request served on slot."""
    jcfg, cfg = _cfgs()
    js = JSession(JHydraConfig(**HC), profile=None)
    ps = Session(HydraConfig(**HC), device="cpu", profile=None)
    kw = dict(seed=1, capacity=2, max_seq=32, paged=True,
              bucket_sizes=(8, 16))
    jsv, sv = js.submit(JServeJob(jcfg, **kw)), ps.submit(ServeJob(cfg, **kw))
    assert sv == jsv
    meta, jmeta = ps.plan().job(sv).meta, js.plan().job(jsv).meta
    assert _norm(meta) == _norm(jmeta)
    assert meta["requested_backend"] == "paged"
    assert meta["backend"] == "slot" and not meta["paged"]
    assert set(meta["capability_fallbacks"]) == {"backend", "bucket_sizes"}
    with pytest.warns(CapabilityFallbackWarning) as w:
        eng = ps.engine(sv)
    with pytest.warns(JCapabilityFallbackWarning) as jw:
        js.engine(jsv)
    assert sorted(str(x.message) for x in w) == \
        sorted(str(x.message) for x in jw)
    assert eng.bucket_sizes is None and ps.poll(sv)["backend"] == "slot"
    prompt = _prompts(cfg.vocab_size)["c"]
    r = ps.submit_request(sv, prompt, 4)
    ps.drain_serving()
    assert len(r.generated) == 4
