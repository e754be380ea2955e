"""Length-bucketed prefill in the port (``serving/engine.py``'s
``bucket_sizes`` and ``pow2_buckets``, ``training/train_loop.py``'s
``make_padded_prefill_into_cache``, ``ServeJob.bucket_sizes``) against the
JAX package's, in f32.

The reference's bucket scenarios, retargeted: ``tests/test_serving.py``
(pow2 coverage, one prefill per (n, bucket), bucketed vs exact, paged with
buckets, the recurrent fallback and its structured warning),
``tests/test_prefix_sharing.py`` (buckets composing with prefix sharing)
and ``tests/test_api_session.py`` (bad bucket specs at submit, the
recurrent job's plan meta).  Every port engine runs beside the JAX engine
on bridged params: tokens, prefill calls and summaries must be equal.
The reference's MoE case waits for the MoE family (ROADMAP Queue 1 item
8).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeJob as JServeJob
from repro.api import Session as JSession
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.models import api as japi
from repro.models.registry import \
    CapabilityFallbackWarning as JCapabilityFallbackWarning
from repro.serving import InferenceEngine as JEngine
from repro.serving import pow2_buckets as jpow2_buckets
from repro.training.train_loop import \
    make_padded_prefill_into_cache as jmake_padded_prefill
from repro_torch.api import HydraConfig, ServeJob, Session
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.registry import CapabilityFallbackWarning
from repro_torch.serving import InferenceEngine, pow2_buckets
from repro_torch.training.train_loop import (make_padded_prefill_into_cache,
                                             make_prefill_into_cache)

MAX_SEQ = 64
F32_TOL = 2e-5
HC = dict(n_devices=2, device_budget_bytes=18 * 10**6, pilot=False,
          fixed_unit_runtime=1e-3)


@functools.lru_cache(maxsize=None)
def _cfgs(arch="qwen3-0.6b"):
    jcfg = jget_config(arch, smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params(arch="qwen3-0.6b", seed=0):
    jcfg, _ = _cfgs(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _prompt(vocab, seed, plen):
    return np.random.default_rng(seed).integers(0, vocab, plen,
                                                dtype=np.int32)


def _serve(prompts, gen, arch="qwen3-0.6b", **kw):
    """The same engine of both packages over ``prompts``: (JAX engine, its
    tokens, port engine, its tokens)."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _params(arch)
    out = []
    for Eng, c, p, extra in ((JEngine, jcfg, jparams, {}),
                             (InferenceEngine, cfg, params,
                              {"device": "cpu"})):
        if kw.get("backend") == "spec":
            extra = dict(extra, draft_cfg=c, draft_params=p)
        eng = Eng(c, p, max_seq=MAX_SEQ, **kw, **extra)
        reqs = [eng.submit(q, gen) for q in prompts]
        eng.run()
        out += [eng, [list(map(int, r.generated)) for r in reqs]]
    return out


BACKENDS = {
    "slot": {},
    "paged": dict(backend="paged", block_size=8),
    "spec-slot": dict(backend="spec", draft_k=3),
    "spec-paged": dict(backend="spec", draft_k=3, spec_inner="paged",
                       block_size=8),
}


@pytest.mark.parametrize("max_seq", [1, 40, 64, 1056])
def test_pow2_buckets_match_jax(max_seq):
    assert pow2_buckets(max_seq) == jpow2_buckets(max_seq)
    b = pow2_buckets(max_seq)
    assert b[-1] == max_seq and list(b) == sorted(set(b))
    assert pow2_buckets(64) == (1, 2, 4, 8, 16, 32, 64)


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_one_prefill_per_bucket_and_tokens_identical(backend):
    """Mixed lengths in one bucket share ONE prefill call, and every
    request's tokens equal the exact-length engine's and the JAX
    engine's (``test_serving.py``'s one-trace and paged cases)."""
    vocab = _cfgs()[1].vocab_size
    prompts = [_prompt(vocab, 70 + i, n) for i, n in enumerate([9, 11, 13,
                                                                 16])]
    kw = dict(BACKENDS[backend], capacity=4)
    jeng, jtoks, eng, toks = _serve(prompts, 6, bucket_sizes=(4, 8, 16, 32),
                                    **kw)
    _, _, exact, etoks = _serve(prompts, 6, **kw)
    assert eng.prefill_calls == jeng.prefill_calls == 1   # (n=4, bucket=16)
    assert exact.prefill_calls == 4
    assert eng.summary()["bucket_sizes"] == \
        jeng.summary()["bucket_sizes"] == [4, 8, 16, 32]
    assert toks == jtoks == etoks


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_bucketed_vs_exact_engine_same_tokens(backend):
    vocab = _cfgs()[1].vocab_size
    prompts = [_prompt(vocab, 80 + i, n) for i, n in enumerate([5, 7, 12])]
    kw = dict(BACKENDS[backend], capacity=3)
    jeng, jtoks, eng, toks = _serve(prompts, 5, bucket_sizes=(8, 16), **kw)
    _, _, exact, etoks = _serve(prompts, 5, **kw)
    assert exact.prefill_calls == 3
    assert eng.prefill_calls == jeng.prefill_calls == 2
    assert toks == jtoks == etoks
    s, js = eng.summary(), jeng.summary()
    for key in ("backend", "bucket_sizes", "decode_steps", "kv_peak_bytes",
                "kv_page_peak_bytes", "shared_block_hits", "cow_copies"):
        assert s.get(key) == js.get(key), key
    assert eng.budget.reserved_bytes == 0


def test_buckets_compose_with_prefix_sharing():
    """Length buckets pad the prefill; shared blocks are skipped by the
    page scatter, so bucketing + sharing still decode token-identically
    (``test_prefix_sharing.py``), and the paged reservation charges the
    bucket width as the JAX engine's does."""
    vocab = _cfgs()[1].vocab_size
    prefix = _prompt(vocab, 700, 8)
    prompts = [np.concatenate([prefix, _prompt(vocab, 701 + i, 1 + i)])
               for i in range(3)]
    kw = dict(backend="paged", block_size=4, prefix_share=True, capacity=4)
    jeng, jtoks, eng, toks = _serve(prompts, 5, bucket_sizes=(4, 8, 16, 32),
                                    **kw)
    _, _, exact, etoks = _serve(prompts, 5, **kw)
    assert toks == jtoks == etoks
    assert eng.backend.shared_block_hits == jeng.backend.shared_block_hits > 0
    assert eng.summary()["kv_peak_bytes"] == jeng.summary()["kv_peak_bytes"]
    assert eng.pool.n_free == eng.pool.n_allocatable


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_recurrent_family_falls_back_with_structured_warning(arch):
    """A recurrent state advances through every consumed token and cannot
    be rewound: both engines warn, drop the buckets and serve exact-length
    groups with the same tokens (``test_serving.py``'s fallback cases)."""
    jcfg, cfg = _cfgs(arch)
    jparams, params = _params(arch)
    prompts = [_prompt(cfg.vocab_size, 90 + i, n)
               for i, n in enumerate([6, 9])]
    with pytest.warns(JCapabilityFallbackWarning, match="bucket_sizes") as jw:
        jeng = JEngine(jcfg, jparams, capacity=2, max_seq=MAX_SEQ,
                       bucket_sizes=(8, 16))
    with pytest.warns(CapabilityFallbackWarning, match="bucket_sizes") as w:
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=MAX_SEQ,
                              bucket_sizes=(8, 16), device="cpu")
    assert [str(x.message) for x in w] == [str(x.message) for x in jw]
    assert eng.bucket_sizes is jeng.bucket_sizes is None
    assert eng.summary()["bucket_sizes"] is None
    toks = []
    for e in (jeng, eng):
        reqs = [e.submit(p, 4) for p in prompts]
        e.run()
        toks.append([list(map(int, r.generated)) for r in reqs])
    assert toks[0] == toks[1]
    with pytest.raises(ValueError, match="rewindable") as jerr:
        jmake_padded_prefill(jcfg)
    with pytest.raises(ValueError, match="rewindable") as err:
        make_padded_prefill_into_cache(cfg)
    assert str(err.value) == str(jerr.value)


def test_padded_prefill_logits_and_rewound_state_match_jax():
    """``make_padded_prefill_into_cache`` on a right-padded group: the
    logits at each true length's last position and the whole rewound
    state equal the JAX factory's (vmapped over batch-1 states) at 2e-5,
    and equal an exact-length prefill of each prompt."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    lens, bucket, width = [5, 9, 16], 16, 32
    prompts = [_prompt(cfg.vocab_size, 40 + i, n) for i, n in enumerate(lens)]
    tokens = np.stack([np.pad(p, (0, bucket - len(p))) for p in prompts])
    jfn = jax.vmap(jmake_padded_prefill(jcfg), in_axes=(None, 0, 0, 0))
    jstate = jax.vmap(lambda _: japi.init_decode_state(jcfg, 1, width))(
        jnp.arange(len(lens)))
    jlogits, jstate = jfn(jparams, jstate, jnp.asarray(tokens)[:, None, :],
                          jnp.asarray(lens, jnp.int32))
    state = api.init_decode_state(cfg, len(lens), width, "cpu")
    logits, state = make_padded_prefill_into_cache(cfg)(
        params, state, torch.from_numpy(tokens.astype(np.int64)),
        torch.tensor(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, 0],
                               rtol=F32_TOL, atol=F32_TOL)
    assert state["kv"]["index"].tolist() == \
        np.asarray(jstate["kv"]["index"]).reshape(-1).tolist() == lens
    for plane in ("k", "v"):
        got = state["kv"][plane].numpy()                 # (L, n, W, kv, hd)
        want = np.asarray(jstate["kv"][plane])[:, :, 0]   # (n, L, W, ...)
        np.testing.assert_allclose(got, np.moveaxis(want, 0, 1),
                                   rtol=F32_TOL, atol=F32_TOL)
    exact = make_prefill_into_cache(cfg)
    for i, p in enumerate(prompts):
        ref, _ = exact(params, api.init_decode_state(cfg, 1, width, "cpu"),
                       torch.from_numpy(p.astype(np.int64))[None])
        np.testing.assert_allclose(logits[i].numpy(), ref[0].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)


def _norm(x):
    return json.loads(json.dumps(x, default=float))


def test_bad_bucket_specs_fail_at_submit_as_in_jax():
    jcfg, cfg = _cfgs()
    js = JSession(JHydraConfig(**HC), profile=None)
    ps = Session(HydraConfig(**HC), device="cpu", profile=None)
    for kw, match in ((dict(bucket_sizes="pow2 "), "pow2"),
                      (dict(bucket_sizes=(0, 8)), "positive"),
                      (dict(max_seq=64, bucket_sizes=(8, 512)), "max_seq")):
        with pytest.raises(ValueError, match=match) as jerr:
            js.submit(JServeJob(jcfg, **kw))
        with pytest.raises(ValueError, match=match) as err:
            ps.submit(ServeJob(cfg, **kw))
        assert str(err.value) == str(jerr.value)
    assert ps.jobs() == js.jobs() == {}


def test_recurrent_serve_job_plans_warns_and_serves_as_jax():
    """ROADMAP Queue 3 fault 1: ``ServeJob(xlstm-350m, paged=True,
    bucket_sizes=(8, 16))`` plans with both fallbacks and their reasons in
    the meta, warns at engine construction and serves with no buckets
    (``test_api_session.py::
    test_plan_meta_records_backend_fallback_with_reason``)."""
    jcfg, cfg = _cfgs("xlstm-350m")
    js = JSession(JHydraConfig(**HC), profile=None)
    ps = Session(HydraConfig(**HC), device="cpu", profile=None)
    jsv = js.submit(JServeJob(jcfg, seed=1, capacity=2, max_seq=32,
                              paged=True, bucket_sizes=(8, 16)))
    sv = ps.submit(ServeJob(cfg, seed=1, capacity=2, max_seq=32,
                            paged=True, bucket_sizes=(8, 16)))
    assert sv == jsv
    meta, jmeta = ps.plan().job(sv).meta, js.plan().job(jsv).meta
    assert _norm(meta) == _norm(jmeta)
    assert meta["requested_backend"] == "paged"
    assert meta["backend"] == "slot" and not meta["paged"]
    assert "nothing to page" in meta["capability_fallbacks"]["backend"]
    assert "rewound" in meta["capability_fallbacks"]["bucket_sizes"]
    assert meta["bucket_sizes"] is None
    st = ps.poll(sv)
    assert st["backend"] == "slot" and st["requested_backend"] == "paged"
    with pytest.warns(CapabilityFallbackWarning) as w:
        eng = ps.engine(sv)
    with pytest.warns(JCapabilityFallbackWarning) as jw:
        jeng = js.engine(jsv)
    assert sorted(str(x.message) for x in w) == \
        sorted(str(x.message) for x in jw)
    assert eng.bucket_sizes is None and ps.poll(sv)["backend"] == "slot"
    prompt = _prompt(cfg.vocab_size, 3, 7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no second warning at serve
        r = ps.submit_request(sv, prompt, 4)
        ps.drain_serving()
    jr = js.submit_request(jsv, prompt, 4)
    js.drain_serving()
    assert len(r.generated) == 4
    assert jeng.summary()["bucket_sizes"] is eng.summary()["bucket_sizes"]


@pytest.mark.parametrize("spec", [(8, 16, 32), "pow2"])
def test_bucketed_serve_job_matches_jax(spec):
    """A dense paged ``ServeJob`` with buckets: plan meta, prefill calls,
    tokens and summary equal to the JAX session's."""
    jcfg, cfg = _cfgs()
    jparams, params = _params()
    js = JSession(JHydraConfig(**HC), profile=None)
    ps = Session(HydraConfig(**HC), device="cpu", profile=None)
    for sess, Serve, c, p in ((js, JServeJob, jcfg, jparams),
                              (ps, ServeJob, cfg, params)):
        sess.submit(Serve(c, params=p, name="m", capacity=3, max_seq=48,
                          backend="paged", block_size=8, bucket_sizes=spec))
    assert _norm(ps.plan().job("serve-0").meta) == \
        _norm(js.plan().job("serve-0").meta)
    prompts = [_prompt(cfg.vocab_size, 60 + i, n)
               for i, n in enumerate([3, 6, 7, 12, 30])]
    jreqs = [js.submit_request("m", q, 5) for q in prompts]
    reqs = [ps.submit_request("m", q, 5) for q in prompts]
    js.drain_serving()
    ps.drain_serving()
    assert [list(map(int, r.generated)) for r in reqs] == \
        [list(map(int, r.generated)) for r in jreqs]
    s, jsum = ps.engine("serve-0").summary(), js.engine("serve-0").summary()
    for key in ("bucket_sizes", "prefill_calls", "decode_steps",
                "kv_peak_bytes", "kv_page_peak_bytes"):
        assert s[key] == jsum[key], key
    assert s["bucket_sizes"] is not None
