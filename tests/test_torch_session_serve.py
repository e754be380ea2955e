"""The serve half of the port's ``Session`` against the JAX package's.

Both packages get the same ``float32`` smoke configs and the same weights
(a JAX init bridged through ``params_from_numpy``), ``profile=None``, and
pinned unit runtimes (``fixed_unit_runtime``, no pilot), so every
decision is reproducible and must be the same, not just close:

* one mixed session — a TrainJob, a paged ServeJob on the session's
  ledger, a cold slot ServeJob, a ServeJob serving the TrainJob's weights
  (``params_from``) and an EvalJob — under ``scheduler="random"`` (the
  serve pick then reads no measured time): plan meta, the memory split,
  partitions, the unit trace, the serve trace, serve records, token
  streams and ``poll`` equal; losses at 2e-4 (the matmul-chain tolerance
  of ``tests/test_kernel_oracles.py``); the shared ledger back at 0;
* cold promotion (``promoted`` false until the first request, then the
  JAX ``promote_bytes``), a private vs the shared ledger, the effective
  backend and the fallback reason, draft ``"auto"`` with an explicit
  draft, ``verify_impl`` spellings, cancels (queue, routing name, the
  ledger back at 0), submit-time validation, and the tiering fields of
  ROADMAP item 5 (``residency="shard"``, ``hot_bytes``, ``tiered_kv``)
  planning as in the JAX session.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import EvalJob as JEvalJob
from repro.api import ServeJob as JServeJob
from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro_torch.api import (EvalJob, HydraConfig, Plan, ServeJob, Session,
                             TrainJob)
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.registry import CapabilityFallbackWarning

MM_TOL = 2e-4
BUDGET = 18 * 10**6
SEQ = 64
GEN = 5
HC = dict(n_devices=2, device_budget_bytes=BUDGET, pilot=False,
          fixed_unit_runtime=1e-3)


@functools.lru_cache(maxsize=None)
def _cfgs(arch="qwen3-0.6b"):
    jcfg = jget_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    if arch == "qwen3-0.6b":
        jcfg = jcfg.replace(kv_cache_dtype="float32")
        cfg = cfg.replace(kv_cache_dtype="float32")
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params(seed, arch="qwen3-0.6b"):
    jcfg, _ = _cfgs(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _loaders(vocab, seed):
    kw = dict(batch_size=2, seq_len=SEQ, vocab_size=vocab, seed=seed)
    return JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(
        DataConfig(**kw))


def _prompts(vocab, n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(plen), dtype=np.int32)
            for plen in rng.integers(4, 13, n)]


def _sessions(**hc):
    kw = dict(HC, **hc)
    return (JSession(JHydraConfig(**kw), profile=None),
            Session(HydraConfig(**kw), device="cpu", profile=None))


def _both(js, ps, make, seed=None):
    """Submit one job to each session: ``make(cfg, params, is_jax)``
    builds the job for either package."""
    jcfg, cfg = _cfgs()
    out = []
    for sess, c, is_jax in ((js, jcfg, True), (ps, cfg, False)):
        job = make(c, None if seed is None
                   else _params(seed)[0 if is_jax else 1], is_jax)
        out.append(sess.submit(job))
    assert out[0] == out[1]
    return out[0]


def _norm(x):
    """JSON-normalized (tuples -> lists, numpy scalars -> numbers)."""
    return json.loads(json.dumps(x, default=float))


def _tokens(reqs):
    return [list(map(int, r.generated)) for r in reqs]


# ---------------------------------------------------------------------------
# one mixed train + serve + eval session, both packages
# ---------------------------------------------------------------------------

SUMMARY_KEYS = ("backend", "requested_backend", "paged", "capacity",
                "max_seq", "policy", "n_completed", "decode_steps",
                "prefill_calls", "peak_concurrency", "kv_budget_bytes",
                "kv_reserved_bytes", "kv_peak_bytes", "slot_bytes",
                "block_bytes", "kv_page_peak_bytes", "n_blocks",
                "shared_block_hits", "cow_copies", "prefix_share",
                "kv_dtype", "bucket_sizes", "cold", "promote_bytes")


@pytest.fixture(scope="module")
def mixed():
    jcfg, cfg = _cfgs()
    js, ps = _sessions(scheduler="random")
    spies = {"jax": [], "torch": []}

    def early_stop(key, sess):
        def stop(losses):
            # runs at each minibatch boundary, i.e. strictly in training
            spies[key].append((len(sess.unit_trace), len(sess.serve_trace)))
            return False
        return stop

    for sess, c, key, Train, Serve, Eval, idx in (
            (js, jcfg, "jax", JTrainJob, JServeJob, JEvalJob, 0),
            (ps, cfg, "torch", TrainJob, ServeJob, EvalJob, 1)):
        tl = _loaders(c.vocab_size, 0)[idx]
        el = _loaders(c.vocab_size, 9)[idx]
        sess.submit(Train(c, tl, lr=1e-3, epochs=1, steps_per_epoch=2,
                          params=_params(0)[idx], seed=0, batch=2, seq=SEQ,
                          early_stop=early_stop(key, sess)))
        sess.submit(Serve(c, params=_params(1)[idx], name="hot",
                          capacity=2, max_seq=32, backend="paged",
                          block_size=8))
        sess.submit(Serve(c, params=_params(2)[idx], name="cold",
                          capacity=2, max_seq=32, cold=True))
        sess.submit(Serve(c, name="trained", capacity=2, max_seq=32,
                          params_from="train-0"))
        sess.submit(Eval(c, el, n_batches=1, params=_params(3)[idx],
                         batch=2, seq=SEQ))
    out = {"js": js, "ps": ps, "spies": spies}
    out["jplan"], out["plan"] = js.plan(), ps.plan()
    out["poll_before"] = (js.poll("serve-1"), ps.poll("serve-1"))
    prompts = _prompts(cfg.vocab_size)
    out["jreqs"], out["reqs"] = [], []
    for name in ("hot", "cold"):
        for p in prompts:
            out["jreqs"].append(js.submit_request(name, p, GEN))
            out["reqs"].append(ps.submit_request(name, p, GEN))
    out["jrep"] = js.run(out["jplan"])
    out["rep"] = ps.run(Plan.from_json(out["plan"].to_json()))
    # the trained weights are served after training, through the same
    # session (params_from promotes out of the train job's host store)
    out["jtrained"] = [js.submit_request("trained", p, GEN) for p in prompts]
    out["trained"] = [ps.submit_request("trained", p, GEN) for p in prompts]
    js.drain_serving()
    ps.drain_serving()
    return out


def test_mixed_plan_matches_jax_and_round_trips(mixed):
    jplan, plan = mixed["jplan"], mixed["plan"]
    assert [j.job_id for j in plan.jobs] == [j.job_id for j in jplan.jobs] \
        == ["train-0", "serve-0", "serve-1", "serve-2", "eval-0"]
    for j, p in zip(jplan.jobs, plan.jobs):
        assert (p.kind, p.partition, p.host_bytes, p.max_shard_bytes) == \
            (j.kind, j.partition, j.host_bytes, j.max_shard_bytes), p.job_id
        assert _norm(p.meta) == _norm(j.meta), p.job_id
    mem = plan.schedule["memory"]
    assert mem == jplan.schedule["memory"]
    hot = plan.job("serve-0").meta
    assert hot["backend"] == "paged" and hot["shared_ledger"]
    assert mem["serve_kv_page_cap_bytes"] == hot["kv_page_cap_bytes"] > 0
    assert plan.job("train-0").partition["budget_bytes"] == \
        BUDGET - mem["serve_kv_page_cap_bytes"]
    assert plan.job("serve-1").meta["cold"] is True
    assert plan.job("serve-1").partition is not None
    assert plan.job("serve-2").meta["params_from"] == "train-0"
    assert plan.schedule["est_makespan_s"] == jplan.schedule["est_makespan_s"]
    assert Plan.from_json(plan.to_json()).to_json() == plan.to_json()


def test_mixed_run_matches_jax(mixed):
    jrep, rep = mixed["jrep"], mixed["rep"]
    assert rep.unit_trace == jrep.unit_trace
    np.testing.assert_allclose(rep.train.losses[0], jrep.train.losses[0],
                               rtol=MM_TOL, atol=MM_TOL)
    np.testing.assert_allclose(rep.evals["eval-0"]["losses"],
                               jrep.evals["eval-0"]["losses"],
                               rtol=MM_TOL, atol=MM_TOL)
    # a random pick reads no measured time: the serve trace is the JAX one
    assert rep.serve_trace == jrep.serve_trace
    assert set(rep.serve_trace) == {"hot", "cold"}
    assert _tokens(mixed["reqs"]) == _tokens(mixed["jreqs"])
    assert all(len(t) == GEN for t in _tokens(mixed["reqs"]))
    for jid in ("serve-0", "serve-1"):
        j, p = jrep.serve[jid], rep.serve[jid]
        assert {k: p.get(k) for k in SUMMARY_KEYS} == \
            {k: j.get(k) for k in SUMMARY_KEYS}, jid
        assert [r["n_generated"] for r in p["requests"]] == \
            [r["n_generated"] for r in j["requests"]]
    # serve-2 had no request during run(): reported, never promoted
    assert rep.serve["serve-2"] == jrep.serve["serve-2"] == {
        "cold": True, "promote_bytes": 0, "promote_s": 0.0,
        "promoted": False}


def test_serve_ticks_fall_between_train_and_eval_units(mixed):
    spies = mixed["spies"]
    assert spies["torch"] == spies["jax"]
    # some minibatch boundary saw units done AND serve ticks taken
    assert any(u > 0 and t > 0 for u, t in spies["torch"])
    rep = mixed["rep"]
    n_train = rep.train.units_executed
    assert len(rep.unit_trace) == n_train
    # a tick after every train unit, then one after every eval shard
    assert len(rep.serve_trace) >= n_train


def test_params_from_serves_the_trained_weights(mixed):
    assert _tokens(mixed["trained"]) == _tokens(mixed["jtrained"])
    ps = mixed["ps"]
    st = ps.poll("serve-2")
    assert st["cold"] and st["promoted"] and st["n_completed"] == 3
    eng = ps.engine("trained")
    trained = ps.train_execs[0].store.model_params()
    for k in ("embed", "final_norm"):
        np.testing.assert_array_equal(
            eng.params[k][next(iter(eng.params[k]))].numpy(),
            trained[k][next(iter(trained[k]))].numpy())


def test_mixed_poll_and_ledger_match_jax(mixed):
    js, ps = mixed["js"], mixed["ps"]
    jbefore, before = mixed["poll_before"]
    assert before == jbefore and before["promoted"] is False
    timing = {"recent_requests"}
    for jid in ("train-0", "serve-0", "serve-1", "serve-2", "eval-0"):
        j, p = js.poll(jid), ps.poll(jid)
        assert {k: v for k, v in p.items() if k not in timing} == \
            {k: v for k, v in j.items() if k not in timing}, jid
        if "recent_requests" in p:
            assert [r["n_generated"] for r in p["recent_requests"]] == \
                [r["n_generated"] for r in j["recent_requests"]]
    assert ps.poll("serve-0")["capabilities"] == \
        js.poll("serve-0")["capabilities"]
    dm, jdm = ps.devices[0], js.devices[0]
    assert dm.kv_reserved_bytes == jdm.kv_reserved_bytes == 0
    assert dm.kv_peak_bytes == jdm.kv_peak_bytes > 0
    assert dm.kv_peak_bytes <= mixed["plan"].schedule["memory"][
        "serve_kv_page_cap_bytes"]
    assert ps.engine("hot").ledger is dm


# ---------------------------------------------------------------------------
# serve-only sessions (no training)
# ---------------------------------------------------------------------------

def test_cold_serve_promotes_on_first_request():
    js, ps = _sessions(n_devices=1, device_budget_bytes=10 * 10**6)
    sj = _both(js, ps, lambda c, p, j: (JServeJob if j else ServeJob)(
        c, params=p, capacity=2, max_seq=32, cold=True), seed=5)
    for s in (js, ps):
        assert s.poll(sj)["status"] == "pending"
    jplan, plan = js.plan(), ps.plan()
    assert plan.job(sj).partition == jplan.job(sj).partition is not None
    assert ps.poll(sj)["promoted"] is False
    prompt = _prompts(_cfgs()[1].vocab_size, 1)[0]
    jreq = js.submit_request(sj, prompt, GEN)
    req = ps.submit_request(sj, prompt, GEN)      # promotion happens here
    assert ps.poll(sj)["promoted"] is True
    jrec, rec = js.run().serve[sj], ps.run(plan).serve[sj]
    assert req.generated == jreq.generated
    assert rec["cold"] and rec["promote_bytes"] == jrec["promote_bytes"] > 0
    assert rec["promote_s"] >= 0.0


def test_shared_vs_private_ledger():
    js, ps = _sessions()
    shared = _both(js, ps, lambda c, p, j: (JServeJob if j else ServeJob)(
        c, seed=1, name="s", capacity=2, max_seq=32, paged=True,
        block_size=8))
    private = _both(js, ps, lambda c, p, j: (JServeJob if j else ServeJob)(
        c, seed=1, name="p", capacity=2, max_seq=32, paged=True,
        block_size=8, kv_budget_bytes=64 * 1024))
    jplan, plan = js.plan(), ps.plan()
    for jid in (shared, private):
        assert _norm(plan.job(jid).meta) == _norm(jplan.job(jid).meta)
    assert plan.job(shared).meta["shared_ledger"]
    assert not plan.job(private).meta["shared_ledger"]
    # only the shared job's pages are carved out of the device budget
    assert plan.schedule["memory"] == jplan.schedule["memory"]
    assert plan.schedule["memory"]["serve_kv_page_cap_bytes"] == \
        plan.job(shared).meta["kv_page_cap_bytes"]
    assert ps.engine("s").ledger is ps.devices[0]
    eng = ps.engine("p")
    assert eng.ledger is not ps.devices[0]
    assert eng.budget.budget_bytes == 64 * 1024


def test_effective_backend_and_fallback_reason_in_meta():
    jcfg, cfg = _cfgs("xlstm-350m")
    js, ps = _sessions()
    for sess, c, Serve in ((js, jcfg, JServeJob), (ps, cfg, ServeJob)):
        sess.submit(Serve(c, seed=1, capacity=2, max_seq=32, paged=True))
    jplan, plan = js.plan(), ps.plan()
    assert _norm(plan.job("serve-0").meta) == _norm(jplan.job("serve-0").meta)
    assert ps.poll("serve-0") == js.poll("serve-0")
    meta = plan.job("serve-0").meta
    assert meta["requested_backend"] == "paged"
    assert meta["backend"] == "slot" and not meta["paged"]
    assert "nothing to page" in meta["capability_fallbacks"]["backend"]
    assert meta["capabilities"]["paging"] is False
    with pytest.warns(CapabilityFallbackWarning):
        ps.engine("serve-0")
    assert ps.poll("serve-0")["backend"] == "slot"
    # every ported family's capability record is the JAX one
    from repro.models.registry import spec as jspec
    from repro_torch.models.registry import spec as pspec
    for fam in ("dense", "ssm", "hybrid"):
        assert pspec(fam).capabilities() == jspec(fam).capabilities(), fam


def _bad_specs(c):
    return [
        (dict(backend="mmap"), ValueError, "known decode backends"),
        (dict(backend="slot", paged=True), ValueError, "conflicting spec"),
        (dict(policy="edf"), ValueError, "known admission policies"),
        (dict(slo_aging_s=0), ValueError, "aging"),
        (dict(priority="urgent"), ValueError, "priority"),
        (dict(bucket_sizes="pow2 "), ValueError, "pow2"),
        (dict(bucket_sizes=(0, 8)), ValueError, "positive"),
        (dict(max_seq=64, bucket_sizes=(8, 512)), ValueError, "max_seq"),
        (dict(backend="spec"), ValueError, "draft member model"),
        (dict(kv_dtype="int8"), ValueError, "paged block pool"),
        (dict(residency="shard"), ValueError, "cold=True"),
        (dict(params_from="train-9"), ValueError, "not a TrainJob"),
    ]


def test_bad_serve_specs_fail_at_submit_as_in_jax():
    jcfg, cfg = _cfgs()
    js, ps = _sessions()
    for (kw, exc, match), (jkw, _, _) in zip(_bad_specs(cfg),
                                             _bad_specs(jcfg)):
        with pytest.raises(exc, match=match) as jerr:
            js.submit(JServeJob(jcfg, **jkw))
        with pytest.raises(exc, match=match) as err:
            ps.submit(ServeJob(cfg, **kw))
        assert str(err.value) == str(jerr.value), kw
    assert ps.jobs() == js.jobs() == {}      # nothing half-registered
    for sess, Serve, c in ((js, JServeJob, jcfg), (ps, ServeJob, cfg)):
        sess.submit(Serve(c, seed=0))
        with pytest.raises(ValueError, match="routing name"):
            sess.submit(Serve(c, seed=1))
        sess.submit(Serve(c, seed=1, name="replica-b"))
    assert sorted(ps.jobs()) == sorted(js.jobs()) == ["serve-0", "serve-1"]


@pytest.mark.parametrize("kw,item", [
    (dict(cold=True, residency="shard"), "residency"),
    (dict(cold=True, residency="shard", hot_bytes=0), "hot_bytes"),
    (dict(backend="paged", tiered_kv=True), "tiered_kv"),
], ids=["shard", "hot-bytes", "tiered-kv"])
def test_unported_serve_fields_raise_naming_their_item(kw, item):
    """ROADMAP item 5's fields, ported: the job submits and plans with
    the JAX session's meta (its partition too, for a cold job), the
    field ``item`` carried in it."""
    jcfg, cfg = _cfgs()
    js, ps = _sessions()
    jid = js.submit(JServeJob(jcfg, seed=0, **kw))
    assert ps.submit(ServeJob(cfg, seed=0, **kw)) == jid
    jplan, plan = js.plan(), ps.plan()
    j, p = jplan.job(jid), plan.job(jid)
    assert _norm(p.meta) == _norm(j.meta)
    assert (p.partition, p.host_bytes) == (j.partition, j.host_bytes)
    assert p.meta[item] == kw[item]


def test_cancelled_serve_job_drops_queue_and_frees_its_name():
    js, ps = _sessions()
    prompts = _prompts(_cfgs()[1].vocab_size, 2)
    runs = []
    for sess, Serve, c, idx in ((js, JServeJob, _cfgs()[0], 0),
                                (ps, ServeJob, _cfgs()[1], 1)):
        sj = sess.submit(Serve(c, params=_params(1)[idx], name="m",
                               capacity=1, max_seq=32))
        r1 = sess.submit_request("m", prompts[0], 3)
        r2 = sess.submit_request("m", prompts[1], 3)
        sess.serve_tick()                 # r1 admitted, r2 still queued
        sess.cancel(sj)
        assert r2.status.value == "cancelled" and r2.done
        sess.drain_serving()              # in-flight r1 finishes
        assert r1.status.value == "finished" and len(r1.generated) == 3
        s1 = sess.submit(Serve(c, params=_params(2)[idx], name="m"))
        r3 = sess.submit_request("m", prompts[0], 2)   # the freed name
        sess.drain_serving()
        assert r3.done and sess.poll(s1)["n_completed"] == 1
        runs.append(_tokens([r1, r3]))
    assert runs[0] == runs[1]


def test_ledger_returns_to_zero_after_cancels():
    js, ps = _sessions()
    prompts = _prompts(_cfgs()[1].vocab_size, 3)
    for sess, Serve, c, idx in ((js, JServeJob, _cfgs()[0], 0),
                                (ps, ServeJob, _cfgs()[1], 1)):
        sj = sess.submit(Serve(c, params=_params(1)[idx], capacity=2,
                               max_seq=32, backend="paged", block_size=8))
        reqs = [sess.submit_request(sj, p, 8, request_id=f"q{i}")
                for i, p in enumerate(prompts)]
        sess.serve_tick()
        sess.serve_tick()
        assert sess.devices[0].kv_reserved_bytes > 0
        assert sess.cancel_request("q0")          # running
        assert sess.cancel_request("q2", target=sj)   # queued
        sess.drain_serving()
        assert [r.status.value for r in reqs] == \
            ["cancelled", "finished", "cancelled"]
        assert sess.devices[0].kv_reserved_bytes == 0
        assert sess.engine(sj).pool.n_free == \
            sess.engine(sj).pool.n_allocatable
    assert js.devices[0].kv_peak_bytes == ps.devices[0].kv_peak_bytes


def test_draft_auto_with_explicit_draft_matches_jax():
    js, ps = _sessions()
    prompts = _prompts(_cfgs()[1].vocab_size, 2)
    toks = []
    for sess, Serve, c, idx in ((js, JServeJob, _cfgs()[0], 0),
                                (ps, ServeJob, _cfgs()[1], 1)):
        sj = sess.submit(Serve(c, params=_params(1)[idx], capacity=2,
                               max_seq=48, backend="spec", draft_model=c,
                               draft_params=_params(1)[idx], draft_k="auto",
                               spec_inner="paged", block_size=8))
        reqs = [sess.submit_request(sj, p, 6) for p in prompts]
        sess.drain_serving()
        toks.append(_tokens(reqs))
    jmeta, meta = js.plan().job("serve-0").meta, ps.plan().job("serve-0").meta
    assert _norm(meta) == _norm(jmeta)
    assert meta["draft_auto"]["source"] == "analytic"
    assert meta["draft_k"] == ps.jobs()["serve-0"].draft_k == \
        meta["draft_auto"]["draft_k"]
    assert toks[0] == toks[1]
    # a self-draft accepts every proposal
    assert ps.engine("serve-0").summary()["draft_accept_rate"] == 1.0


def test_verify_impl_spellings():
    cfg = _cfgs()[1]
    ps = Session(HydraConfig(**HC), device="cpu", profile=None)
    spec = dict(capacity=2, max_seq=32, backend="spec", draft_model=cfg,
                spec_inner="paged", block_size=8)
    a = ps.submit(ServeJob(cfg, seed=1, name="a", verify_impl="pallas",
                           **spec))
    b = ps.submit(ServeJob(cfg, seed=1, name="b", verify_impl="jnp", **spec))
    c = ps.submit(ServeJob(cfg, seed=1, name="c", verify_impl="ref", **spec))
    assert ps.engine(a).backend.verify_impl == "cuda"
    assert ps.engine(b).backend.verify_impl == "ref"
    assert ps.engine(c).backend.verify_impl == "ref"
    with pytest.raises(ValueError, match="'cuda'.*'ref'"):
        ps.submit(ServeJob(cfg, name="d", verify_impl="pallas_interpret",
                           **spec))
    with pytest.raises(ValueError, match="verify_impl selects"):
        ps.submit(ServeJob(cfg, name="e", verify_impl="pallas"))
    # the plain verify path serves the JAX engine's tokens
    js = JSession(JHydraConfig(**HC), profile=None)
    jcfg = _cfgs()[0]
    jspec = dict(spec, draft_model=jcfg)
    jb = js.submit(JServeJob(jcfg, params=_params(1)[0], **jspec))
    pb = ps.submit(ServeJob(cfg, params=_params(1)[1], name="f",
                            verify_impl="jnp", **spec))
    prompts = _prompts(cfg.vocab_size, 2)
    jr = [js.submit_request(jb, p, 6) for p in prompts]
    pr = [ps.submit_request(pb, p, 6) for p in prompts]
    js.drain_serving()
    ps.drain_serving()
    assert _tokens(pr) == _tokens(jr)


def test_engine_takes_a_backend_instance():
    from repro_torch.serving.backends import PagedBackend, SlotBackend
    from repro_torch.serving.engine import InferenceEngine
    cfg = _cfgs()[1]
    params = _params(1)[1]
    backend = PagedBackend(cfg, 2, 32, block_size=8, device="cpu")
    eng = InferenceEngine(cfg, params, capacity=2, max_seq=32,
                          backend=backend, device="cpu")
    assert eng.backend is backend and eng.requested_backend == "paged"
    ref = InferenceEngine(cfg, params, capacity=2, max_seq=32,
                          backend="paged", block_size=8, device="cpu")
    prompts = _prompts(cfg.vocab_size, 3)
    for e in (eng, ref):
        for p in prompts:
            e.submit(p, 4)
        e.run()
    assert [r.generated for r in eng.completed] == \
        [r.generated for r in ref.completed]
    with pytest.raises(ValueError, match="max_seq"):
        InferenceEngine(cfg, params, capacity=2, max_seq=64,
                        backend=PagedBackend(cfg, 2, 32, device="cpu"),
                        device="cpu")
    with pytest.raises(ValueError, match="conflicting"):
        InferenceEngine(cfg, params, capacity=2, max_seq=32, paged=True,
                        backend=SlotBackend(cfg, 2, 32, device="cpu"),
                        device="cpu")
    with pytest.raises(TypeError, match="DecodeBackend"):
        InferenceEngine(cfg, params, backend=object(), device="cpu")
