"""The port's ``MultiModelServer`` against the JAX package's.

Both routers get engines of the same ``float32`` smoke models built from
the same weights (a JAX init bridged through ``params_from_numpy``), fed
the same requests in the same order:

* the reference's multi-model scenarios that the port's engine could not
  run without a router — the deterministic LRTF tie-break, the
  ``scheduler="slo"`` urgency pre-pass (``tests/test_slo.py``), bounded
  retention with ``trace_cap`` / ``completed_cap`` and drain-on-read, and
  ``run()`` returning only new completions (``tests/test_cancel.py``) —
  give the same picks and completions;
* ``test_multi_model_lrtf_serves_all_and_stays_identical``
  (``tests/test_serving.py``, which fails in bf16 in the reference) in
  f32: a dense and a recurrent model served together give the token
  streams each request gets alone, and the JAX router's;
* two paged engines on one ``DeviceMemory`` report it as the shared
  ledger; a private ledger is not.

LRTF reads each engine's measured step time, so a schedule is compared
across packages only where no measured time decides it: under
``scheduler="random"`` with a seed, or where the remaining work differs
before the first step.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.scheduler import get_scheduler as jget_scheduler
from repro.core.spilling import DeviceMemory as JDeviceMemory
from repro.models import api as japi
from repro.serving import InferenceEngine as JEngine
from repro.serving import MultiModelServer as JServer
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.scheduler import get_scheduler
from repro_torch.core.spilling import DeviceMemory
from repro_torch.serving import InferenceEngine, MultiModelServer

MAX_SEQ = 48


@functools.lru_cache(maxsize=None)
def _model(arch, seed=0):
    """(jax cfg, jax params, port cfg, port params), f32."""
    jcfg = jget_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    if arch == "qwen3-0.6b":
        jcfg = jcfg.replace(kv_cache_dtype="float32")
        cfg = cfg.replace(kv_cache_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _prompt(vocab, seed, plen=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, plen).astype(np.int32)


def _engines(names, arch="qwen3-0.6b", **kw):
    """The same engines in both packages: ({name: jax}, {name: port})."""
    jcfg, jparams, cfg, params = _model(arch)
    kw.setdefault("capacity", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    return ({n: JEngine(jcfg, jparams, model_name=n, **kw) for n in names},
            {n: InferenceEngine(cfg, params, model_name=n, device="cpu",
                                **kw) for n in names})


def _both(names, router_kw=None, **kw):
    je, pe = _engines(names, **kw)
    router_kw = router_kw or {}
    return JServer(je, **router_kw), MultiModelServer(pe, **router_kw)


def _tokens(reqs):
    return [list(map(int, r.generated)) for r in reqs]


def test_lrtf_tie_break_is_deterministic():
    vocab = _model("qwen3-0.6b")[2].vocab_size
    for srv in _both(["b", "a"], backend="slot"):
        # adversarial dict order: "b" inserted first must not win the tie
        srv.engines["a"].submit(_prompt(vocab, 1), 4)
        srv.engines["b"].submit(_prompt(vocab, 1), 4)
        assert srv.step() == "a"


def test_slo_routing_prefers_urgent_engine():
    vocab = _model("qwen3-0.6b")[2].vocab_size
    traces = []
    for srv in _both(["bulk", "urgent"], router_kw={"scheduler": "slo"},
                     backend="slot"):
        srv.engines["bulk"].submit(_prompt(vocab, 1), 20)    # LRTF's pick
        srv.engines["urgent"].submit(_prompt(vocab, 2), 2, deadline_ms=1.0)
        assert srv.step() == "urgent"    # slack < margin wins over work
        # without deadline pressure the router IS lrtf: bulk has more work
        srv.engines["urgent"].cancel_all_queued()
        srv.step()
        assert srv.schedule_trace[-1] == "bulk"
        traces.append(list(srv.schedule_trace))
    assert traces[0] == traces[1]


def test_completed_cap_and_trace_cap_bound_retention():
    vocab = _model("qwen3-0.6b")[2].vocab_size
    drained = []
    for srv in _both(["m"], router_kw={"trace_cap": 16}, capacity=4,
                     completed_cap=8):
        eng = srv.engines["m"]
        n = 30
        for i in range(n):
            srv.submit("m", _prompt(vocab, 100 + i, plen=4), 1)
        srv.run()
        # retention stays bounded while the monotonic counters keep the
        # truth
        assert len(eng.completed) <= 8
        assert len(srv.schedule_trace) <= 16
        assert eng.retired_total == eng.summary()["n_completed"] == n
        out = srv.drain_completed()["m"]
        assert 0 < len(out) <= 8
        assert srv.drain_completed()["m"] == []     # drain-on-read: empty
        drained.append(_tokens(out))
    assert drained[0] == drained[1]


def test_repeated_run_returns_only_new_completions():
    vocab = _model("qwen3-0.6b")[2].vocab_size
    for srv in _both(["m"]):
        a = srv.submit("m", _prompt(vocab, 20), 2, request_id="a")
        b = srv.submit("m", _prompt(vocab, 21), 2, request_id="b")
        first = srv.run()["m"]
        assert sorted(r.request_id for r in first) == \
            sorted([a.request_id, b.request_id])
        c = srv.submit("m", _prompt(vocab, 22), 2, request_id="c")
        second = srv.run()["m"]
        assert [r.request_id for r in second] == [c.request_id]
        assert srv.run() == {"m": []}               # idle run: nothing new
        assert srv.cancel("nope") is False


def _alone(cfg, params, prompt, gen):
    eng = InferenceEngine(cfg, params, capacity=1, max_seq=MAX_SEQ,
                          device="cpu")
    req = eng.submit(prompt, gen)
    eng.run()
    return list(map(int, req.generated))


def test_multi_model_lrtf_serves_all_and_stays_identical():
    """The reference's case in f32: a dense and a recurrent model behind
    one LRTF router, every request token-identical to its engine alone
    and to the JAX router's."""
    jq, jqp, q, qp = _model("qwen3-0.6b")
    jx, jxp, x, xp = _model("xlstm-350m")
    servers = (
        JServer({"qwen": JEngine(jq, jqp, capacity=2, max_seq=MAX_SEQ,
                                 model_name="qwen"),
                 "xlstm": JEngine(jx, jxp, capacity=2, max_seq=MAX_SEQ,
                                  model_name="xlstm")}),
        MultiModelServer({
            "qwen": InferenceEngine(q, qp, capacity=2, max_seq=MAX_SEQ,
                                    model_name="qwen", device="cpu"),
            "xlstm": InferenceEngine(x, xp, capacity=2, max_seq=MAX_SEQ,
                                     model_name="xlstm", device="cpu")}))
    toks = []
    for srv in servers:
        subs = []
        for i in range(3):
            pa, pb = _prompt(q.vocab_size, 200 + i), \
                _prompt(x.vocab_size, 300 + i)
            subs.append((q, qp, pa, 6, srv.submit("qwen", pa, 6)))
            subs.append((x, xp, pb, 4, srv.submit("xlstm", pb, 4)))
        out = srv.run()
        assert len(out["qwen"]) == 3 and len(out["xlstm"]) == 3
        assert set(srv.schedule_trace) == {"qwen", "xlstm"}
        toks.append(_tokens([s[-1] for s in subs]))
    assert toks[0] == toks[1]
    assert toks[1] == [_alone(cfg, params, prompt, gen)
                       for cfg, params, prompt, gen, _ in subs]


def test_random_routing_schedule_matches_jax():
    """A seeded random pick reads no measured time: the whole schedule of
    two paged engines on one shared ledger equals the JAX router's, and
    the ledger returns to 0."""
    jcfg, jparams, cfg, params = _model("qwen3-0.6b")
    jled, led = JDeviceMemory(0, 4 * 10**6), DeviceMemory(0, 4 * 10**6)
    kw = dict(capacity=2, max_seq=MAX_SEQ, backend="paged", block_size=8)
    jsrv = JServer({n: JEngine(jcfg, jparams, model_name=n, ledger=jled,
                               **kw) for n in ("x", "y")},
                   scheduler=jget_scheduler("random", seed=3))
    srv = MultiModelServer(
        {n: InferenceEngine(cfg, params, model_name=n, ledger=led,
                            device="cpu", **kw) for n in ("x", "y")},
        scheduler=get_scheduler("random", seed=3))
    toks = []
    for s in (jsrv, srv):
        reqs = [s.submit(n, _prompt(cfg.vocab_size, 40 + i, 5 + i), 4 + i)
                for i in range(3) for n in ("x", "y")]
        s.run()
        toks.append(_tokens(reqs))
        assert s.shared_ledger() is not None
        summ = s.summary()["device_memory"]
        assert summ["kv_reserved_bytes"] == 0 < summ["kv_peak_bytes"]
    assert list(srv.schedule_trace) == list(jsrv.schedule_trace)
    assert toks[0] == toks[1]
    assert srv.summary()["device_memory"] == jsrv.summary()["device_memory"]


def test_private_ledgers_are_not_shared():
    for srv in _both(["x", "y"], backend="paged", block_size=8):
        assert srv.shared_ledger() is None
        assert "device_memory" not in srv.summary()
    _, pe = _engines(["solo"], backend="paged", block_size=8)
    assert MultiModelServer(pe).shared_ledger() is None
    with pytest.raises(ValueError, match="at least one engine"):
        MultiModelServer({})
