"""Tiered memory in the port against the JAX package: the cases of
``tests/test_tiering.py``, each run on both packages side by side.

Both get the same ``float32`` qwen3-0.6b smoke config and the same
weights (a JAX init bridged through ``params_from_numpy``), so every
decision must be the same, not just close: blocks demoted and prefetched
after each step, the ledger's device and host terms, prefetch hits and
misses, parked states, hot shards, stream bytes, the LRU demotion order,
``summary()``, plan meta and ``poll`` gauges — and the tokens, which
must also equal decoding each prompt alone.  Timing keys of a summary
(rates, ``promote_s``) are not decisions and are left out; so is
``paged_impl``, whose values name each package's own kernels.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.api.jobs import ServeJob as JServeJob
from repro.api.jobs import TrainJob as JTrainJob
from repro.api.session import Session as JSession
from repro.configs import get_config as jget_config
from repro.core import partitioner as jpt
from repro.core import shard_graph as jsg
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.core.spilling import DeviceMemory as JDeviceMemory
from repro.core.spilling import HostModelStore as JHostModelStore
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.queue import PagedKVBudget as JPagedKVBudget
from repro.serving.residency import ResidencyCoordinator as JCoordinator
from repro.serving.residency import ShardResidentParams as JShardParams
from repro_torch.api import HydraConfig, ServeJob, Session, TrainJob
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.spilling import DeviceMemory, HostModelStore
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.queue import PagedKVBudget
from repro_torch.serving.request import Status
from repro_torch.serving.residency import (ResidencyCoordinator,
                                           ShardResidentParams)

MAX_SEQ = 64
TIMING = ("prefill_tok_per_s", "decode_tok_per_s", "promote_s", "paged_impl")


@functools.lru_cache(maxsize=None)
def _dense():
    """(jax cfg, jax params, port cfg, port params): same weights."""
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _side(is_jax):
    """The package-specific pieces of one side: cfg, params, engine,
    ledger and the engine's device keyword."""
    jcfg, jparams, cfg, params = _dense()
    if is_jax:
        return jcfg, jparams, JEngine, JDeviceMemory, {}
    return cfg, params, InferenceEngine, DeviceMemory, {"device": "cpu"}


def _prompt(vocab, seed, plen=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, plen).astype(np.int32)


def _paged(is_jax, *, capacity=2, policy="slo", ledger=None, tiered=False,
           prefetch_ticks=1, n_blocks=32, params=None):
    cfg, p, Eng, _, kw = _side(is_jax)
    return Eng(cfg, p if params is None else params, capacity=capacity,
               max_seq=MAX_SEQ, backend="paged", block_size=8,
               n_blocks=n_blocks, ledger=ledger, policy=policy,
               tiered_kv=tiered, prefetch_ticks=prefetch_ticks, **kw)


def _sequential(is_jax, prompts_gens, params=None):
    """Each prompt decoded alone: the token-identity oracle."""
    out = []
    eng = _paged(is_jax, capacity=1, policy="fifo", params=params)
    for prompt, gen in prompts_gens:
        r = eng.submit(prompt, gen)
        eng.run()
        out.append(list(map(int, r.generated)))
    return out


def _decisions(eng, ledger, reqs):
    """Everything a tick decided, as plain values."""
    be = eng.backend
    return (eng.n_preempted, eng.n_resumed, be.kv_demote_block_moves,
            be.kv_prefetch_block_moves, be.prefetch_hits,
            be.prefetch_misses, ledger.kv_reserved_bytes,
            ledger.host_kv_bytes, ledger.host_kv_peak_bytes,
            ledger.used_bytes(), be.host_pool.n_blocks,
            be.host_pool.peak_blocks, eng.pool.n_free,
            sorted(eng.pool.refcounts().items()),
            [(r.status.value, be.demoted_blocks(r),
              be.parked_state(r) if r.status.value == "preempted" else None)
             for r in reqs])


def _summary(s):
    return {k: v for k, v in s.items() if k not in TIMING}


def _assert_same_summary(js, ps):
    assert set(ps) - set(js) == {"device"}
    assert {k: ps[k] for k in js if k not in TIMING} == _summary(js)


def _assert_drained(eng, ledger):
    assert eng.budget.reserved_bytes == 0
    assert ledger.kv_reserved_bytes == 0
    assert ledger.host_kv_bytes == 0
    assert eng.backend.host_pool.n_blocks == 0
    assert eng.pool.n_free == eng.pool.n_allocatable
    assert eng.pool.refcounts() == {}


def _reconcile(eng, ledger):
    assert eng.backend.host_pool.used_bytes() == ledger.host_kv_bytes
    assert ledger.used_bytes() <= ledger.budget


def _preempt_scenario(is_jax, *, cancel_victim=False, **kw):
    """Two low-priority longs saturate both lanes; a high-priority short
    preempts one (its pages demote eagerly).  Returns the engine, its
    ledger, the requests and the per-step decision trace."""
    cfg = _side(is_jax)[0]
    ledger = _side(is_jax)[3](-1, budget_bytes=10**9)
    eng = _paged(is_jax, capacity=2, ledger=ledger, tiered=True, **kw)
    longs = [eng.submit(_prompt(cfg.vocab_size, i), 16, priority="low")
             for i in (1, 2)]
    for _ in range(3):
        eng.step()
    assert all(r.status.value == "running" for r in longs)
    short = eng.submit(_prompt(cfg.vocab_size, 3), 4, priority="high",
                       deadline_ms=60_000.0)
    eng.step()
    reqs = longs + [short]
    trace = [_decisions(eng, ledger, reqs)]
    victim = next(r for r in longs if r.status.value == "preempted")
    at_park = (eng.backend.parked_state(victim),
               eng.backend.demoted_blocks(victim),
               ledger.host_kv_bytes,
               eng.resume_cost_seconds(victim) / eng.tok_seconds_estimate(),
               [eng.resume_cost_seconds(r) for r in reqs
                if r.status.value == "running"])
    _reconcile(eng, ledger)
    if cancel_victim:
        assert eng.cancel(victim.request_id)
    while eng.step():
        _reconcile(eng, ledger)
        trace.append(_decisions(eng, ledger, reqs))
    return eng, ledger, reqs, victim, trace, at_park


def _both_preempt(**kw):
    j = _preempt_scenario(True, **kw)
    p = _preempt_scenario(False, **kw)
    assert p[4] == j[4]                      # every tick's decisions
    assert p[5] == j[5]                      # the victim at park time
    assert [r.generated for r in p[2]] == \
        [list(map(int, r.generated)) for r in j[2]]
    return j, p


def _oracle(vocab):
    return [(_prompt(vocab, 1), 16), (_prompt(vocab, 2), 16),
            (_prompt(vocab, 3), 4)]


# ---------------------------------------------------------------------------
# tiered KV: demote -> prefetch -> resume
# ---------------------------------------------------------------------------

def test_preempt_demotes_eagerly_and_resumes_identical():
    j, p = _both_preempt()
    eng, ledger, reqs, victim, trace, at_park = p
    assert eng.n_preempted >= 1
    state, demoted, host_bytes = at_park[:3]
    assert state == "demoted" and demoted > 0 and host_bytes > 0
    assert all(r.status is Status.FINISHED for r in reqs)
    ref = _sequential(False, _oracle(eng.cfg.vocab_size))
    assert [r.generated for r in reqs] == ref == \
        _sequential(True, _oracle(eng.cfg.vocab_size))
    s = eng.summary()
    assert s["tiered"] is True
    assert s["kv_demoted_bytes"] > 0
    assert s["kv_prefetched_bytes"] == s["kv_demoted_bytes"]
    _assert_same_summary(j[0].summary(), s)
    _assert_drained(eng, ledger)


def test_slow_prefetch_counts_misses_still_identical():
    j, p = _both_preempt(prefetch_ticks=3)
    eng, ledger, reqs = p[:3]
    assert all(r.status is Status.FINISHED for r in reqs)
    assert [r.generated for r in reqs] == \
        _sequential(False, _oracle(eng.cfg.vocab_size))
    s = eng.summary()
    assert s["prefetch_misses"] >= 1
    _assert_same_summary(j[0].summary(), s)
    _assert_drained(eng, ledger)


def test_cancel_while_demoted_settles_everything():
    j, p = _both_preempt(cancel_victim=True)
    eng, ledger, reqs, victim = p[:4]
    assert victim.status is Status.CANCELLED
    assert eng.n_resumed == 0
    _assert_same_summary(j[0].summary(), eng.summary())
    _assert_drained(eng, ledger)


def test_preempted_ttft_estimate_includes_resume_cost():
    """The demoted victim owes (prefetch_ticks + 1) pooled decode steps
    before its next token — in units of the per-token estimate, the same
    number in both packages — and a running request owes nothing."""
    j, p = _both_preempt()
    ratio, running = p[5][3:]
    assert ratio == j[5][3] == 2 * 2        # (1 + 1) ticks x 2 lanes
    assert running == [0.0, 0.0] == j[5][4]
    _assert_drained(p[0], p[1])


def test_untiered_engine_rejects_nothing_changes():
    for is_jax in (True, False):
        eng = _paged(is_jax, capacity=2,
                     ledger=_side(is_jax)[3](-1, budget_bytes=10**9))
        assert eng.backend.host_pool is None
        assert eng.backend.tiered is False
        assert "host_pool_blocks" not in eng.summary()
        assert eng._tiered is False and eng._demote_on_preempt is False


def test_bad_prefetch_ticks_rejected():
    msgs = []
    for is_jax in (True, False):
        with pytest.raises(ValueError, match="prefetch_ticks") as err:
            _paged(is_jax, tiered=True, prefetch_ticks=0,
                   ledger=_side(is_jax)[3](-1, budget_bytes=10**9))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_paged_kv_budget_tier_moves_match_jax():
    """``PagedKVBudget.demote`` / ``prefetch`` / ``drop_host`` drive the
    ledger's tiered terms (before the port had them, each call raised
    AttributeError), term for term as in the JAX package — the pressure
    refusal and the over-release errors included."""
    out = []
    for Budget, Ledger in ((JPagedKVBudget, JDeviceMemory),
                           (PagedKVBudget, DeviceMemory)):
        led = Ledger(-1, budget_bytes=10 * 1000)
        bud = Budget(led, 1000)
        rec = []

        def snap(tag):
            rec.append((tag, bud.reserved_bytes, bud.peak_bytes,
                        led.kv_reserved_bytes, led.host_kv_bytes,
                        led.host_kv_peak_bytes, led.stats.kv_demoted_bytes,
                        led.stats.kv_prefetched_bytes,
                        led.stats.n_kv_demotions,
                        led.stats.n_kv_prefetches, led.stats.total_bytes()))
        assert bud.reserve(8)
        snap("reserve")
        bud.demote(5)
        snap("demote")
        assert led.reserve_kv(5 * 1000)       # someone takes the bytes
        assert not bud.prefetch(5)            # does not fit: stays parked
        snap("refused")
        led.release_kv(5 * 1000)
        assert bud.prefetch(3)
        snap("prefetch")
        bud.drop_host(2)
        snap("drop")
        with pytest.raises(RuntimeError, match="only"):
            bud.demote(7)
        with pytest.raises(RuntimeError, match="host"):
            bud.drop_host(1)
        bud.release(6)
        snap("release")
        out.append(rec)
    assert out[0] == out[1]
    assert out[1][-1][1:5] == (0, 8000, 0, 0)


# ---------------------------------------------------------------------------
# property: byte reconciliation across random interleavings
# ---------------------------------------------------------------------------

def _interleave(is_jax, seed):
    cfg = _side(is_jax)[0]
    rng = np.random.RandomState(seed)
    ledger = _side(is_jax)[3](-1, budget_bytes=10**9)
    eng = _paged(is_jax, capacity=2, ledger=ledger, tiered=True,
                 prefetch_ticks=int(rng.randint(1, 4)))
    reqs = [eng.submit(_prompt(cfg.vocab_size, int(rng.randint(100))),
                       int(rng.randint(4, 14)),
                       priority=["low", "normal", "high"][i % 3])
            for i in range(4)]
    trace = []
    for _ in range(30):
        op = rng.randint(4)
        if op == 0:
            eng.step()
        elif op == 1:
            parked = [r for r in reqs if r.status.value == "preempted"]
            if parked:
                eng.backend.demote_parked(parked[int(rng.randint(
                    len(parked)))])
        elif op == 2:
            live = [r for r in reqs if r.status.value in (
                "queued", "running", "preempted")]
            if live:
                eng.cancel(live[int(rng.randint(len(live)))].request_id)
        elif len(reqs) < 8:
            reqs.append(eng.submit(
                _prompt(cfg.vocab_size, int(rng.randint(100))), 4,
                priority="high", deadline_ms=60_000.0))
        _reconcile(eng, ledger)
        trace.append((int(op), _decisions(eng, ledger, reqs)))
    eng.run()
    _reconcile(eng, ledger)
    _assert_drained(eng, ledger)
    assert all(r.status.value in ("finished", "cancelled", "rejected")
               for r in reqs)
    trace.append(_decisions(eng, ledger, reqs))
    return trace, [list(map(int, r.generated)) for r in reqs]


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_property_interleavings_reconcile(seed):
    """Random preempt / demote / cancel / step interleavings: both
    packages' ledger and pool terms reconcile at every op, equal op by op,
    and a full drain restores the baseline."""
    assert _interleave(False, seed) == _interleave(True, seed)


# ---------------------------------------------------------------------------
# weight residency: ShardResidentParams + cross-model LRU
# ---------------------------------------------------------------------------

PART_BUDGET = 3_200_000     # partitions the smoke model into 2 shards
HOT_CAP = 3_000_000         # pins exactly one ~2.75 MB shard


def _shard_setup(is_jax, ledger_budget, *, hot_bytes=None, name=None,
                 ledger=None):
    """A 2-shard host store + ShardResidentParams on either package."""
    jcfg, jparams, cfg, params = _dense()
    if is_jax:
        plan = jsg.build_plan(jcfg)
        host = jsg.prepare_host_params(jcfg,
                                       jax.tree.map(np.asarray, jparams))
        part = jpt.partition(jcfg, host, plan, budget_bytes=PART_BUDGET,
                             batch=1, seq=MAX_SEQ, train=False)
        store = JHostModelStore(jcfg, plan, jparams,
                                jopt.OptimizerConfig(grad_clip=0.0), part)
        led = ledger or JDeviceMemory(-1, budget_bytes=ledger_budget)
        return part, led, JShardParams(jcfg, store, part, led,
                                       hot_bytes=hot_bytes, name=name)
    plan = sg.build_plan(cfg)
    host = sg.prepare_host_params(cfg, params)
    part = pt.partition(cfg, host, plan, budget_bytes=PART_BUDGET, batch=1,
                        seq=MAX_SEQ, train=False)
    store = HostModelStore(cfg, plan, params,
                           opt.OptimizerConfig(grad_clip=0.0), part,
                           device="cpu")
    led = ledger or DeviceMemory(-1, budget_bytes=ledger_budget)
    return part, led, ShardResidentParams(cfg, store, part, led,
                                          hot_bytes=hot_bytes, name=name)


def _residency(src, led):
    return (src.n_shards, src.n_hot_shards, sorted(src._hot.items()),
            src.hot_resident_bytes, src.stream_promoted_bytes,
            src.n_stream_promotions, src.n_hot_demotions,
            led.weight_resident_bytes, led.resident_bytes,
            led.buffered_bytes, led.used_bytes(), led.stats.promoted_bytes,
            led.stats.demoted_bytes)


def test_shard_residency_streams_and_reconciles():
    import torch
    jpart, jled, jsrc = _shard_setup(True, 6 * 10**6, hot_bytes=HOT_CAP)
    part, led, src = _shard_setup(False, 6 * 10**6, hot_bytes=HOT_CAP)
    assert [(s.seg_lo, s.seg_hi, s.param_bytes) for s in part.shards] == \
        [(s.seg_lo, s.seg_hi, s.param_bytes) for s in jpart.shards]
    assert src.n_shards > 1
    jsrc.begin_tick()
    assembled = src.begin_tick()
    assert _residency(src, led) == _residency(jsrc, jled)
    assert led.weight_resident_bytes == src.hot_resident_bytes
    assert led.used_bytes() <= led.budget
    jsrc.end_tick()
    src.end_tick()
    assert _residency(src, led) == _residency(jsrc, jled)
    assert led.resident_bytes == 0 and led.buffered_bytes == 0
    assert 0 < src.n_hot_shards < src.n_shards
    assert 0 < src.hot_resident_bytes < src.total_bytes
    assert src.summary()["n_stream_promotions"] > 0
    assert _summary(src.summary()) == _summary(jsrc.summary())
    # the assembled tree is the full model as an engine holds it; between
    # ticks only the hot shards' tensors are held
    full = api.prepare_params(_dense()[2], _dense()[3], "cpu")

    def same(a, b):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            return all(same(a[k], b[k]) for k in b)
        if isinstance(a, list):     # per-layer rows of a stacked leaf
            return len(a) == b.shape[0] and all(
                torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)
    assert same(assembled, full)
    assert src._streamed == {}
    assert sorted(src._held) == sorted(src._hot)


def test_shard_residency_decode_token_identity():
    """Decoding with only part of the model held produces exactly the
    tokens of fully resident decode, with the same residency traffic."""
    outs = []
    for is_jax in (True, False):
        cfg, _, Eng, _, kw = _side(is_jax)
        part, led, src = _shard_setup(is_jax, 6 * 10**6, hot_bytes=HOT_CAP)
        eng = Eng(cfg, None, capacity=1, max_seq=MAX_SEQ, backend="paged",
                  block_size=8, policy="fifo", param_source=src, **kw)
        r = eng.submit(_prompt(cfg.vocab_size, 5), 8)
        eng.run()
        assert r.status.value == "finished"
        s = eng.summary()
        assert s["residency"] == "shard"
        assert s["n_hot_shards"] < s["n_shards"]
        assert s["stream_promoted_bytes"] > 0
        assert led.weight_resident_bytes == src.hot_resident_bytes
        assert led.resident_bytes == 0 and led.buffered_bytes == 0
        outs.append((list(map(int, r.generated)), s,
                     _residency(src, led)))
    (jtoks, js, jres), (toks, s, res) = outs
    assert toks == jtoks == _sequential(
        False, [(_prompt(_dense()[2].vocab_size, 5), 8)])[0]
    _assert_same_summary(js, s)
    assert res == jres


def test_pressure_demotes_lru_model():
    """Two models under one ledger: a reservation that does not fit
    demotes the least-recently-served model's hot shards first."""
    budget = 12 * 10**6
    outs = []
    for is_jax, Ledger, Coord in ((True, JDeviceMemory, JCoordinator),
                                  (False, DeviceMemory,
                                   ResidencyCoordinator)):
        led = Ledger(-1, budget_bytes=budget)
        coord = Coord(led)
        a = _shard_setup(is_jax, budget, ledger=led, name="model-a")[2]
        b = _shard_setup(is_jax, budget, ledger=led, name="model-b")[2]
        coord.register(a)
        coord.register(b)
        a.begin_tick()
        a.end_tick()
        b.begin_tick()
        b.end_tick()            # LRU order now: a older than b
        a_before, b_before = a.hot_resident_bytes, b.hot_resident_bytes
        assert a_before > 0 and b_before > 0
        need = budget - led.used_bytes() + a_before // 2
        assert led.reserve_kv(need)
        assert a.hot_resident_bytes < a_before
        assert b.hot_resident_bytes == b_before
        assert led.used_bytes() <= led.budget
        outs.append((_residency(a, led), _residency(b, led), need))
        if not is_jax:
            assert sorted(a._held) == sorted(a._hot)
        led.release_kv(need)
    assert outs[0] == outs[1]


def test_relieve_never_demotes_mid_tick():
    outs = []
    for is_jax in (True, False):
        _, led, src = _shard_setup(is_jax, 6 * 10**6, hot_bytes=HOT_CAP)
        src.begin_tick()
        pinned = src.hot_resident_bytes
        assert src.demote(pinned or 1) == 0      # guarded mid-tick
        assert src.hot_resident_bytes == pinned
        src.end_tick()
        assert src.demote(pinned or 1) == pinned  # demotable after it
        outs.append(_residency(src, led))
        if not is_jax:
            assert src._held == {}
    assert outs[0] == outs[1]


def test_weight_reservation_over_release_raises():
    msgs = []
    for Ledger in (JDeviceMemory, DeviceMemory):
        led = Ledger(-1, budget_bytes=10**6)
        assert led.reserve_weights(1000)
        with pytest.raises(RuntimeError, match="release_weights") as err:
            led.release_weights(2000)
        msgs.append(str(err.value))
        led.release_weights(1000)
        assert led.weight_resident_bytes == 0
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# ledger unit properties: demote / prefetch / drop bookkeeping
# ---------------------------------------------------------------------------

def _ledger_terms(led):
    return (led.kv_reserved_bytes, led.host_kv_bytes, led.host_kv_peak_bytes,
            led.used_bytes(), led.kv_peak_bytes, vars(led.stats))


def test_ledger_kv_tier_roundtrip():
    out = []
    for Ledger in (JDeviceMemory, DeviceMemory):
        led = Ledger(-1, budget_bytes=10_000)
        rec = []
        assert led.reserve_kv(8_000)
        led.demote_kv(6_000)
        rec.append(_ledger_terms(led))
        assert led.kv_reserved_bytes == 2_000
        assert led.host_kv_bytes == 6_000
        assert led.used_bytes() == 2_000   # host bytes are NOT device bytes
        assert led.prefetch_kv(6_000)
        rec.append(_ledger_terms(led))
        led.demote_kv(8_000)
        led.drop_host_kv(8_000)            # cancel while parked
        rec.append(_ledger_terms(led))
        assert led.host_kv_bytes == 0 and led.kv_reserved_bytes == 0
        assert led.stats.kv_demoted_bytes == 14_000
        assert led.stats.kv_prefetched_bytes == 6_000
        out.append(rec)
    assert out[0] == out[1]


def test_ledger_prefetch_respects_budget_and_pressure():
    out = []
    for Ledger in (JDeviceMemory, DeviceMemory):
        led = Ledger(-1, budget_bytes=10_000)
        asked = []
        led.on_pressure(lambda need: asked.append(need) or 0)
        assert led.reserve_kv(10_000)
        led.demote_kv(4_000)
        assert led.reserve_kv(4_000)
        assert not led.prefetch_kv(4_000)  # the handler freed nothing
        assert led.host_kv_bytes == 4_000
        led.release_kv(4_000)
        assert led.prefetch_kv(4_000)
        assert led.host_kv_bytes == 0
        out.append((asked, _ledger_terms(led)))
    assert out[0] == out[1] and out[1][0] == [4_000]


def test_ledger_host_over_release_raises():
    msgs = []
    for Ledger in (JDeviceMemory, DeviceMemory):
        led = Ledger(-1, budget_bytes=10_000)
        assert led.reserve_kv(2_000)
        led.demote_kv(2_000)
        with pytest.raises(RuntimeError, match="host") as e1:
            led.prefetch_kv(3_000)
        with pytest.raises(RuntimeError, match="host") as e2:
            led.drop_host_kv(3_000)
        led.drop_host_kv(2_000)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# session surface: train-then-serve + shard-resident cold serve
# ---------------------------------------------------------------------------

def _synth_loader(vocab, n=4, batch=2, seq=16):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        toks = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        out.append({"tokens": toks, "labels": toks})
    return out


def _session(is_jax, **hc):
    hc = dict(n_devices=1, device_budget_bytes=10**9, **hc)
    if is_jax:
        return JSession(JHydraConfig(**hc), profile=None)
    return Session(HydraConfig(**hc), device="cpu", profile=None)


def _train_then_serve(is_jax):
    cfg = _side(is_jax)[0]
    Train, Serve = (JTrainJob, JServeJob) if is_jax else (TrainJob, ServeJob)
    sess = _session(is_jax, pilot=False, fixed_unit_runtime=1e-3)
    tid = sess.submit(Train(cfg, dataloader=_synth_loader(cfg.vocab_size),
                            lr=1e-3, epochs=1, steps_per_epoch=2, seed=0,
                            batch=2, seq=16, params=_side(is_jax)[1]))
    sid = sess.submit(Serve(cfg, params_from=tid, residency="shard",
                            backend="paged", max_seq=MAX_SEQ, capacity=2,
                            block_size=8, tiered_kv=True, prefetch_ticks=2))
    plan = sess.plan()
    rep = sess.run()
    r = sess.submit_request(sid, _prompt(cfg.vocab_size, 2), 6)
    sess.drain_serving()
    assert r.status.value == "finished"
    trained = sess._train_execs[tid].store.model_params()
    if is_jax:
        trained = jax.tree.map(np.asarray, trained)
    assert list(map(int, r.generated)) == \
        _sequential(is_jax, [(_prompt(cfg.vocab_size, 2), 6)], trained)[0]
    meta = sess._serve_meta(sess._jobs[sid], cold=True)
    assert meta["residency"] == "shard" and meta["params_from"] == tid
    return (sess, list(map(int, r.generated)), plan.job(sid).meta, meta,
            sess.poll(sid), rep.serve[sid], sess.engine(sid).summary())


def test_session_train_then_serve_promotion():
    """A finished TrainJob's weights flow into a shard-resident, tiered
    ServeJob in the same session, token-identical to decoding the trained
    store by hand; plan meta, the tiering meta keys, the report record
    and the poll gauges equal the JAX session's."""
    js, jtoks, jpmeta, jmeta, jpoll, jrec, jsum = _train_then_serve(True)
    ps, toks, pmeta, meta, poll, rec, summ = _train_then_serve(False)
    assert toks == jtoks
    for a, b in ((pmeta, jpmeta), (meta, jmeta)):
        assert {k: v for k, v in a.items() if k != "cost"} == \
            {k: v for k, v in b.items() if k != "cost"}
        assert a["tiered_kv"] is True and a["prefetch_ticks"] == 2
    gauges = ("residency", "n_hot_shards", "hot_resident_bytes",
              "stream_promoted_bytes", "kv_demoted_bytes",
              "kv_prefetched_bytes", "prefetch_hit_rate",
              "peak_live_requests")
    assert {k: poll[k] for k in gauges} == {k: jpoll[k] for k in gauges}
    assert poll["residency"] == "shard"
    assert {k: v for k, v in poll.items() if k != "recent_requests"} == \
        {k: v for k, v in jpoll.items() if k != "recent_requests"}
    assert _summary(rec) == _summary(jrec)
    _assert_same_summary(jsum, summ)
    assert summ["tiered"] is True and summ["residency"] == "shard"
    led = ps.devices[0]
    assert led.weight_resident_bytes == \
        ps._cold[poll["job_id"]]["residency"].hot_resident_bytes == \
        js.devices[0].weight_resident_bytes
    assert led.kv_reserved_bytes == 0 == js.devices[0].kv_reserved_bytes


def test_session_params_from_before_training_refused():
    msgs = []
    for is_jax in (True, False):
        cfg = _side(is_jax)[0]
        Train, Serve = ((JTrainJob, JServeJob) if is_jax
                        else (TrainJob, ServeJob))
        sess = _session(is_jax)
        tid = sess.submit(Train(cfg, dataloader=_synth_loader(
            cfg.vocab_size), epochs=1, steps_per_epoch=2, batch=2, seq=16))
        sid = sess.submit(Serve(cfg, params_from=tid, max_seq=MAX_SEQ,
                                residency="shard"))
        with pytest.raises(RuntimeError,
                           match="has not finished training") as err:
            sess.submit_request(sid, _prompt(cfg.vocab_size, 1), 4)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_session_validates_tiering_specs():
    bad = ((dict(residency="shard"), "cold"),
           (dict(residency="page"), "residency"),
           (dict(tiered_kv=True), "paged"),
           (dict(residency="model", hot_bytes=5), "hot_bytes"),
           (dict(cold=True, residency="shard", hot_bytes=-1), "hot_bytes"),
           (dict(backend="paged", tiered_kv=True, prefetch_ticks=0),
            "prefetch_ticks"),
           (dict(params_from="train-99"), "params_from"))
    for kw, msg in bad:
        msgs = []
        for is_jax in (True, False):
            Serve = JServeJob if is_jax else ServeJob
            sess = _session(is_jax)
            with pytest.raises(ValueError, match=msg) as err:
                sess.submit(Serve(_side(is_jax)[0], **kw))
            assert sess.jobs() == {}
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw
