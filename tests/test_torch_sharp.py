"""The port's SHARP stack against the JAX package's: partitioning, the
scheduler, the host model store, the executor's schedule and losses, the
session's Plan, eval through the shard queue and spilled inference.

Decisions must be the same, not just close: shard boundaries,
``param_bytes``/``act_bytes``, the plan's memory split and, with
``HydraConfig.fixed_unit_runtime`` pinning unit runtimes (the only way a
schedule is reproducible, as in the reference's own makespan tests), the
``UnitEvent.key()`` sequence.  Values: ``dtype=float32`` configs on both
sides; losses and logits at 2e-4 (matmul chains, as
``tests/test_kernel_oracles.py``); SHARP against the port's own
sequential reference at rtol = atol = 3e-4, the reference's
``tests/test_orchestrator.py`` bound.  Training budgets are that file's
(qwen3-0.6b 18 MB, bert-large-1b 6 MB); eval and spilled inference get
budgets small enough to cut the model into at least two shards.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import EvalJob as JEvalJob
from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core import partitioner as jpt
from repro.core import scheduler as jsched
from repro.core import shard_graph as jsg
from repro.core.orchestrator import SpilledInference as JSpilledInference
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro_torch.api import EvalJob, HydraConfig, Plan, Session, TrainJob
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import scheduler as sched
from repro_torch.core import shard_graph as sg
from repro_torch.core.orchestrator import (ModelOrchestrator, ModelTask,
                                           SpilledInference,
                                           train_sequential_reference)
from repro_torch.core.spilling import HostModelStore
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.optim.optimizers import OptimizerConfig

MM_TOL = 2e-4
SEQ_TOL = 3e-4
BUDGET = {"qwen3-0.6b": 18 * 10**6, "bert-large-1b": 6 * 10**6}
STEPS, SEQ = 3, 64
LRS = (1e-3, 1e-4)                  # the quickstart's two candidates


def _cfgs(arch, f32=True):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if f32:
        jcfg, cfg = jcfg.replace(dtype=jnp.float32), cfg.replace(
            dtype="float32")
    return jcfg, cfg


def _params(jcfg, seed):
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _loaders(cfg, seed, batch=2):
    kw = dict(batch_size=batch, seq_len=SEQ, vocab_size=cfg.vocab_size,
              seed=seed)
    return JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(
        DataConfig(**kw))


# ---------------------------------------------------------------------------
# partitioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bert-large-1b"])
@pytest.mark.parametrize("train", [True, False])
def test_partition_matches_jax(arch, train):
    """Same shards, bytes and analytic runtimes at the reference's test
    budgets, in the bf16 compute dtype (the activation term's width)."""
    jcfg, cfg = _cfgs(arch, f32=False)
    jparams, params = _params(jcfg, 0)
    for budget in (BUDGET[arch], 2 * BUDGET[arch]):
        jr = jpt.partition(jcfg, jax.tree.map(np.asarray, jparams),
                           jsg.build_plan(jcfg), budget_bytes=budget,
                           batch=2, seq=SEQ, train=train)
        r = pt.partition(cfg, params, sg.build_plan(cfg), budget_bytes=budget,
                         batch=2, seq=SEQ, train=train)
        assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards]
        assert (r.shared_bytes, r.budget_bytes, r.oracle) == \
            (jr.shared_bytes, jr.budget_bytes, jr.oracle)
    with pytest.raises(NotImplementedError, match="later slice"):
        pt.partition(cfg, params, sg.build_plan(cfg), budget_bytes=budget,
                     batch=2, seq=SEQ, oracle="probe")


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_scheduler_picks_match_jax():
    rng = random.Random(0)
    for trial in range(50):
        rows = [(i, rng.randint(1, 3), rng.randint(1, 4), rng.randint(1, 4),
                 rng.random(), rng.random()) for i in range(rng.randint(1, 6))]
        rng.shuffle(rows)
        port = [sched.ModelProgress(*r) for r in rows]
        ref = [jsched.ModelProgress(*r) for r in rows]
        for name in ("lrtf", "srtf", "fifo", "random", "slo"):
            assert sched.get_scheduler(name, seed=trial)(port) == \
                jsched.get_scheduler(name, seed=trial)(ref), name
        assert [m.remaining_time() for m in port] == \
            [m.remaining_time() for m in ref]
    times = [[rng.random() for _ in range(rng.randint(1, 4))]
             for _ in range(3)]
    for n_dev in (1, 2):
        assert sched.greedy_list_makespan(times, n_dev) == \
            jsched.greedy_list_makespan(times, n_dev)
        assert sched.optimal_makespan(times, n_dev) == \
            jsched.optimal_makespan(times, n_dev)


# ---------------------------------------------------------------------------
# host model store
# ---------------------------------------------------------------------------

def _store():
    jcfg, cfg = _cfgs("qwen3-0.6b")
    _, params = _params(jcfg, 0)
    plan = sg.build_plan(cfg)
    part = pt.partition(cfg, params, plan, budget_bytes=20 * 10**6, batch=2,
                        seq=SEQ)
    return cfg, plan, part, HostModelStore(
        cfg, plan, params, OptimizerConfig(grad_clip=0.0), part,
        device="cpu"), params


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda t: t.numpy().copy(), tree))


def test_promote_demote_roundtrip_bit_exact():
    cfg, plan, part, store, params = _store()
    before = _leaves(store.params)
    for shard in part.shards:
        own, shared, opt_state = store.promote_shard(shard)
        store.demote_shard(shard, own, opt_state)
    for a, b in zip(before, _leaves(store.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(params), _leaves(store.model_params())):
        np.testing.assert_array_equal(a, b)


def test_promotion_copies_on_the_cpu_too():
    """An in-place write to a promoted shard (or to the caller's params)
    never reaches the host master copy: ``.to('cpu')`` alone would
    alias it."""
    cfg, plan, part, store, params = _store()
    before = _leaves(store.params)
    for shard in part.shards:
        own, shared, opt_state = store.promote_shard(shard)
        jax.tree.map(lambda t: t.add_(1.0), (own, shared))
        opt_state["mu"] = jax.tree.map(lambda t: t.add_(1.0),
                                       opt_state["mu"])
    jax.tree.map(lambda t: t.add_(1.0), params)
    for a, b in zip(before, _leaves(store.params)):
        np.testing.assert_array_equal(a, b)
    assert all(float(abs(t).max()) == 0.0
               for t in jax.tree.leaves(store.opt[0]["mu"]))


def test_shared_grad_accumulation():
    cfg, plan, part, store, params = _store()
    ref = sg.resolve_ref(store.params, plan.shared_refs["embed"])
    g1 = jax.tree.map(torch.ones_like, ref)
    store.accumulate_shared_grads({"embed": g1})
    store.accumulate_shared_grads({"embed": g1})
    assert float(store.shared_grad_acc["embed"]["table"].max()) == 2.0
    before = ref["table"].clone()
    store.step_shared()
    after = sg.resolve_ref(store.params, plan.shared_refs["embed"])["table"]
    assert not torch.allclose(before, after)      # params moved
    assert store.shared_grad_acc == {}            # accumulator cleared


# ---------------------------------------------------------------------------
# SHARP through the session, both packages
# ---------------------------------------------------------------------------

def _sessions(arch):
    """The quickstart flow in both packages: two TrainJobs (seeds 0 and 1)
    under one session with pinned unit runtimes."""
    jcfg, cfg = _cfgs(arch)
    hc = dict(n_devices=2, device_budget_bytes=BUDGET[arch],
              fixed_unit_runtime=1e-3)
    js = JSession(JHydraConfig(**hc), profile=None)
    ps = Session(HydraConfig(**hc), device="cpu", profile=None)
    for seed, lr in enumerate(LRS):
        jparams, params = _params(jcfg, seed)
        jl, pl = _loaders(cfg, seed)
        job = dict(lr=lr, epochs=1, steps_per_epoch=STEPS, batch=2, seq=SEQ)
        js.submit(JTrainJob(jcfg, jl, params=jparams, seed=seed, **job))
        ps.submit(TrainJob(cfg, pl, params=params, seed=seed, **job))
    return js, ps, cfg


@pytest.fixture(scope="module", params=["qwen3-0.6b", "bert-large-1b"])
def sharp_runs(request):
    js, ps, cfg = _sessions(request.param)
    jplan, plan = js.plan(), ps.plan()
    reloaded = Plan.from_json(plan.to_json())
    jrep, rep = js.run(jplan), ps.run(reloaded)
    return dict(arch=request.param, cfg=cfg, jplan=jplan, plan=plan,
                reloaded=reloaded, jrep=jrep, rep=rep, session=ps)


def test_plan_matches_jax_and_round_trips(sharp_runs):
    jplan, plan = sharp_runs["jplan"], sharp_runs["plan"]
    assert [j.partition for j in plan.jobs] == \
        [j.partition for j in jplan.jobs]
    assert [(j.host_bytes, j.max_shard_bytes) for j in plan.jobs] == \
        [(j.host_bytes, j.max_shard_bytes) for j in jplan.jobs]
    assert plan.schedule["memory"] == jplan.schedule["memory"]
    assert plan.schedule["est_makespan_s"] == \
        jplan.schedule["est_makespan_s"]
    assert plan.hydra == jplan.hydra
    again = Plan.from_json(sharp_runs["reloaded"].to_json())
    assert again.to_json() == plan.to_json()
    assert again.jobs[0].cfg() == sharp_runs["cfg"]


def test_unit_schedule_and_losses_match_jax(sharp_runs):
    jrep, rep = sharp_runs["jrep"], sharp_runs["rep"]
    assert rep.unit_trace == jrep.unit_trace
    n_shards = len(sharp_runs["plan"].jobs[0].partition["shards"])
    assert rep.train.units_executed == 2 * STEPS * 2 * n_shards
    assert rep.train.makespan == pytest.approx(jrep.train.makespan)
    for mid in (0, 1):
        np.testing.assert_allclose(rep.train.losses[mid],
                                   jrep.train.losses[mid],
                                   rtol=MM_TOL, atol=MM_TOL)
    for dev in rep.train.transfer:
        assert vars(rep.train.transfer[dev]) == {
            k: v for k, v in vars(jrep.train.transfer[dev]).items()
            if k in vars(rep.train.transfer[dev])}


def test_sharp_losses_equal_sequential_reference(sharp_runs):
    cfg, rep = sharp_runs["cfg"], sharp_runs["rep"]
    jcfg, _ = _cfgs(sharp_runs["arch"])
    for seed, lr in enumerate(LRS):
        _, params = _params(jcfg, seed)
        _, ref = train_sequential_reference(
            ModelTask(cfg, _loaders(cfg, seed)[1], lr=lr, epochs=1,
                      steps_per_epoch=STEPS, params=params, batch=2,
                      seq=SEQ), device="cpu")
        np.testing.assert_allclose(ref, rep.train.losses[seed],
                                   rtol=SEQ_TOL, atol=SEQ_TOL)
    for jid in ("train-0", "train-1"):
        assert sharp_runs["session"].poll(jid)["status"] == "done"


def test_model_orchestrator_wraps_a_session():
    """The legacy Fig. 4 API: one TrainJob per ModelTask under a Session;
    its losses are the sequential reference's."""
    jcfg, cfg = _cfgs("bert-large-1b")

    def tasks():
        return [ModelTask(cfg, _loaders(cfg, seed)[1], lr=1e-3, epochs=1,
                          steps_per_epoch=2, params=_params(jcfg, seed)[1],
                          batch=2, seq=SEQ) for seed in (0, 1)]

    orch = ModelOrchestrator(tasks(), HydraConfig(
        n_devices=2, device_budget_bytes=BUDGET["bert-large-1b"]),
        device="cpu")
    assert len(orch.models) == 2
    report = orch.train_models()
    assert report.units_executed == 2 * 2 * 2 * len(
        orch.models[0].partition.shards)
    for i, task in enumerate(tasks()):
        _, ref = train_sequential_reference(task, device="cpu")
        np.testing.assert_allclose(ref, report.losses[i], rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
    assert set(orch.model_params(0)) == {"embed", "layers", "final_norm"}


# ---------------------------------------------------------------------------
# forward-only: EvalJob and SpilledInference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["xla", "pallas_interpret"])
def test_eval_job_matches_jax(attn_impl):
    """Forward-only shard queue, two batches; the kernel config goes
    through the flash kernel's plain version here and the Pallas kernel in
    interpret mode there."""
    jcfg, cfg = _cfgs("qwen3-0.6b")
    jcfg = jcfg.replace(attn_impl=attn_impl)
    cfg = cfg.replace(attn_impl="xla" if attn_impl == "xla" else "cuda")
    jparams, params = _params(jcfg, 0)
    jl, pl = _loaders(cfg, 5)
    hc = dict(n_devices=1, device_budget_bytes=4 * 10**6)
    js = JSession(JHydraConfig(**hc), profile=None)
    ps = Session(HydraConfig(**hc), device="cpu", profile=None)
    js.submit(JEvalJob(jcfg, jl, n_batches=2, params=jparams, seq=SEQ))
    ps.submit(EvalJob(cfg, pl, n_batches=2, params=params, seq=SEQ))
    jev, ev = js.run().evals["eval-0"], ps.run().evals["eval-0"]
    assert ev["n_shards"] == jev["n_shards"] >= 2
    assert ev["bytes_moved"] == jev["bytes_moved"]
    np.testing.assert_allclose(ev["losses"], jev["losses"], rtol=MM_TOL,
                               atol=MM_TOL)
    assert ev["perplexity"] == pytest.approx(jev["perplexity"], rel=MM_TOL)


def test_spilled_inference_matches_jax():
    jcfg, cfg = _cfgs("bert-large-1b")
    jparams, params = _params(jcfg, 1)
    batch = next(iter(_loaders(cfg, 2)[1]))
    jinf = JSpilledInference(jcfg, jparams, device_budget_bytes=1_500_000,
                             batch=2, seq=SEQ)
    inf = SpilledInference(cfg, params, device_budget_bytes=1_500_000,
                           batch=2, seq=SEQ, device="cpu")
    assert inf.n_shards == jinf.n_shards >= 2
    exp = jinf(batch)
    out = inf(batch)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=MM_TOL,
                               atol=MM_TOL)
    assert inf.bytes_moved == jinf.bytes_moved
    assert float(inf.loss(batch)) == pytest.approx(float(jinf.loss(batch)),
                                                   rel=MM_TOL)
