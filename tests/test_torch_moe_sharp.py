"""The MoE family under Hydra's executor, beside the JAX package: the MoE
shard plan, analytic and probe partitions, the probe's entry activation,
SHARP training of two mixtral-8x22b smoke models and spilled inference.

Decisions must be equal (segments, refs, shard boundaries and bytes,
the ``UnitEvent.key()`` sequence under ``fixed_unit_runtime``); values
compare in float32 at the reference's bounds: losses and logits 2e-4
(matmul chains), SHARP against plain training 3e-4 (JAX
``tests/test_orchestrator.py``, whose 45 MB budget this uses for
mixtral).  Partition budgets: JAX ``tests/test_partitioner.py``'s 60 MB,
35 MB (training: the last that fits a layer), 15 MB (training refused,
inference cut in two) and 10 MB.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_weights import both_params
from test_torch_probe import _jax_probe

from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core import partitioner as jpt
from repro.core import shard_graph as jsg
from repro.core.orchestrator import SpilledInference as JSpilledInference
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.api import HydraConfig, Session, TrainJob
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.orchestrator import (ModelTask, SpilledInference,
                                           train_sequential_reference)
from repro_torch.core.sharp import ShardFunctions
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors
from repro_torch.models import api
from repro_torch.optim.optimizers import OptimizerConfig

ARCH = "mixtral-8x22b"
MM_TOL = 2e-4
SEQ_TOL = 3e-4
SEQ, STEPS = 64, 2
PART_BUDGETS = (60 * 10**6, 35 * 10**6, 15 * 10**6, 10 * 10**6)
SHARP_BUDGET = 45 * 10**6
LRS = (1e-3, 1e-4)


@functools.lru_cache(maxsize=None)
def _setup(f32):
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if f32:
        jcfg, cfg = jcfg.replace(dtype=jnp.float32), cfg.replace(
            dtype="float32")
    jparams, params = both_params(jcfg, cfg, 0)
    return jcfg, jparams, cfg, params


def _loaders(cfg, seed, batch=2):
    kw = dict(batch_size=batch, seq_len=SEQ, vocab_size=cfg.vocab_size,
              seed=seed)
    return JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(
        DataConfig(**kw))


def test_moe_plan_matches_jax():
    jcfg, _, cfg, _ = _setup(False)
    jplan, plan = jsg.build_plan(jcfg), sg.build_plan(cfg)
    assert [(s.name, s.param_ref, s.shared, s.flops_weight)
            for s in plan.segments] == \
        [(s.name, s.param_ref, s.shared, s.flops_weight)
         for s in jplan.segments]
    assert plan.shared_refs == jplan.shared_refs
    assert len(plan.segments) == cfg.n_layers + 2


@pytest.mark.parametrize("train", [True, False])
def test_analytic_partitions_match_jax(train):
    """Same shards, bytes and analytic runtimes at JAX's partitioner
    budgets, in the bf16 compute dtype, or JAX's MemoryError where a layer
    does not fit; the CPU probe covers the plan."""
    jcfg, jparams, cfg, params = _setup(False)
    jhost = jsg.prepare_host_params(jcfg, jax.tree.map(np.asarray, jparams))
    counts = []
    for budget in PART_BUDGETS:
        kw = dict(budget_bytes=budget, batch=2, seq=SEQ, train=train)
        try:
            jr = jpt.partition(jcfg, jhost, jsg.build_plan(jcfg), **kw)
        except MemoryError as e:
            with pytest.raises(MemoryError) as got:
                pt.partition(cfg, params, sg.build_plan(cfg), **kw)
            assert str(got.value) == str(e)
            continue
        r = pt.partition(cfg, params, sg.build_plan(cfg), **kw)
        assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards]
        assert (r.shared_bytes, r.budget_bytes, r.oracle) == \
            (jr.shared_bytes, jr.budget_bytes, jr.oracle)
        counts.append(len(r.shards))
    assert max(counts) >= 2
    probed = pt.partition(cfg, params, sg.build_plan(cfg),
                          budget_bytes=PART_BUDGETS[0], batch=2, seq=SEQ,
                          oracle="probe", train=train, device="cpu")
    segs = [i for s in probed.shards for i in range(s.seg_lo, s.seg_hi)]
    assert segs == list(range(cfg.n_layers + 2))


def test_entry_act_spec_carries_aux_of_a_real_exit():
    """A shard starting after segment 0 enters with x in the compute dtype
    and the f32 scalar aux sums, as JAX's spec and a real forward unit's
    exit have them."""
    jcfg, _, cfg, params = _setup(False)
    plan = sg.build_plan(cfg)
    spec = pt._entry_act_spec(cfg, plan, 2, 2, SEQ)
    jspec = jpt._entry_act_spec(jcfg, jsg.build_plan(jcfg), 2, 2, SEQ)
    shapes = jax.tree.map(
        lambda v: (tuple(v.shape), str(v.dtype).removeprefix("torch.")),
        spec, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert shapes == jax.tree.map(
        lambda v: (tuple(v.shape), str(v.dtype)), jspec)
    part = pt.PartitionResult([pt.Shard(0, 0, 2), pt.Shard(
        1, 2, len(plan.segments))], 0, 0, "probe")
    fns = ShardFunctions(cfg, plan, part, OptimizerConfig())
    batch = as_tensors(next(iter(_loaders(cfg, 0)[1])), "cpu")
    own = tuple(sg.resolve_ref(params, plan.segments[i].param_ref)
                for i in range(2))
    shared = {n: sg.resolve_ref(params, plan.shared_refs[n])
              for i in range(2) for n in plan.segments[i].shared}
    exit_act, _ = fns.fwd(part.shards[0])(own, shared, {}, batch)
    assert jax.tree.map(lambda v: (tuple(v.shape), v.dtype), exit_act,
                        is_leaf=lambda v: isinstance(v, torch.Tensor)) == \
        jax.tree.map(lambda v: (tuple(v.shape), v.dtype), spec,
                     is_leaf=lambda v: isinstance(v, torch.Tensor))


def test_probe_partition_given_jax_peaks_matches_jax():
    """JAX's compiled peaks in (pilots of shards after segment 0 need the
    aux entry), JAX's shards out at 60 MB and JAX's MemoryError at 35 MB
    (the JAX rule charges what the analytic one does not)."""
    _, _, cfg, params = _setup(False)
    results, peaks = _jax_probe(ARCH, PART_BUDGETS[:2])
    for budget, jr in results.items():
        def run():
            return pt.partition(cfg, params, sg.build_plan(cfg),
                                budget_bytes=budget, batch=2, seq=SEQ,
                                oracle="probe",
                                _peaks=lambda lo, hi: peaks[(lo, hi)])
        if isinstance(jr, MemoryError):
            with pytest.raises(MemoryError) as got:
                run()
            assert str(got.value) == str(jr)
            continue
        r = run()
        assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards]
        assert (r.shared_bytes, r.oracle) == (jr.shared_bytes, "probe")
    assert any(lo > 0 for lo, _ in peaks)


@pytest.fixture(scope="module")
def sharp_runs():
    """Two mixtral smoke TrainJobs (seeds 0 and 1) in both packages under
    one session each, unit runtimes pinned."""
    jcfg, _, cfg, _ = _setup(True)
    hc = dict(n_devices=2, device_budget_bytes=SHARP_BUDGET,
              fixed_unit_runtime=1e-3)
    js = JSession(JHydraConfig(**hc), profile=None)
    ps = Session(HydraConfig(**hc), device="cpu", profile=None)
    for seed, lr in enumerate(LRS):
        jparams, params = both_params(jcfg, cfg, seed)
        jl, pl = _loaders(cfg, seed)
        job = dict(lr=lr, epochs=1, steps_per_epoch=STEPS, batch=2, seq=SEQ)
        js.submit(JTrainJob(jcfg, jl, params=jparams, seed=seed, **job))
        ps.submit(TrainJob(cfg, pl, params=params, seed=seed, **job))
    jplan, plan = js.plan(), ps.plan()
    return dict(cfg=cfg, jcfg=jcfg, jplan=jplan, plan=plan,
                jrep=js.run(jplan), rep=ps.run(plan))


def test_sharp_plan_and_schedule_match_jax(sharp_runs):
    jplan, plan = sharp_runs["jplan"], sharp_runs["plan"]
    assert [j.partition for j in plan.jobs] == \
        [j.partition for j in jplan.jobs]
    assert plan.schedule["memory"] == jplan.schedule["memory"]
    n_shards = len(plan.jobs[0].partition["shards"])
    assert n_shards >= 2
    rep, jrep = sharp_runs["rep"], sharp_runs["jrep"]
    assert rep.unit_trace == jrep.unit_trace
    assert rep.train.units_executed == 2 * STEPS * 2 * n_shards


def test_sharp_losses_match_jax_and_plain_training(sharp_runs):
    cfg, jcfg = sharp_runs["cfg"], sharp_runs["jcfg"]
    rep, jrep = sharp_runs["rep"], sharp_runs["jrep"]
    for seed, lr in enumerate(LRS):
        np.testing.assert_allclose(rep.train.losses[seed],
                                   jrep.train.losses[seed], rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
        _, params = both_params(jcfg, cfg, seed)
        _, ref = train_sequential_reference(
            ModelTask(cfg, _loaders(cfg, seed)[1], lr=lr, epochs=1,
                      steps_per_epoch=STEPS, params=params, batch=2,
                      seq=SEQ), device="cpu")
        np.testing.assert_allclose(ref, rep.train.losses[seed],
                                   rtol=SEQ_TOL, atol=SEQ_TOL)


def test_spilled_inference_equals_forward_and_jax():
    """JAX ``tests/test_extensions.py``'s MoE case at 10 MB, where its
    25 MB keeps the f32 model whole: two shards; logits equal the whole
    forward's and JAX's at 2e-4."""
    jcfg, jparams, cfg, params = _setup(True)
    batch = next(iter(_loaders(cfg, 2)[1]))
    jinf = JSpilledInference(jcfg, jparams, device_budget_bytes=10 * 10**6,
                             batch=2, seq=SEQ)
    inf = SpilledInference(cfg, params, device_budget_bytes=10 * 10**6,
                           batch=2, seq=SEQ, device="cpu")
    assert inf.n_shards == jinf.n_shards >= 2
    out = inf(batch)
    with torch.no_grad():
        ref = api.forward(cfg, params, as_tensors(batch, "cpu"))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=MM_TOL,
                               atol=MM_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jinf(batch)),
                               rtol=MM_TOL, atol=MM_TOL)
    assert inf.bytes_moved == jinf.bytes_moved


def test_forward_only_store_holds_params_only():
    """A spilled-inference store keeps the params and no optimizer state
    (the JAX store's AdamW moments are never read on a forward-only
    path); its transfers are the JAX store's, a training store's are not
    changed."""
    jcfg, jparams, cfg, params = _setup(True)
    inf = SpilledInference(cfg, params, device_budget_bytes=10 * 10**6,
                           batch=2, seq=SEQ, device="cpu")
    jinf = JSpilledInference(jcfg, jparams, device_budget_bytes=10 * 10**6,
                             batch=2, seq=SEQ)
    assert inf.store.opt == {} and inf.store.shared_opt == {}
    assert jinf.store.opt                     # the reference keeps moments
    for s, js in zip(inf.partition.shards, jinf.partition.shards):
        assert inf.store.shard_transfer_bytes(s, train=False) == \
            jinf.store.shard_transfer_bytes(js, train=False)
    with pytest.raises(ValueError, match="forward-only"):
        inf.store.promote_shard(inf.partition.shards[0])
