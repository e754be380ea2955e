"""The SHARP executor's prefetch (double-buffered promotion, paper §4.6):
while a unit computes, the shard of the unit the loop will pick next is
copied to the device, and the next unit takes it only if it is that unit
and the host store took no write to what was copied since.

On the CPU the copy is made at once, so these tests hold the speculation,
the validity rule and the ``prefetched`` span attribute: the prefetch
engages under LRTF where two shards fit, never under the random
scheduler, where they do not or without ``enable_double_buffer``, never
across a model's minibatch end, and the schedule, ledger and losses stay
the JAX package's and plain training's.  The ``cuda`` test holds the
copy stream on the card: the copy overlaps compute queued on the compute
stream, and a unit on the prefetched shard gives the bits of a unit on
its leaves promoted one at a time.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro_torch import tracing
from repro_torch.api import HydraConfig, Session, TrainJob
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.orchestrator import (ModelTask,
                                           train_sequential_reference)
from repro_torch.core.sharp import ShardFunctions
from repro_torch.core.spilling import HostModelStore, to_device
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.tree import tree_leaves, tree_map

ARCH, SEQ, BATCH = "bert-large-1b", 32, 2
# the smoke model whole in one shard: two such shards and a unit's
# activations fit ROOMY and not TIGHT; SPLIT cuts it into two shards, and
# two of those fit
ROOMY, TIGHT, SPLIT = 20 * 10**6, 6 * 10**6, 4 * 10**6
MM_TOL, SEQ_TOL = 2e-4, 3e-4
LRS = (1e-3, 1e-4)


def _cfgs():
    return (jget_config(ARCH, smoke=True).replace(dtype=jnp.float32),
            get_config(ARCH, smoke=True).replace(dtype="float32"))


def _params(jcfg, seed):
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _loaders(cfg, seed):
    kw = dict(batch_size=BATCH, seq_len=SEQ, vocab_size=cfg.vocab_size,
              seed=seed)
    return JSyntheticTokens(JDataConfig(**kw)), SyntheticTokens(
        DataConfig(**kw))


def _profiled(fn):
    t0 = tracing._now()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.spans(since_ns=t0)


def _units_and_prefetches(spans):
    """The ``hydra.unit`` spans in order, and for each the prefetch it
    made (its ``hydra.promote`` child with ``prefetch``), or None."""
    units = [s for s in spans if s.name == "hydra.unit"]
    made = {s.parent: s for s in spans
            if s.name == "hydra.promote" and s.attrs.get("prefetch")}
    assert set(made) <= {u.id for u in units}
    return units, [made.get(u.id) for u in units]


@pytest.mark.parametrize("scheduler,budget,double_buffer,engaged", [
    ("lrtf", ROOMY, True, True), ("lrtf", TIGHT, True, False),
    ("random", ROOMY, True, False), ("lrtf", ROOMY, False, False)],
    ids=["lrtf-room", "lrtf-no-room", "random", "no-double-buffer"])
def test_prefetch_keeps_the_jax_schedule_and_losses(scheduler, budget,
                                                    double_buffer, engaged):
    """Two models on two virtual devices: the same ``unit_trace``, ledger
    and losses as the JAX package, and every prefetch the next unit's."""
    jcfg, cfg = _cfgs()
    hc = dict(n_devices=2, device_budget_bytes=budget, scheduler=scheduler,
              enable_double_buffer=double_buffer, fixed_unit_runtime=1e-3)
    js = JSession(JHydraConfig(**hc), profile=None)
    ps = Session(HydraConfig(**hc), device="cpu", profile=None)
    for seed, lr in enumerate(LRS):
        jparams, params = _params(jcfg, seed)
        jl, pl = _loaders(cfg, seed)
        job = dict(lr=lr, epochs=1, steps_per_epoch=2, batch=BATCH, seq=SEQ)
        js.submit(JTrainJob(jcfg, jl, params=jparams, seed=seed, **job))
        ps.submit(TrainJob(cfg, pl, params=params, seed=seed, **job))
    jrep = js.run()
    rep, spans = _profiled(ps.run)
    assert rep.unit_trace == jrep.unit_trace
    for mid in (0, 1):
        np.testing.assert_allclose(rep.train.losses[mid],
                                   jrep.train.losses[mid],
                                   rtol=MM_TOL, atol=MM_TOL)
    for dev in rep.train.transfer:
        assert vars(rep.train.transfer[dev]) == {
            k: v for k, v in vars(jrep.train.transfer[dev]).items()
            if k in vars(rep.train.transfer[dev])}
    units, made = _units_and_prefetches(spans)
    assert len(units) == len(rep.unit_trace)
    taken = [u.attrs["prefetched"] for u in units]
    if not engaged:
        assert made == [None] * len(units) and not any(taken)
        return
    # the first unit has nothing before it; every prefetch is taken by
    # the next unit, for its shard
    assert taken[0] is False and sum(taken) > 0
    assert sum(p is not None for p in made) == sum(taken)
    for u, p, nxt in zip(units, made, units[1:] + [None]):
        if p is not None:
            assert nxt.attrs["prefetched"] is True
            assert p.attrs["shard"] == nxt.attrs["shard"]


def test_one_model_never_prefetches_across_its_minibatch_end():
    """One model in two shards, three minibatches: a minibatch's second
    forward and its backwards take the copies made while the unit before
    them ran; its first forward, which follows the shared leaves' step,
    never does.  Losses are plain training's."""
    jcfg, cfg = _cfgs()
    _, params = _params(jcfg, 0)
    s = Session(HydraConfig(n_devices=1, device_budget_bytes=SPLIT),
                device="cpu", profile=None)
    s.submit(TrainJob(cfg, _loaders(cfg, 0)[1], params=params, seed=0,
                      lr=LRS[0], epochs=1, steps_per_epoch=3, batch=BATCH,
                      seq=SEQ))
    rep, spans = _profiled(s.run)
    assert len(s.train_execs[0].partition.shards) == 2
    units, made = _units_and_prefetches(spans)
    assert [(u.attrs["direction"], u.attrs["shard"]) for u in units] == \
        [("fwd", 0), ("fwd", 1), ("bwd", 1), ("bwd", 0)] * 3
    assert [u.attrs["prefetched"] for u in units] == \
        [False, True, True, True] * 3
    assert [p is not None for p in made] == [True, True, True, False] * 3
    _, params = _params(jcfg, 0)
    _, ref = train_sequential_reference(
        ModelTask(cfg, _loaders(cfg, 0)[1], lr=LRS[0], epochs=1,
                  steps_per_epoch=3, params=params, batch=BATCH, seq=SEQ),
        device="cpu")
    np.testing.assert_allclose(rep.train.losses[0], ref, rtol=SEQ_TOL,
                               atol=SEQ_TOL)


def _store(budget, cfg, device="cpu"):
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = sg.build_plan(cfg)
    part = pt.partition(cfg, params, plan, budget_bytes=budget,
                        batch=BATCH, seq=SEQ, train=True)
    ocfg = OptimizerConfig(lr=1e-3)
    store = HostModelStore(cfg, plan, params, ocfg, part, device=device)
    return plan, part, store, ocfg


def _equal(a, b):
    """Same tree structure (``tree_map`` refuses another) and bits."""
    return all(tree_leaves(tree_map(torch.equal, a, b)))


def test_merged_stack_slices_unmerge_to_the_refs_views():
    refs = [None, ("stack_slice", "layers", 0, 1),
            ("stack_slice", "layers", 1, 3), ("stack_slice", "layers", 4, 5),
            ("stack_slice", "blocks", 5, 6), ("final_norm",),
            ("stack_slice", "layers", 5, 6)]
    runs = sg.merge_stack_slices(refs)
    assert runs == [(None, None),
                    (("stack_slice", "layers", 0, 3), [(0, 1), (1, 3)]),
                    (("stack_slice", "layers", 4, 5), [(0, 1)]),
                    (("stack_slice", "blocks", 5, 6), [(0, 1)]),
                    (("final_norm",), None),
                    (("stack_slice", "layers", 5, 6), [(0, 1)])]
    params = {"layers": {"w": torch.arange(7.0)[:, None] * torch.ones(7, 2)},
              "blocks": {"w": torch.arange(7.0)[:, None]},
              "final_norm": {"scale": torch.ones(3)}}
    views = sg.unmerge(runs, [sg.resolve_ref(params, r) for r, _ in runs])
    assert _equal(views, tuple(sg.resolve_ref(params, r) for r in refs))


def _leaf_by_leaf(store, shard):
    """The shard's own and shared leaves and moments copied one leaf at a
    time, apart from the merged copies under test."""
    return (*store.promote_shard_params(shard),
            to_device(store.opt[shard.index], store.device))


def test_claim_refuses_a_copy_the_host_store_wrote_since():
    plan, part, store, _ = _store(SPLIT, _cfgs()[1])
    s0, s1 = part.shards
    # a write to the other shard's slice of the stacked leaves leaves a
    # copy of this shard current
    pf = store.prefetch_shard(s0, opt_state=True)
    own1, _, opt1 = store.promote_shard(s1)
    store.demote_shard(s1, tree_map(lambda t: t + 1.0, own1), opt1)
    got = store.claim(pf, s0)
    assert got is not None and _equal(got, _leaf_by_leaf(store, s0))
    assert _equal(store.promote_shard(s0), got)
    # a weights-only copy holds no moments; a copy is for its own shard
    pf = store.prefetch_shard(s1, opt_state=False)
    assert pf.tensors[2] is None and store.claim(pf, s0) is None
    assert _equal(store.claim(pf, s1)[:2], store.promote_shard_params(s1))
    # a demotion of the shard, or the shared leaves' step, makes it stale
    pf = store.prefetch_shard(s0, opt_state=True)
    own0, _, opt0 = store.promote_shard(s0)
    store.demote_shard(s0, tree_map(lambda t: t + 1.0, own0), opt0)
    assert store.claim(pf, s0) is None
    assert not _equal(pf.tensors[0], store.promote_shard(s0)[0])
    pf = store.prefetch_shard(s0, opt_state=True)
    table = sg.resolve_ref(store.params, plan.shared_refs["embed"])
    store.accumulate_shared_grads(
        {"embed": tree_map(torch.ones_like, table)})
    store.step_shared()
    assert store.claim(pf, s0) is None
    assert store.claim(store.prefetch_shard(s0, opt_state=True), s0) \
        is not None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the prefetch's copy stream runs on a "
                    "card")
    return "cuda"


@pytest.mark.cuda
def test_on_the_card_the_copy_overlaps_compute_and_changes_no_bit(cuda):
    """bert-large-1b at its full width, two layers, one shard (~1.2 GB of
    weights and moments pinned): the prefetch's copies run on the copy
    stream while matmuls queued before them run on the compute stream,
    and a forward and a backward unit on the claimed copy give exactly
    the outputs of its leaves promoted one at a time."""
    cfg = get_config(ARCH).replace(n_layers=2)
    plan, part, store, ocfg = _store(64 * 10**9, cfg, device=cuda)
    (shard,) = part.shards
    fns = ShardFunctions(cfg, plan, part, ocfg)
    batch = {k: torch.as_tensor(v).to(cuda) for k, v in next(iter(
        SyntheticTokens(DataConfig(batch_size=BATCH, seq_len=SEQ,
                                   vocab_size=cfg.vocab_size,
                                   seed=0)))).items()}

    def unit(own, shared, opt_state):
        _, loss = fns.fwd(shard)(own, shared, {}, batch)
        return loss, fns.bwd(shard)(own, shared, {}, batch)

    want = unit(*_leaf_by_leaf(store, shard))
    compute, copy = torch.cuda.current_stream(), torch.cuda.Stream()
    assert compute != copy
    a = torch.randn(8192, 8192, device=cuda)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    marks[0].record(compute)
    for _ in range(40):                       # ~0.1-0.8 s of f32 matmuls
        b = a @ a
    marks[1].record(compute)
    pf = store.prefetch_shard(shard, opt_state=True, stream=copy)
    marks[2].record(copy)
    pf.done.synchronize()
    # the copies landed, on their stream, while the matmuls still ran
    assert not marks[1].query()
    own = pf.tensors[0]
    with torch.cuda.stream(copy):
        back = [t.to("cpu") for t in tree_leaves(own)]
    assert not marks[1].query()
    assert _equal(back, tree_leaves(store._own_params(shard)))
    got = store.claim(pf, shard)
    torch.cuda.synchronize()
    t = [marks[0].elapsed_time(m) for m in marks]     # ms from the first
    assert t[2] < t[1], t
    del b
    assert _equal(unit(*got), want)
