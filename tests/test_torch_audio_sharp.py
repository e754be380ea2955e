"""The encoder-decoder (whisper-medium smoke) and ViT* (vit-smoke) families
under Hydra's executor, beside the JAX package: the audio shard plan,
the ``bridge_group`` host tree, analytic partitions, the probe oracle's
entry activations, and two-model SHARP sessions.

Decisions must be equal: segments, refs, shard boundaries and bytes (at
JAX ``tests/test_orchestrator.py``'s 40 MB, ``tests/test_partitioner.py``'s
60 MB and budgets that cut inference, with JAX's ``MemoryError`` text
where the bridge alone does not fit), and the ``UnitEvent.key()``
sequence under ``fixed_unit_runtime``.  Values compare in float32:
losses 2e-4 against JAX (matmul chains), SHARP against the port's plain
training at 3e-4 (``tests/test_orchestrator.py``'s bound).

The reference's probe oracle gives every audio shard the encoder's entry
activation ``{"enc_x"}``: a candidate shard that starts past the bridge
reads ``act["x"]``, raises ``KeyError``, and its ``except Exception``
reports "does not fit", so at 60 MB JAX's probe refuses ``dec0``.  The
port's entry activation is the true one (``{"x", "enc"}`` past the
bridge), and its probe covers the plan; the test records both.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_weights import both_params

from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core import partitioner as jpt
from repro.core import shard_graph as jsg
from repro.core.sharp import HydraConfig as JHydraConfig
from repro_torch.api import HydraConfig, Session, TrainJob
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.orchestrator import (ModelTask,
                                           train_sequential_reference)
from repro_torch.core.sharp import ShardFunctions
from repro_torch.data.pipeline import as_tensors
from repro_torch.optim.optimizers import OptimizerConfig

AUDIO, VIT = "whisper-medium", "vit-300m"
MM_TOL = 2e-4
SEQ_TOL = 3e-4
SEQ, STEPS = 64, 2
PART_BUDGETS = (100 * 10**6, 60 * 10**6, 40 * 10**6, 20 * 10**6,
                15 * 10**6, 10 * 10**6)
SHARP_BUDGET = {AUDIO: 40 * 10**6, VIT: 3 * 10**6}
LRS = (1e-3, 1e-4)


@functools.lru_cache(maxsize=None)
def _setup(arch, f32=False):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if f32:
        jcfg, cfg = jcfg.replace(dtype=jnp.float32), cfg.replace(
            dtype="float32")
    jparams, params = both_params(jcfg, cfg, 0)
    return jcfg, jparams, cfg, params


class _Loader:
    """Numpy batches from a seed, the same arrays for both packages:
    frame embeddings, tokens and labels (audio), or patch embeddings and
    class labels (ViT*)."""

    def __init__(self, cfg, seed, batch=2, seq=SEQ):
        self.cfg, self.seed, self.batch, self.seq = cfg, seed, batch, seq

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        c, b, s = self.cfg, self.batch, self.seq
        while True:
            if c.family == "audio":
                yield {"enc_embeds": rng.standard_normal(
                           (b, c.encoder_len, c.d_model)).astype(np.float32),
                       "tokens": rng.integers(0, c.vocab_size, (b, s)).astype(
                           np.int32),
                       "labels": rng.integers(0, c.vocab_size, (b, s)).astype(
                           np.int32)}
            else:
                yield {"embeds": rng.standard_normal(
                           (b, s, c.d_model)).astype(np.float32),
                       "labels": rng.integers(0, c.vocab_size, (b, s)).astype(
                           np.int32)}


def test_audio_plan_matches_jax():
    jcfg, _, cfg, _ = _setup(AUDIO)
    jplan, plan = jsg.build_plan(jcfg), sg.build_plan(cfg)
    assert [(s.name, s.param_ref, s.shared, s.flops_weight)
            for s in plan.segments] == \
        [(s.name, s.param_ref, s.shared, s.flops_weight)
         for s in jplan.segments]
    assert [s.name for s in plan.segments] == [
        "frontend", "enc0", "enc1", "bridge", "dec0", "dec1", "head"]
    assert plan.shared_refs == jplan.shared_refs


def test_host_params_round_trip_matches_jax():
    """``prepare_host_params`` moves ``enc_final_norm`` and ``dec_pos``
    into one ``bridge_group`` (the bridge segment's own params), as JAX's
    does; ``restore_model_params`` gives the model tree back, values
    unchanged; the ``bridge_group`` ref resolves to the same leaves."""
    jcfg, jparams, cfg, params = _setup(AUDIO)
    jhost = jsg.prepare_host_params(jcfg, jax.tree.map(np.asarray, jparams))
    host = sg.prepare_host_params(cfg, params)
    assert sorted(host) == sorted(jhost)
    assert sorted(host["bridge_group"]) == ["dec_pos", "enc_final_norm"]
    for (path, leaf), (jpath, jleaf) in zip(
            jax.tree_util.tree_leaves_with_path(
                host, is_leaf=lambda v: isinstance(v, torch.Tensor)),
            jax.tree_util.tree_leaves_with_path(jhost)):
        assert jax.tree_util.keystr(path) == jax.tree_util.keystr(jpath)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    back = sg.restore_model_params(cfg, host)
    assert sorted(back) == sorted(params)
    assert back["dec_pos"] is params["dec_pos"]
    assert sg.prepare_host_params(cfg, host) == host     # idempotent
    seg = sg.build_plan(cfg).segments[3]
    assert sg.resolve_ref(host, seg.param_ref)["dec_pos"] is params["dec_pos"]


@pytest.mark.parametrize("train", [True, False])
def test_analytic_partitions_match_jax(train):
    """Same shards, bytes and runtimes at JAX's budgets in the bf16
    compute dtype (the act term's width, doubled for the enc
    pass-through), or JAX's MemoryError where a segment does not fit
    (training at 20 MB: the bridge alone, its dec_pos table's four
    copies)."""
    jcfg, jparams, cfg, params = _setup(AUDIO)
    jhost = jsg.prepare_host_params(jcfg, jax.tree.map(np.asarray, jparams))
    host = sg.prepare_host_params(cfg, params)
    counts = []
    for budget in PART_BUDGETS:
        kw = dict(budget_bytes=budget, batch=2, seq=SEQ, train=train)
        try:
            jr = jpt.partition(jcfg, jhost, jsg.build_plan(jcfg), **kw)
        except MemoryError as e:
            with pytest.raises(MemoryError) as got:
                pt.partition(cfg, host, sg.build_plan(cfg), **kw)
            assert str(got.value) == str(e)
            if train and budget == 20 * 10**6:
                assert "segment bridge alone" in str(e)
            continue
        r = pt.partition(cfg, host, sg.build_plan(cfg), **kw)
        assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards]
        assert (r.shared_bytes, r.budget_bytes, r.oracle) == \
            (jr.shared_bytes, jr.budget_bytes, jr.oracle)
        counts.append(len(r.shards))
    assert max(counts) >= 3


def test_reference_probe_refuses_dec0_where_the_port_covers():
    """whisper smoke, batch 2, seq 64, 60 MB: the analytic partition is
    ``[(0, 4), (4, 7)]`` in both packages; JAX's probe raises
    ``MemoryError`` naming ``dec0`` (its pilot of a shard from dec0 enters
    with ``{"enc_x"}`` and the KeyError reads as "does not fit"); the
    port's probe, entering such a shard with ``{"x", "enc"}``, gives a
    full, ordered cover."""
    jcfg, jparams, cfg, params = _setup(AUDIO)
    jhost = jsg.prepare_host_params(jcfg, jax.tree.map(np.asarray, jparams))
    host = sg.prepare_host_params(cfg, params)
    kw = dict(budget_bytes=60 * 10**6, batch=2, seq=SEQ)
    jr = jpt.partition(jcfg, jhost, jsg.build_plan(jcfg), **kw)
    r = pt.partition(cfg, host, sg.build_plan(cfg), **kw)
    assert [(s.seg_lo, s.seg_hi) for s in r.shards] == \
        [(s.seg_lo, s.seg_hi) for s in jr.shards] == [(0, 4), (4, 7)]
    with pytest.raises(MemoryError, match="segment dec0 alone"):
        jpt.partition(jcfg, jhost, jsg.build_plan(jcfg), oracle="probe",
                      **kw)
    probed = pt.partition(cfg, host, sg.build_plan(cfg), oracle="probe",
                          device="cpu", **kw)
    segs = [i for s in probed.shards for i in range(s.seg_lo, s.seg_hi)]
    assert segs == list(range(7))
    assert any(p.lo > 3 for p in probed.probes)     # a pilot past the bridge


def test_entry_act_spec_is_a_real_exit():
    """The probe's entry activation of a shard starting at each segment
    has the shapes and dtypes of a real forward unit's exit: the encoder
    stream up to the bridge, the decoder stream and the encoder output
    past it."""
    _, _, cfg, params = _setup(AUDIO)
    plan = sg.build_plan(cfg)
    host = sg.prepare_host_params(cfg, params)
    batch = as_tensors(next(iter(_Loader(cfg, 0))), "cpu")
    for lo in range(1, len(plan.segments)):
        spec = pt._entry_act_spec(cfg, plan, lo, 2, SEQ)
        part = pt.PartitionResult([pt.Shard(0, 0, lo), pt.Shard(
            1, lo, len(plan.segments))], 0, 0, "probe")
        fns = ShardFunctions(cfg, plan, part, OptimizerConfig())
        own = tuple(sg.resolve_ref(host, plan.segments[i].param_ref)
                    for i in range(lo))
        shared = {n: sg.resolve_ref(host, plan.shared_refs[n])
                  for i in range(lo) for n in plan.segments[i].shared}
        exit_act, _ = fns.fwd(part.shards[0])(own, shared, {}, batch)
        assert {k: (tuple(v.shape), v.dtype) for k, v in exit_act.items()} \
            == {k: (tuple(v.shape), v.dtype) for k, v in spec.items()}, lo
        assert set(spec) == ({"enc_x"} if lo <= 3 else {"x", "enc"})


def test_vit_batch_spec_and_plan():
    """ViT* takes the dense plan; the probe's batch carries bf16
    ``embeds`` and labels and no tokens, as JAX's batch spec does."""
    jcfg, _, cfg, _ = _setup(VIT)
    assert [s.name for s in sg.build_plan(cfg).segments] == \
        [s.name for s in jsg.build_plan(jcfg).segments]
    spec = pt._batch_spec(cfg, 2, SEQ)
    jspec = jpt._batch_spec(jcfg, 2, SEQ)
    assert sorted(spec) == sorted(jspec) == ["embeds", "labels"]
    assert tuple(spec["embeds"].shape) == tuple(jspec["embeds"].shape)
    assert spec["embeds"].dtype == torch.bfloat16
    aspec, jaspec = pt._batch_spec(_setup(AUDIO)[2], 2, SEQ), \
        jpt._batch_spec(_setup(AUDIO)[0], 2, SEQ)
    assert {k: tuple(v.shape) for k, v in aspec.items()} == \
        {k: tuple(v.shape) for k, v in jaspec.items()}


@functools.lru_cache(maxsize=None)
def _sharp_runs(arch):
    """Two TrainJobs (seeds 0 and 1) of ``arch`` smoke in f32 in both
    packages under one session each, unit runtimes pinned."""
    jcfg, _, cfg, _ = _setup(arch, f32=True)
    hc = dict(n_devices=2, device_budget_bytes=SHARP_BUDGET[arch],
              fixed_unit_runtime=1e-3)
    js = JSession(JHydraConfig(**hc), profile=None)
    ps = Session(HydraConfig(**hc), device="cpu", profile=None)
    for seed, lr in enumerate(LRS):
        jparams, params = both_params(jcfg, cfg, seed)
        job = dict(lr=lr, epochs=1, steps_per_epoch=STEPS, batch=2, seq=SEQ,
                   seed=seed)
        js.submit(JTrainJob(jcfg, _Loader(cfg, seed), params=jparams, **job))
        ps.submit(TrainJob(cfg, _Loader(cfg, seed), params=params, **job))
    jplan, plan = js.plan(), ps.plan()
    return dict(cfg=cfg, jcfg=jcfg, jplan=jplan, plan=plan,
                jrep=js.run(jplan), rep=ps.run(plan))


@pytest.mark.parametrize("arch", [AUDIO, VIT])
def test_sharp_plan_and_schedule_match_jax(arch):
    runs = _sharp_runs(arch)
    jplan, plan = runs["jplan"], runs["plan"]
    assert [j.partition for j in plan.jobs] == \
        [j.partition for j in jplan.jobs]
    assert plan.schedule["memory"] == jplan.schedule["memory"]
    bounds = [(s["seg_lo"], s["seg_hi"])
              for s in plan.jobs[0].partition["shards"]]
    assert len(bounds) >= 2
    if arch == AUDIO:      # enc crosses a shard boundary after the bridge
        assert any(lo > 3 for lo, _ in bounds)
    rep, jrep = runs["rep"], runs["jrep"]
    assert rep.unit_trace == jrep.unit_trace
    assert rep.train.units_executed == 2 * STEPS * 2 * len(bounds)


@pytest.mark.parametrize("arch", [AUDIO, VIT])
def test_sharp_losses_match_jax_and_plain_training(arch):
    runs = _sharp_runs(arch)
    cfg, jcfg = runs["cfg"], runs["jcfg"]
    rep, jrep = runs["rep"], runs["jrep"]
    for seed, lr in enumerate(LRS):
        np.testing.assert_allclose(rep.train.losses[seed],
                                   jrep.train.losses[seed], rtol=MM_TOL,
                                   atol=MM_TOL)
        _, params = both_params(jcfg, cfg, seed)
        _, ref = train_sequential_reference(
            ModelTask(cfg, _Loader(cfg, seed), lr=lr, epochs=1,
                      steps_per_epoch=STEPS, params=params, batch=2,
                      seq=SEQ), device="cpu")
        np.testing.assert_allclose(ref, rep.train.losses[seed],
                                   rtol=SEQ_TOL, atol=SEQ_TOL)
