"""The port's ``probe`` partition oracle against the JAX package's.

The JAX oracle compiles each candidate shard and reads XLA's
``memory_analysis()``; the port runs a pilot and reads the allocator (a
live-bytes count on the CPU), so the two peaks differ by construction.
What must be equal is everything around the peak: given the peaks JAX
computed (captured from its own ``probe_fits`` calls, no JAX file
changed), the port's rule and greedy loop must give JAX's shards field
for field, and the same ``MemoryError``.  Then the port's own pieces:
the live-bytes counter, the pilot's shapes, a pilot's error handling
(a deliberate deviation: JAX reports every exception as "does not
fit"), ``HydraConfig`` and ``partition``'s arguments.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import partitioner as jpt
from repro.core import shard_graph as jsg
from repro.core.sharp import HydraConfig as JHydraConfig
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.core import shard_graph as sg
from repro_torch.core.sharp import HydraConfig, ShardFunctions
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors
from repro_torch.optim.optimizers import OptimizerConfig

SEQ = 64
# tests/test_partitioner.py's 60 MB and a tighter budget: qwen3 and bert
# cut into two shards there (then a budget too small for the first
# segment); zamba2 cuts into two at 60 MB, and at 20 MB its first layer
# alone does not fit after the embedding took a shard
BUDGETS = {"qwen3-0.6b": (60 * 10**6, 20 * 10**6, 10_000),
           "bert-large-1b": (60 * 10**6, 6 * 10**6, 10_000),
           "zamba2-1.2b": (60 * 10**6, 20 * 10**6)}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams, params = both_params(jcfg, cfg, 0)
    jhost = jsg.prepare_host_params(jcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jhost, cfg, params


@functools.lru_cache(maxsize=None)
def _jax_probe(arch, budgets=None):
    """JAX's probe partitions of ``arch`` at ``budgets`` (default its
    ``BUDGETS``: and at one too small for a segment), with the peak of
    every candidate JAX compiled: ``(results, peaks)``.  Each candidate
    compiles once per arch (the compiled module is reused across
    budgets)."""
    jcfg, jhost, _, _ = _setup(arch)
    plan = jsg.build_plan(jcfg)
    peaks, compiled, cur = {}, {}, {}
    orig_fits = jpt.probe_fits
    orig_compile = jax.stages.Lowered.compile
    orig_ma = jax.stages.Compiled.memory_analysis

    def fits(cfg, params, plan, lo, hi, *a, **kw):
        cur["key"] = (lo, hi)
        return orig_fits(cfg, params, plan, lo, hi, *a, **kw)

    def compile_once(self, *a, **kw):
        if cur["key"] not in compiled:
            compiled[cur["key"]] = orig_compile(self, *a, **kw)
        return compiled[cur["key"]]

    def memory_analysis(self):
        ma = orig_ma(self)
        peaks[cur["key"]] = (ma.argument_size_in_bytes
                             + ma.output_size_in_bytes
                             + ma.temp_size_in_bytes)
        return ma

    mp = pytest.MonkeyPatch()
    mp.setattr(jpt, "probe_fits", fits)
    mp.setattr(jax.stages.Lowered, "compile", compile_once)
    mp.setattr(jax.stages.Compiled, "memory_analysis", memory_analysis)
    results = {}
    try:
        for budget in budgets or BUDGETS[arch]:
            try:
                results[budget] = jpt.partition(
                    jcfg, jhost, plan, budget_bytes=budget, batch=2,
                    seq=SEQ, oracle="probe")
            except MemoryError as e:
                results[budget] = e
    finally:
        mp.undo()
    return results, peaks


@pytest.mark.parametrize("arch", sorted(BUDGETS))
def test_rule_and_greedy_loop_match_jax_given_its_peaks(arch):
    """(i) JAX's peaks in, JAX's shards out: the port's rule and loop make
    every decision JAX's do, and a budget too small for a segment raises
    JAX's MemoryError text."""
    _, _, cfg, params = _setup(arch)
    results, peaks = _jax_probe(arch)
    plan = sg.build_plan(cfg)
    shard_counts, raised = [], 0
    for budget, jr in results.items():
        run = functools.partial(
            pt.partition, cfg, params, plan, budget_bytes=budget, batch=2,
            seq=SEQ, oracle="probe", _peaks=lambda lo, hi: peaks[(lo, hi)])
        if isinstance(jr, MemoryError):
            with pytest.raises(MemoryError) as e:
                run()
            assert str(e.value) == str(jr)
            raised += 1
            continue
        r = run()
        assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards]
        assert (r.shared_bytes, r.budget_bytes, r.oracle) == \
            (jr.shared_bytes, jr.budget_bytes, jr.oracle) == \
            (r.shared_bytes, budget, "probe")
        # one pilot per candidate, as JAX's loop queries them
        assert len({(p.lo, p.hi) for p in r.probes}) == len(r.probes)
        shard_counts.append(len(r.shards))
    assert max(shard_counts) >= 2 and raised == 1


def test_live_bytes_counts_the_exact_peak():
    """(ii) A known allocate/free pattern: the peak is 33,000 B."""
    with pt.LiveBytes() as c:
        a = torch.zeros(1000)                        # 4,000 B
        b = torch.ones(250)                          # +1,000 -> 5,000
        del a                                        # -> 1,000
        d = torch.empty(2000, dtype=torch.float64)   # +16,000 -> 17,000
        v = d[10:]                                   # a view: no bytes
        e = d + 1                                    # +16,000 -> 33,000
        v.add_(1)                                    # in place: no bytes
        del d, e, v                                  # -> 1,000
        f = torch.zeros(3000)                        # +12,000 -> 13,000
    assert (c.peak, c.live) == (33_000, 13_000)
    del b, f
    assert c.live == 0


def test_adding_a_segment_never_lowers_the_counted_peak():
    """(iii) On the CPU, pilots of [lo, hi) and [lo, hi + 1)."""
    _, _, cfg, params = _setup("qwen3-0.6b")
    plan = sg.build_plan(cfg)
    n = len(plan.segments)
    for lo in (0, 1):
        peaks = [pt.pilot_peak(cfg, params, plan, lo, hi, 2, SEQ,
                               device="cpu")
                 for hi in range(lo + 1, n + 1)]
        assert all(p == c for p, c in peaks)          # the CPU's is counted
        assert all(b[0] >= a[0] for a, b in zip(peaks, peaks[1:]))


def test_cpu_probe_partition_is_an_ordered_cover():
    """(iv) ``test_probe_oracle_agrees_with_analytic_on_fit``'s setup
    through the port's probe on the CPU; the oracle name on both."""
    _, _, cfg, params = _setup("qwen3-0.6b")
    plan = sg.build_plan(cfg)
    before = pt.pilot_peak.pilots
    res = pt.partition(cfg, params, plan, budget_bytes=60 * 10**6, batch=2,
                       seq=SEQ, oracle="probe", device="cpu")
    segs = [i for s in res.shards for i in range(s.seg_lo, s.seg_hi)]
    assert segs == list(range(len(plan.segments)))
    assert pt.pilot_peak.pilots - before == len(res.probes)
    assert all(p.peak == p.counted > 0 and p.seconds > 0
               for p in res.probes)
    results, _ = _jax_probe("qwen3-0.6b")
    assert res.oracle == results[60 * 10**6].oracle == "probe"


def _breaking(plan, exc, package):
    seg = plan.segments[1]

    def boom(*a, **kw):
        raise exc
    segs = list(plan.segments)
    segs[1] = dataclasses.replace(seg, apply=boom)
    return dataclasses.replace(plan, segments=segs) if package == "torch" \
        else type(plan)(plan.cfg, segs, plan.shared_refs, plan.loss)


def test_pilot_errors_propagate_unlike_jax():
    """(v) A pilot that raises anything but running out of memory
    propagates in the port; JAX's probe reports the same failure as "does
    not fit".  A pilot out of memory does not fit, in both."""
    jcfg, jhost, cfg, params = _setup("qwen3-0.6b")
    args = (2, SEQ, 60 * 10**6, 0, 0.05)
    bad = _breaking(sg.build_plan(cfg), ValueError("shape"), "torch")
    with pytest.raises(ValueError, match="shape"):
        pt.probe_fits(cfg, params, bad, 0, 2, *args, device="cpu")
    jbad = _breaking(jsg.build_plan(jcfg), ValueError("shape"), "jax")
    assert jpt.probe_fits(jcfg, jhost, jbad, 0, 2, *args) is False
    oom = _breaking(sg.build_plan(cfg), torch.OutOfMemoryError("oom"),
                    "torch")
    record = []
    assert pt.probe_fits(cfg, params, oom, 0, 2, *args, device="cpu",
                         record=record) is False
    assert (record[0].peak, record[0].fits) == (None, False)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bert-large-1b",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_pilot_entry_activation_matches_a_real_exit(arch):
    """(vi) The entry activation a pilot makes has the shape and dtype of
    a real forward unit's exit activation (the compute dtype)."""
    cfg = get_config(arch, smoke=True)
    from repro_torch.models import api
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = sg.build_plan(cfg)
    part = pt.PartitionResult([pt.Shard(0, 0, 2), pt.Shard(
        1, 2, len(plan.segments))], 0, 0, "probe")
    fns = ShardFunctions(cfg, plan, part, OptimizerConfig())
    batch = as_tensors(next(iter(SyntheticTokens(DataConfig(
        batch_size=2, seq_len=SEQ, vocab_size=cfg.vocab_size)))), "cpu")
    own = tuple(sg.resolve_ref(params, plan.segments[i].param_ref)
                for i in range(2))
    shared = {n: sg.resolve_ref(params, plan.shared_refs[n])
              for i in range(2) for n in plan.segments[i].shared}
    exit_act, _ = fns.fwd(part.shards[0])(own, shared, {}, batch)
    spec = pt._entry_act_spec(cfg, plan, 2, 2, SEQ)
    assert {k: (tuple(v.shape), v.dtype) for k, v in exit_act.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in spec.items()}
    assert pt._entry_act_spec(cfg, plan, 0, 2, SEQ) == {}
    assert {k: v.dtype for k, v in pt._batch_spec(cfg, 2, SEQ).items()} \
        == {k: v.dtype for k, v in batch.items()}


def test_hydra_config_accepts_probe_and_rejects_unknown_as_jax():
    """(vii)"""
    assert HydraConfig(partition_oracle="probe").validate() \
        .partition_oracle == "probe"
    with pytest.raises(ValueError) as jerr:
        JHydraConfig(partition_oracle="xla").validate()
    with pytest.raises(ValueError) as err:
        HydraConfig(partition_oracle="xla").validate()
    assert str(err.value) == str(jerr.value)


def test_partition_takes_measure_arguments_as_jax():
    """(viii) ``measure`` and ``measure_batch`` are accepted and change
    nothing, in both packages."""
    jcfg, jhost, cfg, params = _setup("qwen3-0.6b")
    mb = {"tokens": np.zeros((2, SEQ), np.int32),
          "labels": np.zeros((2, SEQ), np.int32)}
    kw = dict(budget_bytes=20 * 10**6, batch=2, seq=SEQ)
    jr = jpt.partition(jcfg, jhost, jsg.build_plan(jcfg), measure=True,
                       measure_batch=mb, **kw)
    r = pt.partition(cfg, params, sg.build_plan(cfg), measure=True,
                     measure_batch=as_tensors(mb, "cpu"), **kw)
    base = pt.partition(cfg, params, sg.build_plan(cfg), **kw)
    assert [vars(s) for s in r.shards] == [vars(s) for s in jr.shards] \
        == [vars(s) for s in base.shards]
