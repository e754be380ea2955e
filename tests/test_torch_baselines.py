"""The port's Fig 8 baselines (``repro_torch.core.baselines``) against the
JAX package's, on the paper's workload shape.

``benchmarks/bench_end_to_end.py`` trains the bert-large-1b grid under
SHARP on 8 virtual devices at a 4.5 MB budget and replays the measured
per-shard unit runtimes under model, pipeline and task parallelism.  Here
four smoke models of that grid (seeds 0-3, the grid's learning rates,
bridged params, the same numpy-seeded data) go into both packages'
``ModelOrchestrator``: the partitions and host stores must agree, and,
given the same unit runtimes, every ``BaselineReport`` and the task-
parallel ``MemoryError`` must be equal.  Runtimes: a fixed 1 ms per unit
(as ``fixed_unit_runtime`` pins them), seeded draws, and the JAX run's
own measured runtimes copied onto the port's shards.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import ModelOrchestrator as JModelOrchestrator
from repro.core import ModelTask as JModelTask
from repro.core import baselines as jbl
from repro.core.partitioner import tree_bytes as jtree_bytes
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import HydraConfig, ModelOrchestrator, ModelTask
from repro_torch.core import baselines as bl
from repro_torch.core.partitioner import tree_bytes
from repro_torch.data import DataConfig, SyntheticTokens

N_MODELS, STEPS, SEQ = 4, 2, 64
N_DEVICES = 8
BUDGET = 4500 * 10**3      # bench_end_to_end.py: < one model with its state
LRS = (1e-3, 1e-4, 1e-5, 1e-6)      # benchmarks/common.py's grid


def _tasks():
    jcfg = jget_config("bert-large-1b", smoke=True).replace(
        dtype=jnp.float32)
    cfg = get_config("bert-large-1b", smoke=True).replace(dtype="float32")
    jtasks, tasks = [], []
    for i in range(N_MODELS):
        jparams = japi.init_params(jcfg, jax.random.PRNGKey(i))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        kw = dict(batch_size=2, seq_len=SEQ, vocab_size=cfg.vocab_size,
                  seed=i)
        common = dict(lr=LRS[i % len(LRS)], epochs=1, steps_per_epoch=STEPS,
                      seed=i, batch=2, seq=SEQ)
        jtasks.append(JModelTask(jcfg, JSyntheticTokens(JDataConfig(**kw)),
                                 params=jparams, **common))
        tasks.append(ModelTask(cfg, SyntheticTokens(DataConfig(**kw)),
                               params=params, **common))
    return jtasks, tasks


def _hc(cls, **kw):
    return cls(n_devices=N_DEVICES, device_budget_bytes=BUDGET,
               link_bw=2e9, **kw)


def _unit_runtimes(models):
    return [[(s.fwd_runtime, s.bwd_runtime) for s in m.partition.shards]
            for m in models]


@functools.lru_cache(maxsize=None)
def _orchestrators():
    """Both packages' orchestrators over the same four models, and the
    unit runtimes the JAX one measured when it trained (the port's has
    not trained)."""
    jtasks, tasks = _tasks()
    jorch = JModelOrchestrator(jtasks, _hc(JHydraConfig))
    jorch.train_models()
    orch = ModelOrchestrator(tasks, _hc(HydraConfig), device="cpu")
    return jorch, orch, _unit_runtimes(jorch.models)


def _set_runtimes(models, times):
    for m, rows in zip(models, times):
        for shard, (f, b) in zip(m.partition.shards, rows):
            shard.fwd_runtime, shard.bwd_runtime = f, b


def _runtimes(kind, measured):
    if kind == "measured":
        return measured
    if kind == "fixed":
        return [[(1e-3, 1e-3)] * len(rows) for rows in measured]
    rng = np.random.default_rng(0)
    return [[(float(rng.uniform(1e-3, 5e-3)), float(rng.uniform(2e-3, 1e-2)))
             for _ in rows] for rows in measured]


BASELINES = {
    "model_parallel": lambda b, ms, st: b.model_parallel(ms, N_DEVICES, st),
    "pipeline": lambda b, ms, st: b.pipeline(ms, N_DEVICES, st),
    "pipeline-micro3": lambda b, ms, st: b.pipeline(ms, N_DEVICES, st,
                                                    n_micro=3),
    "task_parallel": lambda b, ms, st: b.task_parallel(ms, N_DEVICES, st,
                                                       80 * 10**9),
}


def test_partitions_and_host_stores_match_jax():
    jorch, orch, _ = _orchestrators()
    for jm, m in zip(jorch.models, orch.models):
        assert [(s.seg_lo, s.seg_hi, s.param_bytes)
                for s in m.partition.shards] == \
            [(s.seg_lo, s.seg_hi, s.param_bytes)
             for s in jm.partition.shards]
        # task_parallel's byte count reads the host store's params
        assert tree_bytes(m.store.params) == jtree_bytes(jm.store.params)
    assert len(orch.models[0].partition.shards) >= 2


@pytest.mark.parametrize("kind", ["fixed", "seeded", "measured"])
@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_reports_match_jax(name, kind):
    jorch, orch, measured = _orchestrators()
    times = _runtimes(kind, measured)
    steps = [STEPS] * N_MODELS
    _set_runtimes(orch.models, times)
    _set_runtimes(jorch.models, times)
    rep = BASELINES[name](bl, orch.models, steps)
    jrep = BASELINES[name](jbl, jorch.models, steps)
    assert (rep.makespan, rep.avg_utilization, rep.name) == \
        (jrep.makespan, jrep.avg_utilization, jrep.name)
    assert rep.makespan > 0 and 0 < rep.avg_utilization <= 1


def test_task_parallel_raises_the_same_memory_error():
    jorch, orch, _ = _orchestrators()
    steps = [STEPS] * N_MODELS
    with pytest.raises(MemoryError) as jerr:
        jbl.task_parallel(jorch.models, N_DEVICES, steps, BUDGET)
    with pytest.raises(MemoryError) as err:
        bl.task_parallel(orch.models, N_DEVICES, steps, BUDGET)
    assert str(err.value) == str(jerr.value)
    assert "paper §2.2" in str(err.value)


def test_baselines_submodule_and_pipeline_bound():
    """``from repro_torch.core import baselines`` as the benchmarks import
    the JAX one; a pipeline never runs longer than model parallelism when
    it has at least as many micro-batches as stages."""
    from repro_torch.core import baselines
    assert baselines is bl
    _, orch, measured = _orchestrators()
    _set_runtimes(orch.models, _runtimes("seeded", measured))
    steps = [STEPS] * N_MODELS
    assert bl.pipeline(orch.models, N_DEVICES, steps).makespan <= \
        bl.model_parallel(orch.models, N_DEVICES, steps).makespan
