"""The port's spans (``repro_torch.tracing``) on a smoke SHARP training
run and a smoke ``EvalJob``: off without a profiler (no range, no event,
no clock, no record), on under ``torch.profiler`` with the tree and
attributes the benchmark's span metrics read, each span a profiler range
inside its host interval, and the same losses and schedule either way.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.api import EvalJob, HydraConfig, Session, TrainJob
from repro_torch.configs import get_config
from repro_torch.core.partitioner import tree_bytes
from repro_torch.data.pipeline import DataConfig, SyntheticTokens

ARCH, SEQ, BATCH, STEPS = "bert-large-1b", 32, 2, 2
# budgets that cut the smoke model into two shards
TRAIN_BUDGET, EVAL_BUDGET = 4 * 10**6, 15 * 10**5
SLACK_NS = 500_000                  # a range against its span's interval


def _cfg():
    return get_config(ARCH, smoke=True).replace(dtype="float32")


def _loader(cfg, seed):
    return SyntheticTokens(DataConfig(batch_size=BATCH, seq_len=SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed))


def _train():
    """Two models, two minibatches each, pinned unit runtimes, a hook that
    stops none; returns the session, its report and the stores in model
    order."""
    cfg = _cfg()
    s = Session(HydraConfig(n_devices=1, device_budget_bytes=TRAIN_BUDGET,
                            fixed_unit_runtime=1.0),
                device="cpu", profile=None)
    for i, lr in enumerate((1e-3, 1e-4)):
        s.submit(TrainJob(cfg, dataloader=_loader(cfg, i), lr=lr,
                          steps_per_epoch=STEPS, seed=i, batch=BATCH,
                          seq=SEQ, early_stop=lambda losses: False))
    stores = [m.store for m in s.train_execs]
    return s, s.run(), stores


def _eval(n_batches=3):
    cfg = _cfg()
    s = Session(HydraConfig(n_devices=1,
                            device_budget_bytes=EVAL_BUDGET),
                device="cpu", profile=None)
    # a loader of n_batches ends the job with StopIteration at the next
    batches = [b for b, _ in zip(_loader(cfg, 7), range(n_batches))]
    jid = s.submit(EvalJob(cfg, dataloader=batches, n_batches=n_batches + 1,
                           seed=3, batch=BATCH, seq=SEQ))
    return s, s.run().evals[jid]


def _profiled(fn):
    t0 = tracing._now()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.spans(since_ns=t0), prof


def _ancestors(s, by_id):
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


class _Count:
    def __init__(self):
        self.n = 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self


@pytest.mark.parametrize("run", [_train, _eval], ids=["train", "eval"])
def test_off_without_a_profiler(run, monkeypatch):
    ranges, clock, events = _Count(), _Count(), _Count()
    monkeypatch.setattr(tracing, "_range", ranges)
    monkeypatch.setattr(tracing, "_now", clock)
    monkeypatch.setattr(torch.cuda, "Event", events)
    before = len(tracing._ring)
    run()
    assert tracing.span("hydra.unit", model=0) is tracing._OFF
    assert len(tracing._ring) == before
    assert ranges.n == clock.n == events.n == 0


def test_training_spans_tree_attributes_and_bytes():
    (_, report, stores), spans, _ = _profiled(_train)
    by_id = {s.id: s for s in spans}
    names = {s.name for s in spans}
    assert {"hydra.partition", "hydra.store_build", "hydra.pilot",
            "hydra.schedule", "hydra.unit", "hydra.promote", "hydra.fwd",
            "hydra.bwd", "hydra.shared_grads", "hydra.opt_step",
            "hydra.demote", "hydra.minibatch_end", "hydra.step_shared",
            "hydra.early_stop", "hydra.data"} <= names
    units = [s for s in spans if s.name == "hydra.unit"]
    assert len(units) == report.train.units_executed
    n_shards = len(stores[0].partition.shards)
    assert n_shards >= 2
    for u in units:
        assert set(u.attrs) == {"model", "shard", "direction", "minibatch",
                                "prefetched"}
        assert u.parent is None
    for s in spans:
        up = _ancestors(s, by_id)
        if s.name in ("hydra.fwd", "hydra.bwd", "hydra.demote",
                      "hydra.shared_grads"):
            assert up[0] == "hydra.unit", (s, up)
        if s.name == "hydra.promote":
            assert up[0] in ("hydra.unit", "hydra.pilot"), (s, up)
        if s.name == "hydra.opt_step":
            assert up[0] in ("hydra.unit", "hydra.step_shared"), (s, up)
        if s.name in ("hydra.step_shared", "hydra.early_stop"):
            assert up[0] == "hydra.minibatch_end"
        if s.name == "hydra.store_build":
            assert s.attrs["bytes"] > 0 and s.attrs["model"] == ARCH
    # the bytes a promotion really copies, not the ledger's charge: the
    # unit's own, or the prefetch that the unit before it made for it
    ahead = None
    for u in units:
        store = stores[u.attrs["model"]]
        shard = store.partition.shards[u.attrs["shard"]]
        kids = [s for s in spans if s.parent == u.id]
        promotes = [s for s in kids if s.name == "hydra.promote"]
        mine = [s for s in promotes if "prefetch" not in s.attrs]
        if u.attrs["prefetched"]:
            assert mine == [] and ahead.attrs["shard"] == shard.index
            promote = ahead
        else:
            (promote,) = mine
        made = [s for s in promotes if s.attrs.get("prefetch")]
        assert len(made) <= 1
        ahead = made[0] if made else None
        weights = tree_bytes(store._own_params(shard)) + sum(
            tree_bytes(t) for t in store._shared_params(shard).values())
        moments = tree_bytes(store.opt[shard.index])
        if u.attrs["direction"] == "fwd":
            assert promote.attrs["bytes"] == weights
            assert weights != store.shard_transfer_bytes(shard)
        else:
            assert promote.attrs["bytes"] == weights + moments
            (demote,) = [s for s in kids if s.name == "hydra.demote"]
            assert demote.attrs["bytes"] == tree_bytes(
                store._own_params(shard)) + moments
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ns == s.end_ns - s.start_ns


def test_eval_spans_and_a_feed_that_ends():
    (_, result), spans, _ = _profiled(_eval)
    by_id = {s.id: s for s in spans}
    batches = [s for s in spans if s.name == "hydra.eval_batch"]
    assert [b.attrs["batch"] for b in batches] == [0, 1, 2, 3]
    for b in batches[:3]:
        kids = [s.name for s in spans if s.parent == b.id]
        assert kids[0] == "hydra.data" and kids[-1] == "hydra.loss"
        assert kids.count("hydra.fwd") == result["n_shards"] >= 2
        assert kids.count("hydra.promote") == result["n_shards"]
    # the feed's StopIteration leaves the last batch's data span, closed
    last = [s.name for s in spans if s.parent == batches[3].id]
    assert last == ["hydra.data"]
    assert len(result["losses"]) == 3
    for s in spans:
        if s.name == "hydra.fwd":
            assert _ancestors(s, by_id)[0] == "hydra.eval_batch"


@pytest.mark.parametrize("run", [_train, _eval], ids=["train", "eval"])
def test_every_span_is_a_profiler_range_inside_its_interval(run):
    _, spans, prof = _profiled(run)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("hydra."))
    assert len(ranges) == len(spans) > 0
    for s, (a, b, name) in zip(sorted(spans, key=lambda s: s.start_ns),
                               ranges):
        assert name == s.name
        assert abs(a - s.start_ns) <= SLACK_NS
        assert abs(b - s.end_ns) <= SLACK_NS


def test_spans_change_no_loss_and_no_schedule():
    _, off, _ = _train()
    (_, on, _), _, _ = _profiled(_train)
    assert on.train.losses == off.train.losses
    assert on.unit_trace == off.unit_trace
    (_, e_on), _, _ = _profiled(_eval)
    _, e_off = _eval()
    assert e_on["losses"] == e_off["losses"]


def test_spans_window_and_ring():
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("hydra.a", bytes=1) as outer:
            assert outer
            with tracing.span("hydra.b") as inner:
                inner.set(bytes=2)
    a, b = tracing.spans()
    assert (a.name, b.name, b.parent, a.parent) == ("hydra.a", "hydra.b",
                                                    a.id, None)
    assert (a.attrs, b.attrs) == ({"bytes": 1}, {"bytes": 2})
    assert tracing.spans(since_ns=b.start_ns) == [b]
    assert tracing.spans(until_ns=a.start_ns) == [a]
    with pytest.raises(StopIteration):
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("hydra.c"):
                raise StopIteration
    assert [s.name for s in tracing.spans()] == ["hydra.a", "hydra.b",
                                                 "hydra.c"]
    assert tracing._stack() == []
    tracing.clear()
    assert tracing.spans() == []


def test_a_torch_without_the_private_bindings_runs_with_spans_off(
        monkeypatch):
    import importlib
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    monkeypatch.delattr(torch._C._autograd, "_profiler_enabled")
    try:
        importlib.reload(tracing)
        (_, report, _), spans, _ = _profiled(_train)
        assert spans == [] and len(report.train.losses) > 0
        assert tracing.span("hydra.unit") is tracing._OFF
    finally:
        monkeypatch.undo()
        importlib.reload(tracing)
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("hydra.unit")


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


@pytest.mark.cuda
def test_on_the_card_a_span_times_its_work_and_adds_no_device_event():
    """A span around a pinned 256 MiB host-to-device copy and a matmul:
    its CUDA events give a device interval that covers the copy at a
    PCIe-like rate, and the profiler's device trace holds the same
    kernels and copies as without spans and no ``hydra.*`` entry."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a span's CUDA events time a card")
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8).pin_memory()
    a = torch.randn(2048, 2048, device="cuda")

    def work(spans):
        with (tracing.span("hydra.promote", bytes=n) if spans
              else tracing._OFF):
            dev = host.to("cuda", non_blocking=True)
        with tracing.span("hydra.fwd") if spans else tracing._OFF:
            b = a @ a
        return dev, b

    work(False)                              # warm the matmul and the copy
    torch.cuda.synchronize()
    tracing.clear()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as bare:
        work(False)
        torch.cuda.synchronize()
    assert tracing.spans() == []
    with profile(activities=acts) as traced:
        work(True)
        torch.cuda.synchronize()
    promote, fwd = tracing.spans()
    assert 0 < promote.device_ns and 0 < fwd.device_ns
    gb_s = n / promote.device_ns
    assert 5 < gb_s < 100, gb_s              # pinned H2D: PCIe/NVLink-C2C
    on, off = _device_events(traced), _device_events(bare)
    assert not [x for x in on if x.startswith("hydra.")], on
    assert sorted(on) == sorted(off)
    tracing.clear()
