"""The readers of the ``program_span`` metrics: the right number on a
list of spans made up here, nothing where the program records no spans
(or has no tracing module, as a program before spans has not), and a
value in a traced smoke run of each cell that lists them."""

import sys

import pytest

from _bench_util import EVAL_CELLS, ROOT, TRAIN_CELLS, smoke_run

from bench import harness

SPEC = harness.load_spec(ROOT)
SPAN_METRICS = {m["name"]: m["workloads"] for m in SPEC["per_layer"]
                if m["source"] == "program_span"}
T0 = 1_000_000_000.0                    # the window's start, epoch s
MS = 1_000_000


def _span(i, name, start_ms, device_ms, parent=None, **attrs):
    from repro_torch.tracing import Span
    start = round(T0 * 1e9) + start_ms * MS
    return Span(i, parent, name, attrs, start, start + device_ms * MS,
                device_ms * MS)


# a window of 10 s: before it, a unit that began earlier and is left out
SPANS = [
    _span(1, "hydra.unit", -5, 400, direction="fwd"),
    _span(2, "hydra.unit", 0, 300, direction="fwd"),
    _span(3, "hydra.promote", 0, 100, 2, bytes=5 * 10**9),
    _span(4, "hydra.unit", 300, 1500, direction="bwd"),
    _span(5, "hydra.promote", 300, 300, 4, bytes=16 * 10**9),
    _span(6, "hydra.opt_step", 900, 200, 4),
    _span(7, "hydra.demote", 1100, 400, 4, bytes=12 * 10**9),
    _span(8, "hydra.unit", 1800, 250, direction="fwd"),
    _span(9, "hydra.unit", 2050, 1700, direction="bwd"),
    _span(10, "hydra.step_shared", 3750, 300),
    _span(11, "hydra.opt_step", 3760, 100, 10),
    _span(12, "hydra.opt_step", 3770, 50, 11),     # nested: not counted
    _span(13, "hydra.eval_batch", 4000, 500, batch=0),
    _span(14, "hydra.fwd", 4100, 150, 13),
    _span(15, "hydra.fwd", 4250, 170, 13),
    _span(16, "hydra.eval_batch", 4500, 450, batch=1),
    _span(17, "hydra.fwd", 4600, 310, 16),
    _span(18, "hydra.eval_batch", 5000, 400, batch=2),
    _span(19, "hydra.fwd", 5100, 300, 18),
    _span(20, "hydra.eval_batch", 5400, 1, batch=3),   # the feed ended
    _span(21, "hydra.fwd", 12000, 999),                # after the window
]
EXPECTED = {
    "unit_ms.fwd": 275.0,                       # median of 300, 250
    "unit_ms.bwd": 1600.0,                      # median of 1500, 1700
    "optimizer_share.train": 100 * 0.3 / 10,    # 200 + 100 ms of 10 s
    "promote_gb_s.train": 21e9 / 0.4e9,         # 21 GB in 400 ms
    "promote_gb_s.eval": 21e9 / 0.4e9,
    "demote_gb_s.train": 12e9 / 0.4e9,
    "fwd_ms.eval": 310.0,                       # median of 320, 310, 300
}


def _ctx(trace=True):
    return {"t0_epoch": T0, "window_s": 10.0,
            "trace": {"window_s": 10.0} if trace else None}


@pytest.fixture
def fake_spans(monkeypatch):
    from repro_torch import tracing
    kept = []

    def spans(since_ns=None, until_ns=None):
        return [s for s in kept if since_ns <= s.start_ns <= until_ns]
    monkeypatch.setattr(tracing, "spans", spans)
    return kept


def test_every_span_metric_is_tested_here():
    assert set(SPAN_METRICS) == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_made_up_spans(name, fake_spans):
    fake_spans.extend(SPANS)
    value = harness.load_reader(name, ROOT).read(_ctx())
    assert value == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_spans_gives_none(name, fake_spans, monkeypatch):
    read = harness.load_reader(name, ROOT).read
    assert read(_ctx()) is None                     # none recorded
    fake_spans.extend(SPANS)
    assert read(_ctx(trace=False)) is None          # no traced window
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(_ctx()) is None                     # no tracing module


@pytest.mark.parametrize("cell", TRAIN_CELLS + EVAL_CELLS)
def test_traced_smoke_run_reports_its_span_metrics(cell):
    result, _ = smoke_run(cell, seed=5, trace=True)
    mine = {n for n, cells in SPAN_METRICS.items() if cell in cells}
    assert mine
    for name in mine:
        assert result["metrics"][name]["value"] > 0, name
