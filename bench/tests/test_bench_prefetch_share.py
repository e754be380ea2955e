"""The reader of ``prefetch_share.train``: the share of the window's shard
units that took a prefetched shard, on spans made up here; nothing where
the program records no spans or its units carry no ``prefetched``
attribute (a program before the prefetch); and a value in a traced
smoke run of the training cell with the metric listed."""

import sys

import pytest

from _bench_util import ROOT, TRAIN_CELLS, smoke_run

from bench import harness

NAME = "prefetch_share.train"
T0 = 1_000_000_000.0                    # the window's start, epoch s
MS = 1_000_000


def _unit(i, start_ms, **attrs):
    from repro_torch.tracing import Span
    start = round(T0 * 1e9) + start_ms * MS
    return Span(i, None, "hydra.unit", attrs, start, start + 100 * MS,
                100 * MS)


def _ctx(trace=True):
    return {"t0_epoch": T0, "window_s": 10.0,
            "trace": {"window_s": 10.0} if trace else None}


def _read(ctx):
    return harness.load_reader(NAME, ROOT).read(ctx)


@pytest.fixture
def fake_spans(monkeypatch):
    from repro_torch import tracing
    kept = []

    def spans(since_ns=None, until_ns=None):
        return [s for s in kept if since_ns <= s.start_ns <= until_ns]
    monkeypatch.setattr(tracing, "spans", spans)
    return kept


def test_share_of_the_windows_units(fake_spans):
    fake_spans.extend([
        _unit(1, -5, direction="fwd", prefetched=False),   # before it
        _unit(2, 0, direction="fwd", prefetched=False),
        _unit(3, 100, direction="fwd", prefetched=True),
        _unit(4, 200, direction="bwd", prefetched=True),
        _unit(5, 300, direction="bwd", prefetched=True),
        _unit(6, 12000, direction="fwd", prefetched=False),  # after it
    ])
    assert _read(_ctx()) == pytest.approx(75.0, rel=1e-12)


def test_none_without_spans_or_the_attribute(fake_spans, monkeypatch):
    assert _read(_ctx()) is None                        # none recorded
    fake_spans.extend([_unit(1, 0, direction="fwd"),
                       _unit(2, 100, direction="bwd")])
    assert _read(_ctx()) is None                        # no attribute
    fake_spans.append(_unit(3, 200, direction="fwd", prefetched=False))
    assert _read(_ctx()) == 0.0
    assert _read(_ctx(trace=False)) is None             # no traced window
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert _read(_ctx()) is None                        # no tracing module


# the entry as BENCHMARK.json would list it; it is not listed there yet,
# because each ``program_span`` metric listed there needs its case in
# ``test_bench_span_metrics.py``, which has none for it
ENTRY = {"name": NAME, "unit": "%", "better": "higher",
         "source": "program_span", "layer": "spilling",
         "moves": "train_tok_s", "workloads": TRAIN_CELLS}


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_traced_smoke_run_reports_it(cell, monkeypatch):
    spec = harness.load_spec(ROOT)
    if NAME not in {m["name"] for m in spec["per_layer"]}:
        spec["per_layer"].append(ENTRY)
    monkeypatch.setattr(harness, "load_spec", lambda root=ROOT: spec)
    result, _ = smoke_run(cell, seed=6, trace=True)
    assert 0 < result["metrics"][NAME]["value"] <= 100
