"""Whole runs of every cell at their smoke sizes on the CPU, the card's
check skipped: sound runs come out correct, the result line has the
shape its readers expect, and the command refuses to run without a card."""

import json
import subprocess
import sys

import pytest

from _bench_util import EVAL_CELLS, ROOT, TRAIN_CELLS, smoke_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + EVAL_CELLS)
def test_sound_smoke_run_is_correct(cell):
    result, extra = smoke_run(cell, seed=3)
    assert result["correct"], (result["checks"], extra)
    assert list(result) == KEYS + ["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"


def test_traced_smoke_run_reports_per_layer_metrics():
    result, extra = smoke_run("bert1b.eval.spilled", seed=4, trace=True)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert {"launches_per_batch.eval", "pin_gb_s", "mfu.eval"} \
        <= set(result["metrics"])
    for key in ("device_ops", "idle_gaps"):
        assert len(result["breakdown"][key]) <= 10
    assert extra["trace"]["cpu_events"] > 0


def test_command_without_a_card_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "bert1b.eval.spilled",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
