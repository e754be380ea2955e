"""On the card: one smoke run of every cell through the harness, and
the control against the reference there.  Skips without a card."""

import pytest

from _bench_util import EVAL_CELLS, ROOT, TRAIN_CELLS, smoke_run


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these runs need the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS + EVAL_CELLS)
def test_smoke_run_on_card(cell, cuda):
    result, extra = smoke_run(cell, seed=3, device=cuda, trace=True)
    assert result["correct"], (result["checks"], extra)
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS + EVAL_CELLS)
def test_control_fails_on_card(cell, cuda):
    import torch

    from bench import harness
    r = harness.resolve(harness.load_spec(ROOT), cell, ROOT, smoke=True)
    dev = torch.device(cuda)
    read = r["kind"].control_readings(r, 5, dev)
    assert any(v > r["limits"][k] for k, v in read["control"].items())
