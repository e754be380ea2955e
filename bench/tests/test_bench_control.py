"""The control — the plain reference in float8 products put in the
program's place — and the planted half-batch fault fail the cells'
comparisons at the smoke sizes; a state left unchanged reads 1."""

import pytest

from _bench_util import EVAL_CELLS, ROOT, TRAIN_CELLS


def _readings(cell, seed, device="cpu"):
    import torch

    from bench import harness
    r = harness.resolve(harness.load_spec(ROOT), cell, ROOT, smoke=True)
    dev = torch.device(device)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        read = r["kind"].control_readings(r, seed, dev)
    finally:
        torch.set_num_threads(threads)
    return read, r["limits"]


def _fails(readings, limits):
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("cell", TRAIN_CELLS + EVAL_CELLS)
def test_control_and_faults_fail(cell):
    read, limits = _readings(cell, 5)
    assert _fails(read["control"], limits), (read, limits)
    assert _fails(read["half_batch"], limits), (read, limits)
    if "unchanged" in read:
        assert read["unchanged"]["change_gap"] == 1.0
