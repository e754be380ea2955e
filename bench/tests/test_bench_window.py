"""The training window's clock: it opens only once every model has made
its checked steps and no other model has begun its current minibatch,
counts the minibatches completed after that, and stops each model at
its first boundary past the window."""

from types import SimpleNamespace

import pytest

from _bench_util import ROOT  # noqa: F401  (puts bench/ on the path)

from bench.kinds.train import _TrainClock


def _clock(n, checked=2, seconds=3600.0):
    execs = [SimpleNamespace(cursor=0, done=False) for _ in range(n)]
    steps, opened = [], []
    clock = _TrainClock(n, execs, checked, seconds,
                        lambda i, k: steps.append((i, k)),
                        lambda: opened.append(True))
    return clock, execs, [clock.hook(i) for i in range(n)], steps, opened


@pytest.mark.parametrize("n", [2, 3, 4])
def test_opens_after_every_models_checked_steps(n):
    clock, _, hooks, steps, opened = _clock(n)
    for i in range(n):
        assert hooks[i]([]) is False
    assert clock.t0 is None and not opened
    for i in range(n - 1):
        hooks[i]([])
        assert clock.t0 is None
    hooks[n - 1]([])
    assert clock.t0 is not None and opened == [True]
    assert sorted(steps) == [(i, k) for i in range(n) for k in (1, 2)]


@pytest.mark.parametrize("begun", [0, 1])
def test_waits_for_a_boundary_where_no_other_minibatch_has_begun(begun):
    clock, execs, hooks, _, opened = _clock(3, checked=1)
    hooks[0]([])
    hooks[1]([])
    execs[begun].cursor = 1            # its next forward ran already
    hooks[2]([])
    assert clock.t0 is None and not opened
    execs[begun].cursor = 0
    hooks[begun]([])                   # its minibatch completes
    assert clock.t0 is not None and opened == [True]
    assert clock.completions == []     # that minibatch began before t0


@pytest.mark.parametrize("n", [2, 3])
def test_counts_after_opening_and_stops_each_model_past_the_window(n):
    clock, _, hooks, _, _ = _clock(n, checked=1, seconds=0.0)
    for i in range(n):
        hooks[i]([])
    assert clock.t0 is not None
    for i in range(n):
        assert hooks[i]([]) is True
    assert [i for _, i, _ in clock.completions] == list(range(n))
