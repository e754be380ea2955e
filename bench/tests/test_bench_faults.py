"""The timed path broken underneath, the rest of a run driven as usual:
each fault a cell can have comes out as not correct.  On one chip there
is no exchange between chips to leave out."""

import pytest

from _bench_util import EVAL_CELLS, TRAIN_CELLS, smoke_run


def _unchanged_step(monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "update_",
                        lambda cfg, params, grads, state, **kw:
                        (params, state))


def _half_batch(monkeypatch):
    from repro_torch.core import shard_graph
    from repro_torch.training import losses
    full = losses.softmax_xent

    def half(logits, labels, mask=None):
        n = max(1, labels.shape[0] // 2)
        return full(logits[:n], labels[:n])

    monkeypatch.setattr(shard_graph, "softmax_xent", half)
    monkeypatch.setattr(losses, "softmax_xent", half)


def _altered_answer(monkeypatch):
    from repro_torch.core import shard_graph
    from repro_torch.training import losses
    full = losses.softmax_xent

    def altered(logits, labels, mask=None):
        return full(logits, labels) * 1.01

    monkeypatch.setattr(shard_graph, "softmax_xent", altered)
    monkeypatch.setattr(losses, "softmax_xent", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
CASES = [(c, f) for c in TRAIN_CELLS for f in FAULTS] \
    + [(c, f) for c in EVAL_CELLS for f in ("half_batch", "altered_answer")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, extra = smoke_run(cell, seed=3)
    assert not result["correct"], (result["checks"], extra)
