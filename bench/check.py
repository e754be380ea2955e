"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, number by number, each against its limit.

Training (per grid model, then the worst over the grid):
  * ``loss_gap``   largest |program loss - reference loss| over the
                   checked steps (nats);
  * ``grad_gap``   worst leaf of | |g_program| - |g_reference| | over
                   max(|g_reference| of the leaf, the median leaf's),
                   for the first gradient as the optimizer got it;
  * ``change_gap`` the same for each leaf's change over the checked
                   steps, leaving out leaves whose reference gradient is
                   under a thousandth of the median leaf's (they move by
                   round-off alone, as a key bias does under softmax).
Evaluation: ``loss_gap``, the largest |program loss - reference loss|
over the sampled batches.
"""

from __future__ import annotations

import math
import statistics

ZERO_GRAD_SHARE = 1e-3


def _leaf_gap(prog: dict, ref: dict, keep) -> tuple[float, str]:
    names = [k for k in ref if keep(k)]
    missing = [k for k in names if k not in prog]
    if missing:
        return math.inf, f"missing {missing[0]}"
    med = statistics.median(ref[k] for k in names)
    worst, where = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not gap <= worst:          # NaN counts as worst
            worst, where = gap, k
    return worst, where


def compare_train(prog: list[dict], ref: list[dict]) -> tuple[dict, dict]:
    """Readings and, for each, where the worst one lies."""
    read = {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    where = {k: "" for k in read}

    def worse(name, value, at):
        if not value <= read[name]:
            read[name], where[name] = value, at

    for i, (p, r) in enumerate(zip(prog, ref, strict=True)):
        for step, (lp, lr) in enumerate(zip(p["losses"], r["losses"],
                                            strict=True), start=1):
            worse("loss_gap", abs(lp - lr), f"model {i} step {step}")
        g, at = _leaf_gap(p["grad"], r["grad"], lambda k: True)
        worse("grad_gap", g, f"model {i} {at}")
        gmed = statistics.median(r["grad"].values())
        moving = lambda k: r["grad"][k] >= ZERO_GRAD_SHARE * gmed  # noqa
        c, at = _leaf_gap(p["change"], r["change"], moving)
        worse("change_gap", c, f"model {i} {at}")
    return read, where


def compare_eval(prog: list[float], ref: list[float]) -> tuple[dict, dict]:
    read, where = {"loss_gap": 0.0}, {"loss_gap": ""}
    for k, (lp, lr) in enumerate(zip(prog, ref, strict=True)):
        gap = abs(lp - lr)
        if not gap <= read["loss_gap"]:
            read["loss_gap"], where["loss_gap"] = gap, f"sample {k}"
    return read, where


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for the result line, each number beside its
    limit.  A number with no limit, or one that is not finite, fails."""
    checks = {}
    ok = True
    for name, value in readings.items():
        limit = limits.get(name)
        passed = limit is not None and math.isfinite(value) \
            and value <= limit
        ok &= passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
