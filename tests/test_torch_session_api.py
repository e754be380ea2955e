"""The rest of the port's Session API against the JAX package's:
``Plan.save``/``load``, ``run_async``/``AsyncRun`` and the single-run
guard, with the probe oracle's plans saved and run again.

The four ``tests/test_api_session.py`` cases ROADMAP item 7 closes run
against both packages here.  Both get the same ``float32`` smoke config,
the same weights (a JAX init bridged through ``params_from_numpy``), the
same ``SyntheticTokens`` batches and ``profile=None``; with pinned unit
runtimes (``fixed_unit_runtime``, no pilot) every schedule is
reproducible, so unit traces and serve counts must be equal and losses
agree at 3e-4 (``tests/test_orchestrator.py``'s bound).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import functools
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import Plan as JPlan
from repro.api import ServeJob as JServeJob
from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.api import (AsyncRun, HydraConfig, Plan, ServeJob, Session,
                             TrainJob)
from repro_torch.configs import get_config
from repro_torch.core import partitioner as pt
from repro_torch.data.pipeline import DataConfig, SyntheticTokens

TOL = 3e-4
BUDGET = 18 * 10**6
SEQ = 64
FIXED = dict(pilot=False, fixed_unit_runtime=1e-3)


@functools.lru_cache(maxsize=None)
def _cfgs():
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params(seed):
    return both_params(*_cfgs(), seed)


class Pkg:
    """One package's session API, spelled the same way for both."""

    def __init__(self, is_jax):
        self.is_jax = is_jax
        self.cfg = _cfgs()[0 if is_jax else 1]
        self.Train, self.Serve, self.Plan = (
            (JTrainJob, JServeJob, JPlan) if is_jax
            else (TrainJob, ServeJob, Plan))

    def session(self, **kw):
        kw.setdefault("n_devices", 2)
        kw.setdefault("device_budget_bytes", BUDGET)
        if self.is_jax:
            return JSession(JHydraConfig(**kw), profile=None)
        return Session(HydraConfig(**kw), device="cpu", profile=None)

    def loader(self, seed):
        kw = dict(batch_size=2, seq_len=SEQ, vocab_size=self.cfg.vocab_size,
                  seed=seed)
        return (JSyntheticTokens(JDataConfig(**kw)) if self.is_jax
                else SyntheticTokens(DataConfig(**kw)))

    def train_job(self, seed, steps=2, loader=None, **kw):
        return self.Train(self.cfg, loader if loader is not None
                          else self.loader(seed), lr=1e-3, epochs=1,
                          steps_per_epoch=steps, seed=seed, batch=2,
                          seq=SEQ, params=_params(seed)[int(not self.is_jax)],
                          **kw)

    def serve_job(self):
        return self.Serve(self.cfg, params=_params(7)[int(not self.is_jax)],
                          capacity=2, max_seq=32, backend="paged",
                          block_size=8)


PKGS = (Pkg(True), Pkg(False))


def _prompt(seed, plen):
    return np.random.default_rng(seed).integers(
        0, _cfgs()[1].vocab_size, plen, dtype=np.int32)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_plan_execute_equivalence_across_json_reload(tmp_path):
    """A Plan saved and re-loaded into a fresh session reproduces the
    original session's partition, schedule and losses exactly, in both
    packages; across them, the same traces and losses at 3e-4."""
    out = []
    for pkg in PKGS:
        sess_a = pkg.session(**FIXED)
        sess_b = pkg.session(**FIXED)
        for seed in (0, 1):
            sess_a.submit(pkg.train_job(seed))
            sess_b.submit(pkg.train_job(seed))
        plan_a = sess_a.plan()
        path = tmp_path / f"plan_{pkg.is_jax}.json"
        plan_a.save(str(path))
        report_b = sess_b.run(pkg.Plan.load(str(path)))
        report_a = sess_a.run(plan_a)
        for ma, mb in zip(sess_a.train_execs, sess_b.train_execs):
            assert ma.partition.shards == mb.partition.shards
        assert report_a.unit_trace == report_b.unit_trace
        for mid in report_a.train.losses:
            np.testing.assert_array_equal(report_a.train.losses[mid],
                                          report_b.train.losses[mid])
        out.append(report_b)
    jr, r = out
    assert r.unit_trace == [tuple(k) for k in jr.unit_trace]
    for mid in jr.train.losses:
        _close(r.train.losses[mid], jr.train.losses[mid])


def _async_lifecycle(pkg):
    session = pkg.session(**FIXED)
    t0 = session.submit(pkg.train_job(0, steps=3))
    sv = session.submit(pkg.serve_job())
    req = session.submit_request(sv, _prompt(5, 6), 4)
    handle = session.run_async()
    assert isinstance(handle, AsyncRun) or pkg.is_jax
    with pytest.raises(RuntimeError, match="already in flight"):
        session.run_async()
    seen = set()
    while not handle.done():
        seen.add(session.poll(t0)["status"])         # live mid-run
        time.sleep(0.01)
    report = handle.result(timeout=60)
    assert handle.done()
    assert len(report.train.losses[0]) == 3
    assert req.done and len(req.generated) == 4
    assert session.poll(t0)["status"] == "done"
    assert seen <= {"pending", "running", "done"}
    assert handle.result() is report          # a finished handle, again
    again = session.submit_request(sv, _prompt(6, 5), 2)
    second = session.run_async().result(timeout=60)
    assert second.serve[sv]["n_completed"] == 2
    return report, list(req.generated) + list(again.generated), second


def test_run_async_lifecycle():
    """run_async returns at once; poll is live mid-run; result() joins
    and hands back the report; a second run_async mid-flight raises; a
    new one is accepted after completion — in both packages, with the
    same losses, unit trace, serve counts and tokens."""
    (jrep, jtok, jsecond), (rep, tok, second) = map(_async_lifecycle, PKGS)
    _close(rep.train.losses[0], jrep.train.losses[0])
    assert rep.unit_trace == [tuple(k) for k in jrep.unit_trace]
    assert tok == [int(t) for t in jtok]
    for key in ("n_completed", "decode_steps", "prefill_calls"):
        assert rep.serve["serve-0"][key] == jrep.serve["serve-0"][key]
        assert second.serve["serve-0"][key] == jsecond.serve["serve-0"][key]


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_plain_run_refused_while_async_run_in_flight(pkg):
    """The guard covers run(), not just a second run_async()."""
    session = pkg.session(**FIXED)
    gate = threading.Event()

    def gated_loader():
        gate.wait(30)                        # pins the async run in flight
        yield from pkg.loader(0)

    session.submit(pkg.train_job(0, loader=gated_loader()))
    handle = session.run_async()
    try:
        with pytest.raises(RuntimeError, match="already in flight"):
            session.run()
    finally:
        gate.set()
        handle.result(timeout=60)
    session.run()                            # finished handle: allowed


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_run_async_propagates_failures(pkg):
    session = pkg.session()

    def exploding():
        raise RuntimeError("boom-loader")
        yield

    session.submit(pkg.train_job(0, steps=1, loader=exploding()))
    handle = session.run_async()
    with pytest.raises(RuntimeError, match="boom-loader"):
        handle.result(timeout=60)


def test_probe_plan_saved_and_loaded_runs_without_pilots(tmp_path):
    """A plan made with the probe oracle, saved and loaded into a fresh
    session, runs its partition with no pilot."""
    pkg = PKGS[1]
    kw = dict(n_devices=1, device_budget_bytes=20 * 10**6,
              partition_oracle="probe", **FIXED)
    sess_a = pkg.session(**kw)
    sess_a.submit(pkg.train_job(0))
    before = pt.pilot_peak.pilots
    plan = sess_a.plan()
    assert pt.pilot_peak.pilots > before
    assert plan.jobs[0].partition["oracle"] == "probe"
    plan.save(str(tmp_path / "probe.json"))
    sess_b = pkg.session(**kw)
    sess_b.submit(pkg.train_job(0))
    before = pt.pilot_peak.pilots
    report = sess_b.run(Plan.load(str(tmp_path / "probe.json")))
    assert pt.pilot_peak.pilots == before
    shards = plan.jobs[0].partition["shards"]
    assert [(s.seg_lo, s.seg_hi) for s in
            sess_b.train_execs[0].partition.shards] == \
        [(s["seg_lo"], s["seg_hi"]) for s in shards]
    assert len(shards) >= 2
    assert report.train.units_executed == 2 * 2 * len(shards)


def test_plan_save_load_round_trips_and_matches_jax_shards(tmp_path):
    """``save`` then ``load`` is byte-identical, provenance included;
    the saved shard lists are the JAX package's for the same jobs."""
    saved = []
    for pkg in PKGS:
        session = pkg.session()
        for seed in (0, 1):
            session.submit(pkg.train_job(seed))
        path = tmp_path / f"plan_{pkg.is_jax}.json"
        session.plan().save(str(path))
        text = path.read_text()
        again = tmp_path / f"again_{pkg.is_jax}.json"
        pkg.Plan.load(str(path)).save(str(again))
        assert again.read_text() == text
        assert pkg.Plan.load(str(path)).to_json(indent=1) == text
        saved.append(json.loads(text))
    jd, d = saved
    assert d["provenance"] and d["provenance"].keys() == \
        jd["provenance"].keys()
    assert [j["partition"]["shards"] for j in d["jobs"]] == \
        [j["partition"]["shards"] for j in jd["jobs"]]
