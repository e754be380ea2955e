"""The port's machine profiler (``repro_torch.profiler``) and measured-cost
planning, against the JAX package's.

* The cases of ``tests/test_profiler.py``, run against the port's facts
  and cost modules: ``MachineFacts`` round trip, schema and staleness
  gating, the analytic constants (the H100's, with the paper's 16 GB/s
  host link), ``CostModel`` monotonicity and analytic byte-identity, plan
  provenance through JSON and a run.
* One facts JSON, its fingerprint rewritten for each side, gives the same
  ``CostModel`` answers and ``provenance["queries"]`` in both packages,
  and a two-model smoke ``Session.plan()`` with it gives the JAX plan's
  partitions, shard runtimes and ``est_makespan_s``.
* ``python -m repro_torch.profiler --quick --device cpu`` writes facts
  with a dense decode grid and seven kernel rows (the plain versions on
  the CPU: ``default_impl == "ref"``); training losses are identical with
  and without facts.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import json
import warnings

import jax
import numpy as np
import pytest

from repro.api import Session as JSession
from repro.api import TrainJob as JTrainJob
from repro.configs import get_config as jget_config
from repro.core.sharp import HydraConfig as JHydraConfig
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.profiler import CostModel as JCostModel
from repro.profiler import MachineFacts as JMachineFacts
from repro.profiler import current_fingerprint as jcurrent_fingerprint
from repro_torch.api import HydraConfig, Plan, Session, TrainJob
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.profiler import (ANALYTIC_HARDWARE, CostModel, MachineFacts,
                                  StaleProfileWarning, current_fingerprint,
                                  hardware_constants, load_facts)
from repro_torch.profiler.__main__ import main as profiler_main
from repro_torch.profiler.cost import (ANALYTIC_TOK_SECONDS_PER_PARAM,
                                       _monotone_grid)

BUDGET = 18 * 10**6
SEQ = 64
KERNEL_ROWS = {"flash_attention", "rms_norm", "swiglu", "paged_attention",
               "paged_verify", "paged_attention_quant", "fused_decode_layer"}


def _cfg():
    return get_config("qwen3-0.6b", smoke=True)


def _hc(**kw):
    return HydraConfig(n_devices=2, device_budget_bytes=BUDGET, **kw)


def _fresh_facts(**kw) -> MachineFacts:
    return MachineFacts(fingerprint=current_fingerprint(), **kw)


def _grid(cfg) -> dict:
    return {cfg.family: {
        "arch": cfg.name,
        "n_active_params": cfg.n_active_params,
        "batches": [1, 2],
        "seqs": [32, 64],
        "decode_step_s": [[1e-4, 2e-4], [3e-4, 4e-4]],
        "prefill_s_per_token": [[1e-5, 1e-5], [9e-6, 9e-6]],
    }}


def _measured_facts(cfg) -> MachineFacts:
    """Synthetic fresh facts with a dense-family decode grid around cfg."""
    return _fresh_facts(decode=_grid(cfg))


def _loader(cfg, seed):
    return SyntheticTokens(DataConfig(batch_size=2, seq_len=SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed))


def _plan(profile, **hc):
    cfg = _cfg()
    session = Session(_hc(**hc), device="cpu", profile=profile)
    session.submit(TrainJob(cfg, _loader(cfg, 0), epochs=1,
                            steps_per_epoch=2, seed=0, batch=2, seq=SEQ))
    return session, session.plan()


# ---------------------------------------------------------------------------
# MachineFacts: round trip, schema gating, staleness
# ---------------------------------------------------------------------------

def test_facts_json_round_trip(tmp_path):
    facts = _measured_facts(_cfg())
    facts.hardware["hbm_bw"] = 123e9
    path = facts.save(str(tmp_path / "profile.json"))
    loaded = MachineFacts.load(path)
    assert loaded.to_dict() == facts.to_dict()
    assert loaded.to_json() == facts.to_json()
    assert load_facts(path).to_dict() == facts.to_dict()


def test_facts_schema_version_rejected(tmp_path):
    d = _fresh_facts().to_dict()
    d["schema_version"] = 999
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="schema_version"):
        MachineFacts.load(str(path))


def test_load_facts_missing_ok(tmp_path):
    assert load_facts(str(tmp_path / "nope.json"), missing_ok=True) is None
    with pytest.raises(FileNotFoundError):
        load_facts(str(tmp_path / "nope.json"))


def test_stale_profile_warns_and_falls_back(tmp_path):
    facts = _measured_facts(_cfg())
    facts.fingerprint = dict(facts.fingerprint, device_kind="GPU v9000")
    path = facts.save(str(tmp_path / "profile.json"))
    with pytest.warns(StaleProfileWarning):
        assert load_facts(path) is None
    assert load_facts(path, require_fresh=False).decode
    with pytest.warns(StaleProfileWarning):
        cm = CostModel(MachineFacts.load(path))
    assert not cm.measured
    cfg = _cfg()
    assert cm.tok_seconds(cfg) == \
        ANALYTIC_TOK_SECONDS_PER_PARAM * cfg.n_active_params
    cm2 = CostModel(MachineFacts.load(path), allow_stale=True)
    assert cm2.measured and cm2.has_decode_facts(cfg)


def test_profiles_of_the_two_packages_are_stale_in_each_other(tmp_path):
    """The fingerprints name different frameworks (jax vs torch/cuda), so
    a profile one package wrote is stale in the other."""
    jfacts = JMachineFacts(fingerprint=jcurrent_fingerprint())
    path = str(tmp_path / "jax_profile.json")
    jfacts.save(path)
    with pytest.warns(StaleProfileWarning):
        assert load_facts(path) is None


def test_hardware_constants_analytic_default():
    """With no profile: the H100 SXM data sheet's rates and the paper's
    16 GB/s host link (a planning constant SHARP's link_bw models)."""
    hw = hardware_constants(None)
    assert hw["source"] == "analytic"
    assert hw["peak_flops_bf16"] == 989e12
    assert hw["hbm_bw"] == 3.35e12
    assert hw["ici_bw"] == 900e9
    assert hw["h2d_bw"] == 16e9
    assert hardware_constants(_fresh_facts())["source"] == "analytic"
    f = _fresh_facts()
    f.hardware["hbm_bw"] = 100e9
    hw = hardware_constants(f)
    assert hw["source"] == "measured" and hw["hbm_bw"] == 100e9
    assert hw["ici_bw"] == ANALYTIC_HARDWARE["ici_bw"]


# ---------------------------------------------------------------------------
# CostModel: analytic parity + monotonicity
# ---------------------------------------------------------------------------

def test_analytic_shard_runtimes_byte_identical():
    cfg = _cfg()
    cm = CostModel(None)
    weights = [3.7e9, 1.2e8, 5.5e9]
    got = cm.shard_runtimes(cfg, weights, batch=2, seq=64)
    assert got == [(w * 1e-12, 2 * (w * 1e-12)) for w in weights]
    assert cm.provenance[f"partition:{cfg.name}"]["source"] == "analytic"


def test_monotone_grid_clamps_noise():
    g = _monotone_grid([[2.0, 1.0], [1.5, 0.5]])
    for i in range(2):
        assert g[i][0] <= g[i][1]
        assert g[0][i] <= g[1][i]


def test_costmodel_more_tokens_never_cheaper():
    cfg = _cfg()
    cm = CostModel(_measured_facts(cfg))
    assert cm.has_decode_facts(cfg)
    points = [1, 2, 3, 8]
    seqs = [16, 32, 48, 64, 200]
    prev = None
    for s in seqs:
        v = cm.decode_step_seconds(cfg, 1, s)
        if prev is not None:
            assert v >= prev
        prev = v
    for b, b2 in zip(points, points[1:]):
        for s in seqs:
            assert cm.decode_step_seconds(cfg, b2, s) >= \
                cm.decode_step_seconds(cfg, b, s)
            assert cm.prefill_seconds(cfg, b2, s) >= \
                cm.prefill_seconds(cfg, b, s)
        for s, s2 in zip(seqs, seqs[1:]):
            assert cm.prefill_seconds(cfg, b, s2) >= \
                cm.prefill_seconds(cfg, b, s)
    rec = cm.provenance[f"decode_step:{cfg.name}"]
    assert rec["source"] == "measured" and rec["probe_arch"] == cfg.name


def test_transfer_seconds_monotone_and_sourced():
    cm = CostModel(None)
    a, b = cm.transfer_seconds(10**6), cm.transfer_seconds(10**8)
    assert b > a and cm.provenance["transfer:h2d"]["source"] == "analytic"
    cm = CostModel(_fresh_facts(transfer={"h2d": [
        {"bytes": 2 ** 10, "seconds": 1e-4},
        {"bytes": 2 ** 20, "seconds": 2e-4}]}))
    a, b = cm.transfer_seconds(10**6), cm.transfer_seconds(10**8)
    assert b > a > 0
    assert cm.provenance["transfer:h2d"]["source"] == "measured"


def test_draft_plan_picks_cheaper_draft():
    cfg = _cfg()
    cm = CostModel(None)
    choice = cm.draft_plan(cfg)
    assert 1 <= choice.draft_k <= 8
    assert choice.draft_cfg.n_active_params <= cfg.n_active_params
    rec = cm.provenance[f"draft:{cfg.name}"]
    assert rec["draft_model"] == choice.draft_cfg.name
    assert rec["expected_tok_per_s"] > 0
    assert rec["accept_source"] == "prior" and rec["accept_prior"] == 0.8
    assert cm.draft_plan(cfg, draft_k=3).draft_k == 3


def test_draft_plan_prefers_measured_accept_rate():
    cfg = _cfg()
    facts = _fresh_facts(accept_rates={
        cfg.family: {"target": cfg.name, "draft": f"{cfg.name}-draft-probe",
                     "draft_k": 3, "accept_rate": 0.35, "rounds": 20}})
    cm = CostModel(facts)
    choice = cm.draft_plan(cfg, draft_k=4)
    rec = cm.provenance[f"draft:{cfg.name}"]
    assert rec["accept_source"] == "measured"
    assert rec["accept_prior"] == 0.35
    assert rec["accept_probe"]["rounds"] == 20
    prior_rec = CostModel(None).draft_plan(cfg, draft_k=4).record
    assert choice.record["expected_tok_per_s"] < \
        prior_rec["expected_tok_per_s"]
    assert cm.draft_plan(cfg).draft_k <= \
        CostModel(None).draft_plan(cfg).draft_k
    cm2 = CostModel(_fresh_facts())
    cm2.draft_plan(cfg)
    assert cm2.provenance[f"draft:{cfg.name}"]["accept_source"] == "prior"
    assert MachineFacts.from_dict(facts.to_dict()).accept_rates == \
        facts.accept_rates


# ---------------------------------------------------------------------------
# plan provenance: present, serialized, stable across plan -> JSON -> run
# ---------------------------------------------------------------------------

def test_plan_provenance_round_trips():
    session, plan = _plan(profile=None)
    assert plan.provenance["n_analytic"] > 0
    assert plan.provenance["n_measured"] == 0
    assert plan.provenance["profile"] is None
    text = plan.to_json()
    reloaded = Plan.from_json(text)
    assert reloaded.provenance == plan.provenance
    assert reloaded.to_json() == text
    assert plan.summary()["cost_source"] == "analytic"
    rep = session.run(reloaded)
    assert reloaded.provenance == plan.provenance
    assert rep.train is not None


def test_plan_cites_measured_facts_when_profiled(tmp_path):
    cfg = _cfg()
    path = _measured_facts(cfg).save(str(tmp_path / "p.json"))
    _, plan_a = _plan(profile=None)
    _, plan_b = _plan(profile=path)
    assert plan_b.provenance["n_measured"] > 0
    assert cfg.family in plan_b.provenance["profile"]["decode_families"]
    assert plan_b.summary()["cost_source"] == "measured"
    assert plan_a.provenance != plan_b.provenance
    prov = plan_b.provenance["queries"]
    assert prov[f"partition:{cfg.name}"]["source"] == "measured"
    # cost facts move the runtime estimates, never the shard boundaries
    bounds = [[(s["seg_lo"], s["seg_hi"]) for s in j.partition["shards"]]
              for j in (plan_a.jobs[0], plan_b.jobs[0])]
    assert bounds[0] == bounds[1]


def test_pre_profiler_plan_json_still_loads():
    _, plan = _plan(profile=None)
    d = json.loads(plan.to_json())
    d.pop("provenance")
    old = Plan.from_json(json.dumps(d))
    assert old.provenance == {}
    assert old.summary().get("cost_source") is None


def test_session_rejects_bad_profile_arg():
    with pytest.raises(TypeError):
        Session(_hc(), device="cpu", profile=42)


def test_unprofiled_session_emits_no_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("error", StaleProfileWarning)
        _plan(profile=None)


def test_losses_identical_with_and_without_facts():
    """Measured costs change estimates, never execution: two models
    trained under SHARP give the same losses, bit for bit, whether the
    plan was priced by the analytic priors or by facts."""
    cfg = _cfg().replace(dtype="float32")
    losses = []
    for profile in (None, _measured_facts(cfg)):
        session = Session(_hc(), device="cpu", profile=profile)
        for seed in (0, 1):
            session.submit(TrainJob(cfg, _loader(cfg, seed), epochs=1,
                                    steps_per_epoch=2, seed=seed, batch=2,
                                    seq=SEQ))
        plan = session.plan()
        losses.append(session.run(plan).train.losses)
    assert losses[0] == losses[1] and len(losses[0]) == 2


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _cross_facts(tmp_path):
    """One facts JSON (decode grid, transfer rows), loaded by each package
    with its own fingerprint written in."""
    cfg = _cfg()
    facts = _measured_facts(cfg)
    facts.transfer = {d: [{"bytes": 2 ** 10, "seconds": 1e-4},
                          {"bytes": 2 ** 24, "seconds": 2e-3}]
                      for d in ("h2d", "d2h")}
    d = facts.to_dict()
    tfacts = MachineFacts.from_dict(dict(d, fingerprint=current_fingerprint()))
    jfacts = JMachineFacts.from_dict(dict(d,
                                          fingerprint=jcurrent_fingerprint()))
    assert not tfacts.is_stale() and not jfacts.is_stale()
    return tfacts, jfacts


@pytest.mark.parametrize("measured", [False, True])
def test_cost_model_answers_match_jax(tmp_path, measured):
    """Every query a train plan asks, and the transfer fit, give the same
    numbers and provenance in both packages — analytic and measured.
    ``hardware`` is the one query left out: its analytic table is the
    H100's in the port and a TPU's in the JAX package, by design."""
    tfacts, jfacts = _cross_facts(tmp_path) if measured else (None, None)
    tcm = CostModel(tfacts, allow_stale=True)
    jcm = JCostModel(jfacts, allow_stale=True)
    cfg, jcfg = _cfg(), jget_config("qwen3-0.6b", smoke=True)
    answers = []
    for cm, c in ((tcm, cfg), (jcm, jcfg)):
        got = []
        for b, s in ((1, 16), (2, 48), (3, 64), (8, 300)):
            got += [cm.decode_step_seconds(c, b, s),
                    cm.prefill_seconds(c, b, s)]
        got += [cm.tok_seconds(c, 128),
                cm.shard_runtimes(c, [3.7e9, 1.2e8, 5.5e9], batch=2,
                                  seq=64)]
        for nbytes in (10**3, 10**6, 10**9):
            got += [cm.transfer_seconds(nbytes, "h2d"),
                    cm.transfer_seconds(nbytes, "d2h")]
        answers.append(got)
    assert answers[0] == answers[1]
    t, j = tcm.provenance_summary(), jcm.provenance_summary()
    assert t["queries"] == j["queries"]     # the last answer of each query
    assert (t["n_measured"], t["n_analytic"]) == \
        (j["n_measured"], j["n_analytic"]) == ((6, 0) if measured else (0, 6))


@pytest.mark.parametrize("measured", [False, True])
def test_session_plan_matches_jax(tmp_path, measured):
    """A two-model smoke plan, unprofiled and with the shared facts: the
    same partitions (shard boundaries, bytes, runtime estimates), the
    same schedule estimate and the same provenance queries as the JAX
    plan."""
    tfacts, jfacts = _cross_facts(tmp_path) if measured else (None, None)
    jcfg = jget_config("qwen3-0.6b", smoke=True)
    cfg = _cfg()
    hc = dict(n_devices=2, device_budget_bytes=BUDGET)
    js = JSession(JHydraConfig(**hc), profile=jfacts)
    ts = Session(HydraConfig(**hc), device="cpu", profile=tfacts)
    for seed, lr in enumerate((1e-3, 1e-4)):
        jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        kw = dict(batch_size=2, seq_len=SEQ, vocab_size=cfg.vocab_size,
                  seed=seed)
        job = dict(lr=lr, epochs=1, steps_per_epoch=2, batch=2, seq=SEQ,
                   seed=seed)
        js.submit(JTrainJob(jcfg, JSyntheticTokens(JDataConfig(**kw)),
                            params=jparams, **job))
        ts.submit(TrainJob(cfg, SyntheticTokens(DataConfig(**kw)),
                           params=params, **job))
    jplan, plan = js.plan(), ts.plan()
    assert [j.partition for j in plan.jobs] == \
        [j.partition for j in jplan.jobs]
    assert plan.schedule["est_makespan_s"] == \
        jplan.schedule["est_makespan_s"]
    assert plan.provenance["queries"] == jplan.provenance["queries"]
    assert (plan.provenance["n_measured"] > 0) == measured
    assert plan.jobs[0].partition["shards"][0]["fwd_runtime"] > 0


# ---------------------------------------------------------------------------
# the probes and the CLI, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quick_profile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("profile") / "facts.json")
    assert profiler_main(["--quick", "--device", "cpu", "--out", path]) == 0
    return path


def test_quick_profile_on_cpu_has_every_row(quick_profile):
    facts = load_facts(quick_profile)       # fresh: written on this host
    assert facts.fingerprint["backend"] == "cpu"
    assert set(facts.kernels) == KERNEL_ROWS
    for name, row in facts.kernels.items():
        assert row["default_impl"] == "ref", name
        assert row["ref_us"] > 0 and row["kernel_us"] > 0
    grid = facts.decode["dense"]
    assert grid["batches"] == [1, 2] and grid["seqs"] == [32, 64]
    assert all(v > 0 for row in grid["decode_step_s"] for v in row)
    assert all(v > 0 for row in grid["prefill_s_per_token"] for v in row)
    assert [r["bytes"] for r in facts.transfer["h2d"]] == \
        [1 << 16, 1 << 20, 1 << 22]
    assert facts.accept_rates["dense"]["draft_k"] == 3
    # moe, ssm and hybrid are registered and not spec-draftable: skipped,
    # as the JAX probe skips them, so no family fails into the errors
    assert set(facts.notes["accept_errors"]) == set()
    assert not {"moe", "ssm", "hybrid"} & set(facts.accept_rates)


def test_quick_profile_prices_a_session(quick_profile, capsys):
    _, plan = _plan(profile=quick_profile)
    assert plan.provenance["n_measured"] > 0
    assert profiler_main(["--show", "--out", quick_profile]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert sorted(shown["kernels"]) == sorted(KERNEL_ROWS)
