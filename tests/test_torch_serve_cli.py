"""The port's serve CLI and ``profiler --smoke``, in process on the CPU.

* ``python -m repro_torch.launch.serve`` is a shell over ``Session`` +
  ``ServeJob``, as the JAX CLI is: for two models (``qwen3-0.6b`` and
  ``xlstm-350m`` smoke, ``--stagger 1``, with and without ``--cold``) it
  prints the JAX CLI's JSON keys, the JAX engine summary's keys (and the
  serving device), a ``schedule`` that interleaves both names, and every
  request with its tokens; ``--cold`` reports the promotion; the
  admission policy and SLO flags reach the engines; ``--buckets`` plans
  and serves as the JAX CLI does (plan meta, engines' buckets and prefill
  calls; the recurrent model falls back); ``--http`` and its flags raise
  naming their ROADMAP item.
* ``python -m repro_torch.profiler --smoke --device cpu`` plans and runs
  one train + serve session without and with fresh quick facts: the
  provenance differs and survives JSON, the tokens are identical.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import json
import sys

import pytest

from repro_torch.launch import serve as pserve
from repro_torch.profiler.__main__ import main as profiler_main

FLAGS = ["--arch", "qwen3-0.6b,xlstm-350m", "--smoke", "--stagger", "1",
         "--batch", "3", "--prompt-len", "12", "--gen", "5",
         "--capacity", "2"]


def _run_port(argv, capsys):
    pserve.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _run_jax(argv, capsys, monkeypatch):
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _no_profile_on_disk(tmp_path, monkeypatch):
    """Both CLIs' sessions read ``results/`` profiles with
    ``profile="auto"``: run where there is none."""
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_multi_model_cli_prints_the_jax_keys(cold, capsys, monkeypatch):
    argv = FLAGS + (["--cold"] if cold else [])
    out = _run_port(argv, capsys)
    jout = _run_jax(argv, capsys, monkeypatch)
    assert set(out) == set(jout) == {"engines", "schedule", "requests"}
    assert set(out["engines"]) == set(jout["engines"]) == \
        {"qwen3-0.6b", "xlstm-350m"}
    for name, eng in out["engines"].items():
        # the JAX engine's summary keys, plus the port's serving device
        assert set(eng) - set(jout["engines"][name]) == {"device"}
        assert set(jout["engines"][name]) <= set(eng)
        assert eng["backend"] == jout["engines"][name]["backend"] == "slot"
        assert eng["n_completed"] == 3
        if cold:
            assert eng["cold"] and eng["promote_bytes"] == \
                jout["engines"][name]["promote_bytes"] > 0
            assert eng["promote_s"] >= 0
    sched = out["schedule"]
    assert set(sched) == {"qwen3-0.6b", "xlstm-350m"}
    # interleaved: the two names alternate somewhere in the trace
    assert any(a != b for a, b in zip(sched, sched[1:]))
    assert len(out["requests"]) == len(jout["requests"]) == 6
    assert all(r["n_generated"] == 5 and r["status"] == "finished"
               for r in out["requests"])
    assert set(out["requests"][0]) == set(jout["requests"][0])


def test_single_model_cli_with_slo_flags(capsys):
    out = _run_port(["--arch", "qwen3-0.6b", "--smoke", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4", "--backend", "paged",
                     "--block-size", "8", "--policy", "fifo",
                     "--scheduler", "srtf", "--priority", "high",
                     "--deadline-ms", "5000", "--max-ttft-ms", "4000"],
                    capsys)
    eng = out["engines"]["qwen3-0.6b"]
    assert eng["backend"] == "paged" and eng["policy"] == "fifo"
    assert out["schedule"] is None and len(out["sample"]) == 4
    assert all(r["priority"] == "high" for r in out["requests"])


@pytest.mark.parametrize("flags,item", [
    (["--http"], "item 9"),
    (["--port", "0"], "item 9"), (["--no-stream"], "item 9"),
    (["--endpoint", "chat"], "item 9"),
])
def test_unported_cli_flags_raise_naming_their_item(flags, item, capsys):
    with pytest.raises(NotImplementedError, match=item):
        _run_port(["--arch", "qwen3-0.6b", "--smoke"] + flags, capsys)


def test_buckets_flag_plans_and_serves_as_the_jax_cli(capsys, monkeypatch):
    """``--buckets`` means ``bucket_sizes="pow2"``: each job's plan meta
    equals the one the JAX CLI builds from the same arguments (the
    recurrent model's with its fallback reason), and both CLIs' engines
    report the same buckets and prefill calls."""
    from repro.api import Session as JSession
    from repro.core.sharp import HydraConfig as JHydraConfig
    from repro.launch import serve as jserve
    from repro_torch.api import HydraConfig, Session
    argv = FLAGS + ["--buckets", "--backend", "paged", "--block-size", "8"]
    seen = {}
    monkeypatch.setattr(pserve, "serve", lambda a: seen.update(a=a) or {})
    pserve.main(argv + ["--device", "cpu"])
    monkeypatch.undo()
    capsys.readouterr()
    args = seen["a"]
    ps = Session(HydraConfig(), device="cpu", profile=None)
    js = JSession(JHydraConfig(), profile=None)
    for arch in args.arch.split(","):
        ps.submit(pserve.build_serve_job(arch, args))
        js.submit(jserve.build_serve_job(arch, args))
    metas = [json.loads(json.dumps([j.meta for j in s.plan().jobs],
                                   default=float)) for s in (ps, js)]
    assert metas[0] == metas[1]
    assert metas[0][0]["bucket_sizes"] == [1, 2, 4, 8, 16, 25]
    assert metas[0][1]["bucket_sizes"] is None
    assert "rewound" in metas[0][1]["capability_fallbacks"]["bucket_sizes"]
    out = _run_port(argv, capsys)
    jout = _run_jax(argv, capsys, monkeypatch)
    for name in ("qwen3-0.6b", "xlstm-350m"):
        eng, jeng = out["engines"][name], jout["engines"][name]
        for key in ("bucket_sizes", "prefill_calls", "backend",
                    "requested_backend", "n_completed"):
            assert eng[key] == jeng[key], (name, key)
    assert out["engines"]["qwen3-0.6b"]["bucket_sizes"] == \
        [1, 2, 4, 8, 16, 25]


def test_profiler_smoke_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "smoke_facts.json"
    assert profiler_main(["--smoke", "--device", "cpu", "--out",
                          str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = rec["profile_smoke"]
    assert rec["ok"] and rec["device"] == "cpu"
    assert rec["provenance_differs"] and rec["tokens_identical"]
    assert rec["analytic_queries_a"] > 0 and rec["measured_queries_b"] > 0
    assert rec["decode_families"] == ["dense"]
    assert rec["profile_path"] == str(out) and out.exists()
