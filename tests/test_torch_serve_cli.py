"""The port's serve CLI and ``profiler --smoke``, in process on the CPU.

* ``python -m repro_torch.launch.serve`` is a shell over ``Session`` +
  ``ServeJob``, as the JAX CLI is: for two models (``qwen3-0.6b`` and
  ``xlstm-350m`` smoke, ``--stagger 1``, with and without ``--cold``) it
  prints the JAX CLI's JSON keys, the JAX engine summary's keys (and the
  serving device), a ``schedule`` that interleaves both names, and every
  request with its tokens; ``--cold`` reports the promotion; the
  admission policy and SLO flags reach the engines; ``--buckets`` plans
  and serves as the JAX CLI does (plan meta, engines' buckets and prefill
  calls; the recurrent model falls back).
* ``--http`` in a subprocess (``--port 0 --device cpu``): the first stdout
  line is the JAX CLI's ``{"url", "models"}``, ``/health`` answers, a
  completion streams the tokens a non-streamed one returns,
  ``--no-stream`` refuses a stream with the JAX front end's status and
  message, and ``--endpoint`` routes its alias to the model.
* ``python -m repro_torch.profiler --smoke --device cpu`` plans and runs
  one train + serve session without and with fresh quick facts: the
  provenance differs and survives JSON, the tokens are identical.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import http.client
import json
import os
import pathlib
import select
import signal
import subprocess
import sys

import pytest

from repro_torch.launch import serve as pserve
from repro_torch.profiler.__main__ import main as profiler_main

REPO = pathlib.Path(__file__).resolve().parents[1]
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


HTTP_FLAGS = ["--arch", "qwen3-0.6b", "--smoke", "--http", "--port", "0",
              "--device", "cpu", "--max-seq", "64", "--capacity", "2"]


def _start_cli(extra):
    """``python -m repro_torch.launch.serve --http ...`` in a subprocess;
    returns the process and its parsed first stdout line."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve"] + HTTP_FLAGS
        + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=str(REPO))
    ready = select.select([proc.stdout], [], [], 120)[0]
    line = proc.stdout.readline() if ready else b""
    if not line:
        proc.kill()
        raise AssertionError("the CLI printed no first line: "
                             + proc.stderr.read().decode()[-2000:])
    return proc, json.loads(line)


def _stop_cli(proc):
    proc.send_signal(signal.SIGINT)          # the CLI's Ctrl-C path
    try:
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


@pytest.fixture(scope="module")
def http_clis():
    """Two CLIs: one streaming, one with ``--no-stream --endpoint chat``."""
    procs = {}
    try:
        for name, extra in (("stream", []),
                            ("locked", ["--no-stream", "--endpoint",
                                        "chat"])):
            procs[name] = _start_cli(extra)
        yield {name: first for name, (_, first) in procs.items()}
    finally:
        for proc, _ in procs.values():
            _stop_cli(proc)


def _http(url, method, path, body=None):
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        return resp.status, resp.getheader("Content-Type"), raw
    finally:
        conn.close()


def _sse_ids(raw):
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e)["choices"][0]["token_id"] for e in events[:-2]]


BODY = {"model": "qwen3-0.6b", "prompt": [5, 17, 42, 7], "max_tokens": 6}


@pytest.mark.parametrize("case", ["first_line", "health", "completion",
                                  "no_stream", "endpoint"])
def test_http_cli_flags_drive_the_front_end(case, http_clis):
    first = http_clis["stream"]
    url = first["url"]
    if case == "first_line":
        for line in http_clis.values():
            assert set(line) == {"url", "models"}
            assert line["models"] == ["qwen3-0.6b"]
            assert line["url"].startswith("http://127.0.0.1:")
            assert not line["url"].endswith(":0")
        assert http_clis["locked"]["url"] != url
    elif case == "health":
        for line in http_clis.values():
            assert _http(line["url"], "GET", "/health")[::2] == \
                (200, '{"status": "ok"}')
        status, _, raw = _http(url, "GET", "/v1/models")
        assert status == 200
        assert [(m["id"], m["stream"], m["endpoint"])
                for m in json.loads(raw)["data"]] == \
            [("qwen3-0.6b", True, None)]
    elif case == "completion":
        status, _, raw = _http(url, "POST", "/v1/completions", BODY)
        assert status == 200
        full = json.loads(raw)["choices"][0]["token_ids"]
        status, ctype, raw = _http(url, "POST", "/v1/completions",
                                   dict(BODY, stream=True))
        assert (status, ctype) == (200, "text/event-stream")
        assert _sse_ids(raw) == full and len(full) == 6
    elif case == "no_stream":
        locked = http_clis["locked"]["url"]
        status, _, raw = _http(locked, "POST", "/v1/completions",
                               dict(BODY, stream=True))
        # the JAX front end's status and message for a ServeJob(stream=False)
        assert status == 400
        assert json.loads(raw)["error"]["message"] == (
            "model 'qwen3-0.6b' is served with stream=False "
            "(ServeJob.stream); request a non-streaming completion")
        assert _http(locked, "POST", "/v1/completions", BODY)[0] == 200
    else:
        locked = http_clis["locked"]["url"]
        by_alias = _http(locked, "POST", "/v1/completions",
                         dict(BODY, model="chat"))
        by_name = _http(locked, "POST", "/v1/completions", BODY)
        assert by_alias[0] == by_name[0] == 200
        assert json.loads(by_alias[2])["choices"][0]["token_ids"] == \
            json.loads(by_name[2])["choices"][0]["token_ids"]
        assert json.loads(by_alias[2])["model"] == "qwen3-0.6b"
        assert _http(url, "POST", "/v1/completions",
                     dict(BODY, model="chat"))[0] == 404


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
