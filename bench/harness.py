"""One run of one cell: the port's ``Session`` driven through its normal
entry by the traffic the cell names, timed by the host clock, optionally
traced, then checked against the plain reference.  Everything a cell
needs is found by name from ``BENCHMARK.json``: its configuration file,
the configuration's family file (``bench/init/<init>.py``) and reference
(``bench/reference/<reference>.py``), its traffic file, the traffic's
kind (``bench/kinds/<kind>.py``: how the port is driven and the window
timed), its limits file and one reader a metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from bench import check, gen

ROOT = Path(__file__).resolve().parents[1]


# -- the spec, found by name --------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: Path = ROOT,
            smoke: bool = False) -> dict:
    """The cell's configuration, traffic, limits and metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _json(root / conf["file"])
    traffic = _json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    limits = _json(root / "bench" / "limits" / f"{workload}.json")
    arch = config["arch"]
    if smoke:
        arch = config["smoke"]["arch"]
        traffic = {**traffic, **traffic["smoke"]}
        limits = limits["smoke"]
    else:
        _check_grid(config, traffic)
        limits = limits["limits"]

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"config": config, "arch": arch,
            "init": gen.family(config["init"]),
            "kind": importlib.import_module(f"bench.kinds.{traffic['kind']}"),
            "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in spec["end_to_end"] if here(m)],
            "per_layer": [m for m in spec["per_layer"] if here(m)]}


def _check_grid(config: dict, traffic: dict):
    """A training mix takes its models from the configuration's grid,
    which names what it keeps of the source's grid."""
    grid = config.get("grid")
    if traffic["kind"] != "train" or grid is None:
        return
    models = traffic["models"]
    if len(models) > grid["models"] or any(
            m["batch"] not in grid["batch"] or m["lr"] not in grid["lr"]
            for m in models):
        raise ValueError(f"{traffic['about'][:60]}...: its models "
                         f"{models} are not drawn from the grid {grid}")


def load_reader(name: str, root: Path = ROOT):
    """``bench/metrics/<name>.py``, else the file of the name's stem
    before its first dot (one reader for ``idle_share.train`` and
    ``idle_share.eval``)."""
    base = root / "bench" / "metrics"
    path = base / f"{name}.py"
    if not path.exists():
        path = base / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} in {base}")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: dict):
    return importlib.import_module(f"bench.reference.{config['reference']}")


# -- shared by the kinds ----------------------------------------------------------

def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def arch_config(arch: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**arch)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", proc_start: float, root: Path = ROOT,
             smoke: bool = False) -> dict:
    """One run: the result line (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` also ``breakdown``, and
    ``checks`` last) and what else the run saw, for standard error."""
    device = torch.device(device)
    r = resolve(load_spec(root), workload, root, smoke)
    tracer = None
    if trace:
        from bench.trace import Tracer
        tracer = Tracer(device)
        tracer.warm()
    out = r["kind"].run(r, seed, seconds, device, tracer)
    summary = None
    if tracer:
        from bench.trace import reduce
        t = time.perf_counter()
        summary = reduce(tracer)
        summary["reduce_s"] = time.perf_counter() - t
    ctx = {**out, "setup_s": out["t0_epoch"] - proc_start, "trace": summary}
    if summary is not None:
        ctx["window_s"] = summary["window_s"]
    metrics = {}
    for m in (r["per_layer"] if trace else r["end_to_end"]):
        value = load_reader(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for v in out["window_losses"] if not math.isfinite(v))
    ok, checks = check.judge(out["readings"], r["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["peak"]}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": bool(ok and failed == 0 and out["steps"] > 0),
              "attempted": out["steps"], "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    extra = {"worst": out["where"], "window_s": ctx["window_s"],
             "steps": out["steps"], "tokens": out["tokens"],
             "pin_s": out["pin_s"], "setup_s": ctx["setup_s"],
             "reference_s": out["reference_s"]}
    if summary is not None:
        extra["trace"] = {k: summary[k] for k in
                          ("device_events", "cpu_events", "kernels",
                           "copy_s", "busy_s", "reduce_s")}
    return result, extra
