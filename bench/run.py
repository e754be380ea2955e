"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
``--trace 1``, and ``checks`` last: each number compared beside its
limit); the last lines of standard error repeat the checks.  A run
prints no result and exits non-zero when the card is missing, when the
run fails, or when the JAX package or JAX was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "hydra"}


def process_start() -> float:
    """This process's start on the epoch clock, from /proc; the time of
    this call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def main(argv=None) -> int:
    import argparse
    import json
    import traceback

    proc_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build or kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    try:
        import torch

        from bench import harness
        spec = harness.load_spec(ROOT)
        cells = {w["name"]: w for w in spec["workloads"]}
        chips = cells[args.workload]["chips"]
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"bench: {args.workload} needs {chips} CUDA device(s); "
                  f"cuda available={torch.cuda.is_available()}, count="
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        result, extra = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            device="cuda", proc_start=proc_start, root=ROOT)
    except Exception:                  # the run's boundary: report, no line
        traceback.print_exc()
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the run loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 3
    print("bench: " + json.dumps(extra), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
