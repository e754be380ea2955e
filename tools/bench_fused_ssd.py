#!/usr/bin/env python3
"""Time the port's fused decode layer and SSD scan kernels of one source
tree on the card, with ``chip_smoke.py``'s timer (CUDA events, L2
flushed, a spin kernel ahead, median of 20):

- ``fused_decode_layer`` at the serve path's inputs (8 lanes of the
  lengths ``chip_smoke.py`` phase 4 reaches at its snapshot step, 58-block
  tables of 16 rows, 16/8 heads of 128, d 1024, f 3072, bf16), twice,
  then from ``torch.profiler`` the device time of each CUDA kernel of a
  call (a programmatic dependent's time includes its wait for the grid
  before it) and the timeline of one call enqueued behind a spin kernel:
  each kernel's start and end from the first kernel's start;
- ``ssd_scan_bshpn`` at zamba2's layer-0 shape (b 2, s 1024, h 64, p = n
  = 64, chunk 256, B/C broadcast, bf16) and the mLSTM's (b 1, s 1024, h
  4, p = n = 512), twice each;
- ``chip_smoke.py`` phase 3d's fused sweep and phase 15's SSD sweep,
  unless ``--quick``.

    python3 tools/bench_fused_ssd.py [TREE] [--quick] [--out FILE]
        [--set FILE:NAME=VALUE ...]

TREE (default: this checkout) is a checkout of the repo, for example a
parent unpacked with ``git archive`` into ``build/``.  ``--set`` runs a
copy of TREE's kernel sources with one design constant changed (``constexpr
... NAME = VALUE;`` in ``csrc/FILE``), made under ``build/variants/``:
for example ``stream_gemm.cuh:kStages=2`` (weight ring depth),
``stream_gemm.cuh:kSplitActivation=false`` (activations rounded once to
bf16), ``stream_gemm.cuh:kTargetBlocks=132`` (fewer depth slices).
Kernels are built from the tree's (or the copy's) own sources into its
own ``build/``.  Compare trees only within one run on one card,
in turns (parent, change, change, parent).  Prints one ``[bench]`` line
per case; ``--out`` also writes every number as JSON.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE_LENGTHS = (890, 273, 564, 332, 368, 112, 145, 88)
SERVE_TABLE = 58
CSRC = Path("src/repro_torch/kernels/csrc")
SPIN_CYCLES = 1_000_000     # ~0.5 ms of device time ahead of a profiled call


def variant_tree(tree: Path, sets: list[str]) -> Path:
    """A copy of ``tree``'s ``src/`` under this checkout's
    ``build/variants/`` with each ``FILE:NAME=VALUE`` applied."""
    key = hashlib.sha256((str(tree) + "|".join(sets)).encode()).hexdigest()
    out = ROOT / "build" / "variants" / key[:12]
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(tree / "src", out / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for item in sets:
        fname, assign = item.split(":", 1)
        name, value = assign.split("=", 1)
        path = out / CSRC / fname
        text = path.read_text()
        pat = re.compile(rf"(constexpr\s+\w+\s+{re.escape(name)}\s*=\s*)"
                         r"[^;]+;")
        if not pat.search(text):
            sys.exit(f"bench_fused_ssd: no constexpr {name} in {path}")
        path.write_text(pat.sub(rf"\g<1>{value};", text, count=1))
    return out


def serve_inputs(cs):
    """The fused layer's operands at the serve inputs (random values: the
    time does not depend on them)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    need = [-(-x // cs.BS) for x in SERVE_LENGTHS]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(SERVE_LENGTHS), SERVE_TABLE), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    torch.manual_seed(0)
    bf16 = torch.bfloat16
    n = len(SERVE_LENGTHS)
    return dict(
        h=torch.randn(n, cs.D_MODEL, device="cuda").to(bf16),
        q=torch.randn(n, cs.NH, cs.HD, device="cuda").to(bf16),
        kp=torch.randn(P, cs.BS, cs.NKV, cs.HD, device="cuda").to(bf16),
        vp=torch.randn(P, cs.BS, cs.NKV, cs.HD, device="cuda").to(bf16),
        tables=torch.from_numpy(tables).cuda(),
        lengths=torch.tensor(SERVE_LENGTHS, dtype=torch.int32,
                             device="cuda"),
        weights=cs.fused_weights(bf16, 0))


def kernel_name(key: str) -> str:
    """A kernel's name without its namespace and argument list."""
    key = key.replace("(anonymous namespace)::", "")
    return re.sub(r"\(.*", "", key).replace("void ", "")[:80]


def profile_fused(a, flush, out):
    """Device time of each CUDA kernel of a fused call (mean of 10), and
    the timeline of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    args = (a["h"], a["q"], a["kp"], a["vp"], a["tables"], a["lengths"],
            *a["weights"])
    for _ in range(3):
        ops.fused_decode_layer(*args, impl="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.zero_()
            ops.fused_decode_layer(*args, impl="cuda")
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "zero" in ev.key or "fill" in ev.key.lower():
            continue                 # host events, the L2 flush
        name = kernel_name(ev.key)
        us = ev.device_time
        out.setdefault("fused_profile_us", {})[name] = [us, ev.count]
        print(f"[bench] fused device time {name}: {us:.2f} us x "
              f"{ev.count}", flush=True)
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)   # the whole chain is enqueued
        ops.fused_decode_layer(*args, impl="cuda")
        torch.cuda.synchronize()
    kernels = sorted((ev.time_range.start, ev.time_range.end,
                      kernel_name(ev.name)) for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA
                     and "spin" not in ev.name)
    if not kernels:
        print("[bench] fused timeline: the profiler recorded no device "
              "events", flush=True)
        return
    t0 = kernels[0][0]
    out["fused_timeline_us"] = [(n, s - t0, e - t0) for s, e, n in kernels]
    for s, e, n in kernels:
        print(f"[bench] fused timeline {n}: {s - t0:.2f} .. {e - t0:.2f} us",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--quick", action="store_true",
                    help="the serve / layer-0 inputs only, no sweeps")
    ap.add_argument("--out", default=None, help="write the numbers here")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FILE:NAME=VALUE",
                    help="change one design constant of the kernels")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    if args.set:
        tree = variant_tree(tree, args.set)
    sys.path.insert(0, str(ROOT))             # the timer: this checkout's
    sys.path.insert(0, str(tree / "src"))     # the kernels: the tree's
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("bench_fused_ssd: needs a CUDA device")
    from repro_torch.kernels import _build
    _build.build_all(["fused_decode", "ssd_scan"])
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {"tree": str(tree), "set": args.set,
           "nvidia_smi": cs.nvidia_smi_line()}
    print(f"[bench] tree {tree} {' '.join(args.set)} on "
          f"{out['nvidia_smi']}", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_share", "max_abs_err")

    a = serve_inputs(cs)
    for rep in range(2):
        r = cs.measure_fused(a["h"], a["q"], a["kp"], a["vp"], a["tables"],
                             a["lengths"], a["weights"], None, "bfloat16",
                             flush)
        out[f"fused_serve_{rep}"] = r
        print(f"[bench] fused serve inputs (run {rep}): "
              + " ".join(f"{k}={r[k]:.4g}" for k in keys), flush=True)
    profile_fused(a, flush, out)
    del a

    for label, shape, bc in (("zamba2 layer 0", (2, 1024, 64, 64, 64), True),
                             ("mLSTM", (1, 1024, 4, 512, 512), False)):
        x, la, bm, cm = cs.ssd_inputs(*shape, torch.bfloat16, 300,
                                      broadcast=bc)
        for rep in range(2):
            r = cs.measure_ssd(x, la, bm, cm, 256, "bfloat16", flush)
            out[f"ssd_{label}_{rep}"] = r
            print(f"[bench] ssd {label} bf16 (run {rep}): "
                  + " ".join(f"{k}={r[k]:.4g}" for k in keys), flush=True)
        del x, la, bm, cm

    if not args.quick:
        out["fused_sweep"] = cs.phase_fused_sweep(flush)
        out["ssd_sweep"] = cs.phase_ssd_sweep(flush)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
