#!/usr/bin/env python3
"""Time the port's RMSNorm and SwiGLU kernels of one source tree on the
card, with ``chip_smoke.py``'s timer (CUDA events, L2 flushed, a spin
kernel ahead, median of 20) at ``chip_smoke.py`` phase 3e's rows: the
harness floor (an empty kernel), then for bf16 and f32 rows {1, 8, 32,
33, 127, 2048} of d 1024 (SwiGLU f 3072), RMSNorm at 512 x 1022 and both
at the profiler's probe shapes (512, 512[, 1024]).  Each line gives the
kernel's time, its error against the plain version, ``F.rms_norm``'s time
beside RMSNorm and, unless ``--quick``, the plain versions' times and
(bf16) the cuBLAS composition ``(F.silu(x @ Wg) * (x @ Wu)) @ Wd`` beside
SwiGLU.  ``--profile`` adds, for SwiGLU at each row count, the device
time of each CUDA kernel of a call from ``torch.profiler`` (mean of 5
calls; a programmatic dependent launch's time includes its wait for the
grid before it).

    python3 tools/bench_rms_swiglu.py [TREE] [--quick] [--profile]
        [--out FILE] [--route stream|tiled] [--set FILE:NAME=VALUE ...]

TREE (default: this checkout) is a checkout of the repo, for example a
parent unpacked with ``git archive`` into ``build/``.  ``--route`` sends
every SwiGLU call of a tree that has two routes down one of them (a
measurement of the route at rows the wrapper gives the other).  ``--set``
runs a copy of TREE's kernel sources with one design constant changed, as
in ``tools/bench_fused_ssd.py``: for example ``swiglu.cu:kStages=4`` (ring
depth), ``rmsnorm.cu:kWarpRowsPerBlock=8``.  Kernels are built from the
tree's (or the copy's) own sources into its own ``build/``.  Compare trees
only within one run on one card, in turns (parent, change, change,
parent).  Prints one ``[bench]`` line per case; ``--out`` also writes
every number as JSON.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_swiglu(fn, flush):
    """{kernel name: (mean device us, launches a call)} over 5 calls."""
    import torch
    from bench_fused_ssd import kernel_name
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or "zero" in ev.key or "fill" in ev.key.lower():
            continue                 # host events, the L2 flush
        out[kernel_name(ev.key)] = (ev.device_time, ev.count / 5)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--quick", action="store_true",
                    help="kernel (and F.rms_norm) times only")
    ap.add_argument("--out", default=None, help="write the numbers here")
    ap.add_argument("--profile", action="store_true",
                    help="SwiGLU's device time by kernel (torch.profiler)")
    ap.add_argument("--route", choices=("stream", "tiled"), default=None,
                    help="force one SwiGLU route")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FILE:NAME=VALUE",
                    help="change one design constant of the kernels")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "tools"))
    from bench_fused_ssd import variant_tree
    tree = Path(args.tree).resolve()
    if args.set:
        tree = variant_tree(tree, args.set)
    sys.path.insert(0, str(ROOT))             # the timer: this checkout's
    sys.path.insert(0, str(tree / "src"))     # the kernels: the tree's
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("bench_rms_swiglu: needs a CUDA device")
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import swiglu as sw
    if args.route is not None:
        sw.STREAM_MAX_ROWS = {
            dt: 1 << 30 if args.route == "stream" else 0
            for dt in getattr(sw, "STREAM_MAX_ROWS", {})}
    _build.build_all(["rmsnorm", "swiglu"])
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {"tree": str(tree), "set": args.set, "route": args.route,
           "nvidia_smi": cs.nvidia_smi_line(),
           "harness_floor_ms": cs.harness_floor_ms(flush), "rows": []}
    print(f"[bench] tree {tree} {' '.join(args.set)} route {args.route} "
          f"on {out['nvidia_smi']}; harness floor "
          f"{out['harness_floor_ms']:.4f} ms", flush=True)

    def err(got, exp):
        torch.cuda.synchronize()
        return float((got.float() - exp.float()).abs().max())

    cases = [(m, cs.D_MODEL, cs.D_FF) for m in cs.SWEEP_ROWS]
    cases += [(*cs.RAGGED_RMS, None), cs.PROBE_SHAPE]
    for dt in ("bfloat16", "float32"):
        for rows, d, f in cases:
            x, w, mats = cs.rms_swiglu_inputs(rows, d, f or 8, dt)
            r = {"dtype": dt, "rows": rows, "d": d, "f": f,
                 "rms_ms": cs.cuda_ms(lambda: ops.rms_norm(x, w,
                                                           impl="cuda"),
                                      flush=flush),
                 "rms_lib_ms": cs.cuda_ms(
                     lambda: F.rms_norm(x, (d,), w, 1e-6), flush=flush),
                 "rms_err": err(ops.rms_norm(x, w, impl="cuda"),
                                ref.rms_norm_ref(x, w))}
            if not args.quick:
                r["rms_plain_ms"] = cs.cuda_ms(
                    lambda: ref.rms_norm_ref(x, w), iters=5, flush=flush)
            line = (f"[bench] {dt} rows={rows} d={d}: rms_norm "
                    f"ms={r['rms_ms']:.4f} F.rms_norm={r['rms_lib_ms']:.4f}"
                    f" err={r['rms_err']:.3g}")
            if f is not None:
                wg, wu, wd = mats
                r["swiglu_ms"] = cs.cuda_ms(
                    lambda: ops.swiglu(x, *mats, impl="cuda"), flush=flush)
                r["swiglu_err"] = err(ops.swiglu(x, *mats, impl="cuda"),
                                      ref.swiglu_ref(x, *mats))
                line += (f" | swiglu f={f} ms={r['swiglu_ms']:.4f} "
                         f"err={r['swiglu_err']:.3g}")
                if args.profile:
                    r["swiglu_profile_us"] = profile_swiglu(
                        lambda: ops.swiglu(x, *mats, impl="cuda"), flush)
                    line += " | " + ", ".join(
                        f"{k[:40]} {us:.2f} us x {n:g}" for k, (us, n)
                        in r["swiglu_profile_us"].items())
                if not args.quick:
                    r["swiglu_plain_ms"] = cs.cuda_ms(
                        lambda: ref.swiglu_ref(x, *mats), iters=5,
                        flush=flush)
                    line += f" plain={r['swiglu_plain_ms']:.4f}"
                    if dt == "bfloat16":
                        r["cublas_bf16_ms"] = cs.cuda_ms(
                            lambda: (F.silu(x @ wg) * (x @ wu)) @ wd,
                            flush=flush)
                        line += f" cublas_bf16={r['cublas_bf16_ms']:.4f}"
            out["rows"].append(r)
            print(line, flush=True)
            del x, w, mats
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
