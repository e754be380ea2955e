#!/usr/bin/env python3
"""Time the port's decode paged-attention kernels, over fp pages and over
int8 pages, of one source tree on the card, with ``chip_smoke.py``'s
timer (CUDA events, L2 flushed, a spin kernel ahead, median of 20):

- at the serve path's inputs: 8 lanes of the lengths ``chip_smoke.py``
  phase 4 reaches at its snapshot step, 58-block tables of 16 rows,
  16/8 heads of 128, bf16 q over bf16 or int8 pages (random values: the
  time does not depend on them), twice each, then the device time of
  each CUDA kernel of one fp call from ``torch.profiler``;
- over ``chip_smoke.py`` phase 3's paged and int8 sweeps (8 and 32 lanes,
  lengths up to 4096, window 512), unless ``--quick``.

    python3 tools/bench_paged_decode.py [TREE] [--quick] [--out FILE]

TREE (default: this checkout) is a checkout of the repo: a parent unpacked
with ``git archive`` into ``build/``, or a copy whose
``csrc/paged_attention.cu`` has one design constant changed.  Its kernels
are built from its own sources into its own ``build/``.  Compare trees
only within one run on one card, in turns (parent, change, change,
parent).  Prints one ``[bench]`` line per case; ``--out`` also writes
every number as JSON.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE_LENGTHS = (890, 273, 564, 332, 368, 112, 145, 88)
SERVE_TABLE = 58


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--quick", action="store_true",
                    help="the serve inputs only, no sweeps")
    ap.add_argument("--out", default=None, help="write the numbers here")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))             # the timer: this checkout's
    sys.path.insert(0, str(tree / "src"))     # the kernels: the tree's
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("bench_paged_decode: needs a CUDA device")
    from repro_torch.kernels import _build, ops, ref
    _build.build_all(["paged_attention"])
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {"tree": str(tree), "nvidia_smi": cs.nvidia_smi_line()}
    print(f"[bench] tree {tree} on {out['nvidia_smi']}", flush=True)

    rng = np.random.default_rng(0)
    need = [-(-x // cs.BS) for x in SERVE_LENGTHS]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(SERVE_LENGTHS), SERVE_TABLE), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    tb = torch.from_numpy(tables).cuda()
    le = torch.tensor(SERVE_LENGTHS, dtype=torch.int32, device="cuda")
    torch.manual_seed(0)
    q = torch.randn(len(SERVE_LENGTHS), cs.NH, cs.HD,
                    device="cuda").to(torch.bfloat16)
    kp = torch.randn(P, cs.BS, cs.NKV, cs.HD, device="cuda")
    vp = torch.randn(P, cs.BS, cs.NKV, cs.HD, device="cuda")
    kq8, ks = ref.quantize_kv(kp)
    vq8, vs = ref.quantize_kv(vp)
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    keys = ("ms", "library_ms", "bound_ms", "bound_share", "max_abs_err")
    for rep in range(2):
        for name, r in (
                ("paged", cs.measure_paged(q, kp, vp, tb, le, None,
                                           "bfloat16", flush)),
                ("int8", cs.measure_quant(q, kq8, vq8, ks, vs, tb, le,
                                          None, flush))):
            out[f"serve_{name}_{rep}"] = r
            print(f"[bench] serve inputs {name} (run {rep}): "
                  + " ".join(f"{k}={r[k]:.4g}" for k in keys), flush=True)

    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        ops.paged_attention(q, kp, vp, tb, le, impl="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.zero_()
            ops.paged_attention(q, kp, vp, tb, le, impl="cuda")
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "split" in ev.key or "paged_attention_kernel" in ev.key:
            us = getattr(ev, "device_time", None) or ev.cuda_time
            out.setdefault("profile_us", {})[ev.key] = us
            name = re.search(r"(\w+)<", ev.key).group(1)
            print(f"[bench] device time {name}: {us:.2f} us x {ev.count}",
                  flush=True)

    if not args.quick:
        out["sweep"] = cs.phase_kernel_sweep(flush)
        out["quant_sweep"] = cs.phase_quant_sweep(flush)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
