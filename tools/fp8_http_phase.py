#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 24 alone on the card: the fp8 KV cache,
the HTTP front end and checkpoints at full width — (a) + (b) full-width
qwen3-0.6b on bf16 and e4m3 pages (launches, page peak, both-ways step,
the softmax delta against the bf16 cache), the fused and spec paths over
e4m3 pages and each e4m3 kernel route at the serve inputs; (c)
``HydraHTTPServer`` under 12 concurrent clients, a mid-decode cancel,
the metrics baseline and a small f32 engine; (d) params saved and
restored in the JAX checkpoint format — with every gate of the phase.

    python3 tools/fp8_http_phase.py [--out-dir DIR]

Builds the kernels from this checkout first.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/fp8_http_phase.log``
and the phase's numbers to ``DIR/fp8_http_phase.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    out_dir = Path(args.out_dir) if args.out_dir else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        cs.LOG_FILE = out_dir / "fp8_http_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[fp8/http] {smi}, torch {torch.__version__}")
    kernels.build_all()
    cs.log(f"[fp8/http] kernels built in {time.perf_counter() - t0:.1f} s")
    for k, text in kernels._build.build_logs.items():
        for line in text.strip().splitlines():
            if "error" in line or "warning" in line:
                cs.log(f"[build] {k}: {line.strip()}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    res = cs.phase_fp8_http(flush, smi)
    cs.log(f"[fp8/http] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "fp8_http_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
