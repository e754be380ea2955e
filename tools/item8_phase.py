#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 22 alone on the card: ROADMAP Queue 1
item 8 up to MoE at full width — (a) the split-KV kernels at 5, 6, 7 and
12 query heads per KV head, the fused layer at the wide dense configs'
widths, flash at mixtral's shape; (b) qwen2.5-32b, yi-34b and
command-r-plus-104b served on the paged backend; (c) mixtral-8x22b and
dbrx-132b served on the slot backend; (d) mixtral's spilled eval; (e)
mixtral under SHARP; (f) small f32 engines — with every gate of the
phase.

    python3 tools/item8_phase.py [--out-dir DIR]

Builds the kernels from this checkout first.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/item8_phase.log`` and
the phase's numbers to ``DIR/item8_phase.json``.
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
        cs.LOG_FILE = out_dir / "item8_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[item8] {smi}, torch {torch.__version__}")
    kernels.build_all()
    cs.log(f"[item8] kernels built in {time.perf_counter() - t0:.1f} s")
    for k, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                cs.log(f"[build] {k}: {line.strip()}")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    res = cs.phase_item8(flush, smi)
    cs.log(f"[item8] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "item8_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
