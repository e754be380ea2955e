#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 25 alone on the card: training over a
device mesh at full width — (a) ``Session`` + ``SpmdTrainJob`` on a
(1, 1) NCCL mesh, 20 steps of qwen3-0.6b, against ``make_train_step``
without a mesh; (b) the training CLI and its checkpoint; (c) the
lowering dry run at decode_32k on the 256-rank fake mesh and the roofline
over its record — with every gate of the phase.

    python3 tools/spmd_phase.py [--out-dir DIR]

No kernel runs on this path, so nothing is built.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/spmd_phase.log`` and the
phase's numbers to ``DIR/spmd_phase.json``.
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
        cs.LOG_FILE = out_dir / "spmd_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[spmd] {smi}, torch {torch.__version__}")
    res = cs.phase_spmd(smi)
    cs.log(f"[spmd] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "spmd_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
