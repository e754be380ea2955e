#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 26 alone on the card: the three
remaining examples at full width — (a) ``large_model_single_device_torch``
on bert-large-1b through spilling, then its spilled eval; (b)
``model_selection_torch`` on two grid points against the baselines; (c)
``serve_batched_torch`` with three families, one cold — and (d) the
lowering dry runs at long_500k and decode_32k on the 256-rank fake mesh,
with every gate of the phase.

    python3 tools/examples_phase.py [--out-dir DIR]

No kernel runs on this path, so nothing is built.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/examples_phase.log`` and
the phase's numbers to ``DIR/examples_phase.json``.
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
        cs.LOG_FILE = out_dir / "examples_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[examples] {smi}, torch {torch.__version__}")
    res = cs.phase_examples(smi)
    cs.log(f"[examples] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "examples_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
