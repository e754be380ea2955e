#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 alone on the card: ROADMAP Queue 1
item 8's second half at full width — (a) the kernels at
llava-next-mistral-7b's 32/8 heads of 128 (verify also at 12 groups and
k 8, over query chunks), the fused layer at d 4096 / f 14336, flash at
llava's and whisper's decoder shapes; (b) llava served on the paged,
fused, spec and int8 backends at 32 layers; (c) llava's spilled eval from
embeddings; (d) whisper-medium under SHARP, probed, evaluated and
decoded; (e) vit-300m under SHARP; (f) small f32 engines — with every
gate of the phase.

    python3 tools/encdec_vlm_phase.py [--out-dir DIR]

Builds the kernels from this checkout first.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/encdec_vlm_phase.log``
and the phase's numbers to ``DIR/encdec_vlm_phase.json``.
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
        cs.LOG_FILE = out_dir / "encdec_vlm_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[item8b] {smi}, torch {torch.__version__}")
    kernels.build_all()
    cs.log(f"[item8b] kernels built in {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    res = cs.phase_item8b(flush, smi)
    cs.log(f"[item8b] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "encdec_vlm_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
