#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 20 alone on the card: tiered memory at
full width — (a) byte-blocked preemption of phase 4's requests untiered
and with KV pages demoted to pinned host slabs and prefetched back, (b)
the pressure path, (c) an int8 pool, the page moves alone, (d) three
shard-resident qwen3-0.6b models under one ledger, (e) small f32
engines — with every gate of the phase.

    python3 tools/tiering_phase.py [--out-dir DIR]

Builds the kernels from this checkout first.  Needs a GPU.  With
``--out-dir`` the printed lines also go to ``DIR/tiering_phase.log`` and
the phase's numbers to ``DIR/tiering_phase.json``.
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
        cs.LOG_FILE = out_dir / "tiering_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[tier] {smi}, torch {torch.__version__}")
    kernels.build_all()
    cs.log(f"[tier] kernels built in {time.perf_counter() - t0:.1f} s")
    res = cs.phase_tiering(get_config("qwen3-0.6b"), smi)
    cs.log(f"[tier] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "tiering_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
