#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 18 and 19 alone on the card: the
paper's Fig 8 at full width (bert-large-1b under SHARP, then model,
pipeline and task parallelism over the same unit runtimes) and phase 4's
requests through length-bucketed prefill, with every gate of both.

    python3 tools/fig8_buckets_phase.py

Phase 19's tokens are not compared with phase 4's (not made here).
Builds the kernels from this checkout first.  Needs a GPU.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[fig8-buckets] {smi}, torch {torch.__version__}, "
           f"MemAvailable {cs.mem_available_bytes()} B")
    kernels.build_all()
    cs.log(f"[fig8-buckets] kernels built in {time.perf_counter() - t0:.1f} s")
    cs.phase_fig8(smi)
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-0.6b")
    cs.phase_bucketed_serve(cfg, cs.serve_prompts(cfg.vocab_size), {}, smi)
    cs.log(f"[fig8-buckets] total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
