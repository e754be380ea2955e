#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 17 alone on the card: one ``Session``
training full-width qwen3-0.6b beside a hot paged and a cold slot
ServeJob, then the small f32 session and ``profiler --smoke``, with every
gate of the phase.

    python3 tools/session_phase.py

The phase's references come from this script instead of the earlier
phases: the losses of plain full-model training of the same model (seed
0, lr 1e-4, 3 steps of 2 x 1024; what phase 10's first model must equal)
and quick dense profiler facts built on the card (phase 13 runs the full
``build_facts()``); phase 4's tokens are not made, so the hot job's
tokens are not compared.  Builds the kernels from this checkout first.
About a minute with the build.  Needs a GPU.
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
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)
    from repro_torch.profiler import build_facts

    t0 = time.perf_counter()
    cs.log(f"[session-phase] {cs.nvidia_smi_line()}, torch "
           f"{torch.__version__}")
    kernels.build_all()
    cs.log(f"[session-phase] kernels built in "
           f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("qwen3-0.6b")
    _, ref = train_sequential_reference(ModelTask(
        cfg, cs.train_loader(cfg, 0), lr=cs.TRAIN_LRS[0], epochs=1,
        steps_per_epoch=cs.TRAIN_STEPS, seed=0, batch=cs.TRAIN_BATCH,
        seq=cs.TRAIN_SEQ), device="cuda")
    torch.cuda.empty_cache()
    cs.log(f"[session-phase] plain training losses {ref}")
    facts = build_facts(quick=True, families=["dense"], device="cuda")
    path = facts.save(str(ROOT / "build" / "profile_facts_quick.json"))
    cs.phase_session_serve(cfg, ref, {}, path)
    cs.log(f"[session-phase] total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
