#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 21 alone on the card: planning and the
async session at full width — (a) phase 10's first TrainJob planned with
the probe oracle (a pilot per candidate shard) beside the analytic
partition, the plan saved; (b) a fresh session runs the loaded plan with
no pilot, its allocator peak within the budget; (c) ``run_async`` with a
hot paged ServeJob, requests submitted mid-run; (d) the quickstart and
``make_grad_step`` — with every gate of the phase.

    python3 tools/probe_async_phase.py [--out-dir DIR]

Builds the kernels from this checkout first.  Needs a GPU.  The losses
are held against plain training of the same job on the card (phase 10's
SHARP losses equal it at 3e-4) and phase 10's trained tok/s is not
known here.  With ``--out-dir`` the printed lines also go to
``DIR/probe_async_phase.log`` and the phase's numbers to
``DIR/probe_async_phase.json``.
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
        cs.LOG_FILE = out_dir / "probe_async_phase.log"
        cs.LOG_FILE.write_text("")
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    cs.log(f"[probe] {smi}, torch {torch.__version__}")
    kernels.build_all()
    cs.log(f"[probe] kernels built in {time.perf_counter() - t0:.1f} s")
    cfg = get_config("qwen3-0.6b")
    _, ref = train_sequential_reference(
        ModelTask(cfg, cs.train_loader(cfg, 0), lr=cs.TRAIN_LRS[0],
                  epochs=1, steps_per_epoch=cs.TRAIN_STEPS, seed=0,
                  batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ), device="cuda")
    torch.cuda.empty_cache()
    cs.log(f"[probe] plain training of phase 10's first job: {ref}")
    res = cs.phase_probe_async(cfg, smi, cs.serve_prompts(cfg.vocab_size),
                               ref, None)
    cs.log(f"[probe] total {time.perf_counter() - t0:.1f} s")
    if out_dir is not None:
        (out_dir / "probe_async_phase.json").write_text(
            json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
