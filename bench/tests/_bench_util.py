"""Shared by the benchmark's tests: the paths the benchmark imports from,
and one smoke run of a cell on the CPU."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

TRAIN_CELLS = ("bert1b.grid3.train",)
EVAL_CELLS = ("bert1b.eval.spilled",)


def smoke_archs() -> dict:
    """The smoke size of every configuration, and the same block fed
    embeddings (the family's other batch layout)."""
    import json
    out = {}
    for f in sorted((ROOT / "bench" / "configs").glob("*.json")):
        arch = json.loads(f.read_text())["smoke"]["arch"]
        out[f.stem] = arch
        out[f.stem + ".embeds"] = {**arch, "takes_embeddings": True,
                                   "vocab_size": 10}
    return out


def smoke_run(workload: str, seed: int = 3, seconds: float = 0.3,
              trace: bool = False, device: str = "cpu"):
    """One run of ``workload`` at its smoke size, chip check skipped, on
    two CPU threads (the sizes are tiny; more threads only contend with
    the other test workers)."""
    import torch

    from bench import harness
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(workload, seed, seconds, trace,
                                device=device, proc_start=time.time(),
                                smoke=True)
    finally:
        torch.set_num_threads(threads)
