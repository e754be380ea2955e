#!/usr/bin/env python3
"""The spread of ``chip_smoke.py``'s both-ways yardstick: qwen2.5-32b at 2
layers (phase 22 (b)'s model) serves phase 4's requests on the paged
backend to a snapshot, then one decode step of that snapshot runs
through the fused kernel, the fused plain version, the plain step and
the unfused kernel, ``--repeats`` times each, with PyTorch's bf16
reduced-precision GEMM reductions on and then off; each step's mean abs
logit distance from the f32 step is printed, and the max difference of
two plain steps on the same inputs.

    python3 tools/both_ways_noise.py [--repeats 4]

Builds the kernels from this checkout first.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    cfg = get_config("qwen2.5-32b").replace(n_layers=cs.ITEM8_LAYERS)
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = cs.serve_prompts(cfg.vocab_size)
    eng = InferenceEngine(cfg, params, capacity=cs.CAPACITY,
                          max_seq=max(len(p) for p in prompts)
                          + cs.ITEM8_GEN, backend="paged",
                          block_size=cs.BS, device="cuda")
    snap, _, _ = cs.drive_serve(cfg, eng, prompts, paged_attention_lanes,
                                "qwen2.5-32b paged", snap_step=8,
                                gen=cs.ITEM8_GEN)
    tables = torch.from_numpy(snap["tables"]).cuda()
    lengths = torch.from_numpy(snap["lengths"]).cuda()
    tokens = torch.from_numpy(snap["tokens"]).long().cuda()
    cfg32 = cfg.replace(dtype="float32")
    params32 = api.prepare_params(cfg32, params, "cuda")

    def step(c, p, impl):
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        with torch.no_grad():
            return api.paged_decode_step(c, p, pages, tables, lengths,
                                         tokens, impl=impl).float()

    f32 = step(cfg32, params32, "ref")
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = flag
        for rep in range(args.repeats):
            dist = {impl: float((step(cfg, eng.params, impl) - f32).abs()
                                .mean())
                    for impl in ("fused", "fused_ref", "ref", "cuda")}
            cs.log(f"[noise] bf16 reduced-precision reductions {flag}, "
                   f"repeat {rep}: mean abs from f32 " + ", ".join(
                       f"{k} {v:.5f}" for k, v in dist.items()))
        twice = {impl: float((step(cfg, eng.params, impl)
                              - step(cfg, eng.params, impl)).abs().max())
                 for impl in ("fused_ref", "ref")}
        cs.log(f"[noise] the same step twice, max abs difference: "
               f"fused_ref {twice['fused_ref']:.4f}, ref {twice['ref']:.4f}")
    cs.log(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
