#!/usr/bin/env python3
"""The spread of ``chip_smoke.py``'s both-ways yardstick: qwen2.5-32b at 2
layers (phase 22 (b)'s model) serves phase 4's requests on the paged
backend to a snapshot, then one decode step of that snapshot runs
through the fused kernel, the fused plain version, the plain step and
the unfused kernel, ``--repeats`` times each, with PyTorch's bf16
reduced-precision GEMM reductions on and then off; each step's mean abs
logit distance from the f32 step is printed, and the max difference of
two plain steps on the same inputs.  ``--int8`` instead repeats phase 7's
gate: full-width qwen3-0.6b serves phase 4's requests from an int8 pool
to a snapshot, then one int8 decode step of it runs through the kernel
and the plain version, ``--repeats`` times each, each printed with its
max and mean abs distance from the f32 step (phase 7 gates the max).
``--locate`` looks for where two plain bf16 steps on the same inputs part:
phase 5's snapshot of full-width qwen3-0.6b (each lane's length and table
printed), the whole step per lane, the step layer by layer, then each
GEMM of layer 0 and the f32 LM head alone on fixed inputs.

    python3 tools/both_ways_noise.py [TREE] [--repeats 4] [--int8|--locate]

TREE (default: this checkout) is a checkout whose ``src/`` runs, its
kernels built from its own sources into its own ``build/`` (unpack a
parent with ``git archive HEAD | tar -x -C build/parent``).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def int8_noise(cs, repeats: int) -> None:
    """Phase 7's int8 both-ways step, repeated."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import \
        paged_attention_quant_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = cs.serve_prompts(cfg.vocab_size)
    eng = InferenceEngine(cfg, params, capacity=cs.CAPACITY,
                          max_seq=max(len(p) for p in prompts) + cs.GEN,
                          backend="paged", kv_dtype="int8",
                          block_size=cs.BS, device="cuda")
    snap, _, _ = cs.drive_serve(cfg, eng, prompts,
                                paged_attention_quant_lanes, "int8",
                                snap_step=8)
    # what the serve left: equal digests mean two trees hold the same
    # snapshot, so their distances come from the step alone
    digest = hashlib.sha256()
    for name in sorted(snap["pages"]):
        digest.update(snap["pages"][name].cpu().numpy().tobytes())
    for key in ("tables", "lengths", "tokens"):
        digest.update(snap[key].tobytes())
    cs.log(f"[noise int8] snapshot sha256 {digest.hexdigest()[:16]}, "
           f"next tokens {snap['tokens'][:, 0].tolist()}")
    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    params32 = api.prepare_params(cfg32, params, dev)

    def step(c, p, impl):
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        with torch.no_grad():
            return api.paged_decode_step(c, p, pages, tables, lengths,
                                         tokens, impl=impl).float()

    f32 = step(cfg32, params32, "ref")
    for rep in range(repeats):
        for impl in ("cuda", "ref"):
            d = (step(cfg, eng.params, impl) - f32).abs()
            cs.log(f"[noise int8] repeat {rep} {impl}: max abs from f32 "
                   f"{float(d.max()):.4f}, mean {float(d.mean()):.5f}")


def _distinct(fn, repeats: int) -> int:
    """How many bitwise-distinct results ``fn()`` gives in ``repeats``
    calls."""
    seen = []
    for _ in range(repeats):
        out = fn()
        if not any(torch_equal(out, o) for o in seen):
            seen.append(out)
    return len(seen)


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1
                            else a, b))


def locate(cs, repeats: int) -> None:
    """Where do two plain bf16 decode steps on the same inputs part?"""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = cs.serve_prompts(cfg.vocab_size)
    eng = InferenceEngine(cfg, params, capacity=cs.CAPACITY,
                          max_seq=max(len(p) for p in prompts) + cs.GEN,
                          backend="paged", block_size=cs.BS, device="cuda")
    snap, _, _ = cs.drive_serve(cfg, eng, prompts, paged_attention_lanes,
                                "locate", snap_step=8)
    cs.log(f"[locate] lengths {snap['lengths'].tolist()}, table entries "
           f"in use {(snap['tables'] != 0).sum(1).tolist()}, next tokens "
           f"{snap['tokens'][:, 0].tolist()}")
    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)

    def trace(impl):
        """Every layer's output and the logits of one step."""
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        block = tf._unfused_block(cfg, lambda lp, x, pg:
                                  nn.paged_attention_decode(
                                      lp, x, cfg, pages=pg, tables=tables,
                                      lengths=lengths, window=cfg.window,
                                      impl=impl))
        outs = []
        with torch.no_grad():
            x = nn.embed(eng.params["embed"], tokens, torch.bfloat16)
            for i, lp in enumerate(tf.layer_slices(eng.params["layers"],
                                                   cfg.n_layers)):
                x = block(lp, x, {k: v[i] for k, v in pages.items()})
                outs.append(x.clone())
            outs.append(nn.unembed(eng.params["embed"],
                                   tf._norm(cfg, eng.params["final_norm"],
                                            x)))
        return outs

    for impl in ("ref", "cuda"):
        runs = [trace(impl) for _ in range(repeats)]
        lane = [float((r[-1] - runs[0][-1]).abs().amax(dim=(1, 2)).max())
                for r in runs[1:]]
        per_lane = torch.stack([(r[-1] - runs[0][-1]).abs().amax(dim=(1, 2))
                                for r in runs[1:]]).amax(0)
        first = [next((i for i, (a, b) in enumerate(zip(r, runs[0]))
                       if not torch.equal(a, b)), None) for r in runs[1:]]
        cs.log(f"[locate] {impl} step x{repeats}: logits max abs from the "
               f"first run {lane}; per lane {per_lane.tolist()}; first "
               f"layer that parts (28 = LM head, None = bit-equal) {first}")
    lp = tf.layer_slices(eng.params["layers"], cfg.n_layers)[0]
    g = torch.Generator(dev).manual_seed(1)
    for path, w in (("attn/wq", lp["attn"]["wq"]),
                    ("attn/wk", lp["attn"]["wk"]),
                    ("attn/wo", lp["attn"]["wo"]),
                    ("mlp/w_gate", lp["mlp"]["w_gate"]),
                    ("mlp/w_down", lp["mlp"]["w_down"])):
        x = torch.randn((cs.CAPACITY, 1, w.shape[0]), generator=g,
                        device=dev).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        n = _distinct(lambda: x @ wb, repeats * 8)
        cs.log(f"[locate] bf16 ({cs.CAPACITY}, 1, {w.shape[0]}) @ "
               f"{tuple(w.shape)} {path}: {n} distinct results of "
               f"{repeats * 8}")
    table = eng.params["embed"]["table"]
    x = torch.randn((cs.CAPACITY, 1, cfg.d_model), generator=g, device=dev)
    n = _distinct(lambda: x @ table.float().t(), repeats * 8)
    cs.log(f"[locate] f32 LM head ({cs.CAPACITY}, 1, {cfg.d_model}) @ "
           f"{tuple(table.shape[::-1])}: {n} distinct results of "
           f"{repeats * 8}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--int8", action="store_true",
                    help="repeat phase 7's int8 step instead")
    ap.add_argument("--locate", action="store_true",
                    help="find where two plain bf16 steps part")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))

    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    cs.log(f"[noise] tree {args.tree}: {kernels.__file__}")
    if args.locate:
        locate(cs, args.repeats)
        cs.log(cs.nvidia_smi_line())
        return
    if args.int8:
        int8_noise(cs, args.repeats)
        cs.log(cs.nvidia_smi_line())
        return
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
