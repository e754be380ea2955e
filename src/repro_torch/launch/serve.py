"""Serving CLI for the PyTorch port: synthetic requests through one
``InferenceEngine``.

``--backend slot|paged|spec`` picks the decode backend once (slot by
default, as in ``repro.launch.serve``); ``--backend spec`` takes
``--draft-model ARCH --draft-k N [--spec-inner slot|paged]`` for
speculative decoding with a draft model whose random weights come from
``--seed``, as the target's do (a same-arch draft therefore accepts every
proposal).  Weights are made on the device; prompts are drawn with numpy
from ``--seed + 1``.  Requests are prefilled in batched
calls and decoded with continuous batching; greedy sampling keeps outputs
deterministic.  ``--stagger`` drips requests in between decode steps so
late arrivals join mid-flight.  Prints the same ``engines`` / ``requests``
/ ``sample`` JSON keys as ``repro.launch.serve``.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --backend paged \\
      --batch 8 --prompt-len 256 --gen 32 --capacity 8
  python -m repro_torch.launch.serve --arch qwen3-0.6b --backend spec \\
      --draft-model qwen3-0.6b --draft-k 4 --spec-inner paged
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
      --device cpu --batch 3 --prompt-len 12 --gen 6 --capacity 2
  python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --batch 8 --prompt-len 64 --gen 16 --capacity 8

The recurrent families (``zamba2-1.2b``, hybrid; ``xlstm-350m``, ssm)
serve from the slot backend and prefill token by token; ``--backend
paged`` or ``spec`` falls back to slot with a warning, as in the JAX CLI.

(The session API, multi-model serving and HTTP come with later slices.)
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serving.engine import InferenceEngine


def synth_prompts(cfg, n: int, prompt_len: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size, (n, prompt_len), dtype=np.int32)


def serve(args) -> dict:
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device)
    max_seq = args.max_seq or (args.prompt_len + args.gen + 8)
    budget = int(args.kv_budget_mb * 2**20) if args.kv_budget_mb else None
    spec_kw = {}
    if args.backend == "spec":
        if not args.draft_model:
            raise ValueError("--backend spec needs --draft-model (the "
                             "draft member model's arch id)")
        draft_cfg = get_config(args.draft_model, smoke=args.smoke)
        dgen = torch.Generator(device=device).manual_seed(args.seed)
        spec_kw = dict(draft_cfg=draft_cfg,
                       draft_params=api.init_params(draft_cfg, dgen, device),
                       draft_k=args.draft_k, spec_inner=args.spec_inner)
    engine = InferenceEngine(cfg, params, capacity=args.capacity,
                             max_seq=max_seq, kv_budget_bytes=budget,
                             model_name=args.arch, backend=args.backend,
                             paged=args.paged, block_size=args.block_size,
                             prefix_share=not args.no_prefix_share,
                             device=device, **spec_kw)
    del params, spec_kw             # the engine holds its own copies
    pending = list(synth_prompts(cfg, args.batch, args.prompt_len,
                                 args.seed))
    drip = args.stagger if args.stagger > 0 else len(pending)
    while engine.has_work() or pending:
        for prompt in pending[:drip]:
            engine.submit(prompt, args.gen)
        pending = pending[drip:]
        engine.step()
    engine.run()
    done = list(engine.completed)
    return {"engines": {args.arch: engine.summary()},
            "requests": [r.metrics() for r in done],
            "sample": done[0].generated[:8] if done else []}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="model id")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=4,
                    help="decode lanes")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-lane cache length (default prompt+gen+8)")
    ap.add_argument("--kv-budget-mb", type=float, default=0,
                    help="KV admission budget (0 = the pool's worst case)")
    ap.add_argument("--stagger", type=int, default=0,
                    help="submit N requests per tick instead of all upfront")
    ap.add_argument("--backend", default=None,
                    choices=["slot", "paged", "spec"],
                    help="decode backend (default: slot; families whose "
                    "FamilySpec lacks a capability fall back with a "
                    "warning)")
    ap.add_argument("--draft-model", default=None,
                    help="draft member model for --backend spec (arch id; "
                    "must share the target's vocab)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--spec-inner", default=None,
                    choices=["slot", "paged"],
                    help="inner backend the spec backend wraps "
                    "(default slot)")
    ap.add_argument("--paged", action="store_true",
                    help="legacy spelling of --backend paged")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV rows per physical block")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="disable copy-on-write prompt-prefix page sharing")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    print(json.dumps(serve(args)))


if __name__ == "__main__":
    main()
