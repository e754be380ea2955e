#!/usr/bin/env python3
"""The port's multi-rank mesh paths as gloo CPU ranks, without JAX: the
rank bodies of ``tests/test_torch_spmd_train.py`` and
``tests/test_torch_moe_expert_parallel.py`` (``tests/_torch_mesh_ranks.py``)
on whatever torch this machine has — to check a DTensor version the test
suite does not run (the GPU machine's torch can differ from the one the
tests run under, and DTensor differs between versions).

    python3 tools/mesh_ranks_check.py [--out-dir DIR]
    torchrun --nproc-per-node 4 tools/mesh_ranks_check.py --cuda

``--cuda`` (under ``torchrun``, four GPUs): the (2, 2) train step and
the sequence-sharded decode, one GPU a rank over NCCL, against the
unmeshed steps on each rank's GPU.

* four ranks on a (2, 2) mesh: one qwen3-0.6b smoke train step (f32,
  accum 2) against the unmeshed step, bound 2e-4 (loss, grad norm,
  every param);
* four ranks on a (2, 2) mesh: three qwen3-0.6b smoke decode steps (f32)
  over a KV cache whose sequence is sharded, in every layout of
  ``SEQ_DECODE_CASES``, against the unmeshed steps: logits within 2e-4,
  the same tokens, each rank's shard holding the new rows where it owns
  them and nothing else changed;
* eight ranks on a (2, 4) mesh: mixtral-8x22b smoke's expert-parallel
  layer against the local path (1e-5; lb_loss 1e-6), the end-to-end
  softmax against the unmeshed forward (5e-3), at least one all-to-all.

Exits 1 when a bound is missed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _seq_decode_summary(out_dir) -> dict:
    """Per case of the four ranks' ``seq_decode_<rank>.pt``: the largest
    logit and new-row differences, whether every rank's tokens equal the
    unmeshed ones and every other row stayed as it was; ``ok`` when all
    cases hold (2e-4)."""
    import torch
    ranks = [torch.load(Path(out_dir) / f"seq_decode_{r}.pt")
             for r in range(4)]
    out = {}
    for case in ranks[0]:
        rs = [r[case] for r in ranks]
        out[case] = {
            "logit_diff": max(o["logit_diff"] for o in rs),
            "new_rows_diff": max(o[f"{n}_new_rows_diff"] for o in rs
                                 for n in ("k", "v")),
            "tokens_equal": all(o["tokens"] == o["ref_tokens"] for o in rs),
            "others_unchanged": all(o[f"{n}_others_unchanged"] for o in rs
                                    for n in ("k", "v"))}
    out["ok"] = all(c["logit_diff"] <= 2e-4 and c["new_rows_diff"] <= 2e-4
                    and c["tokens_equal"] and c["others_unchanged"]
                    for c in out.values())
    return out


def main() -> None:
    import numpy as np
    import torch

    from _torch_mesh_ranks import (moe_ep_rank, run_ranks,
                                   seq_sharded_decode_rank, spmd_step_rank)
    from repro_torch.checkpoint.convert import params_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import api

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--cuda", action="store_true",
                    help="the (2, 2) step on four GPUs, under torchrun")
    args = ap.parse_args()
    res = {"torch": torch.__version__}
    if args.cuda:
        import os

        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out_dir = Path(args.out_dir or ROOT / "build")
        out_dir.mkdir(parents=True, exist_ok=True)
        rank = int(os.environ["RANK"])
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        spmd_step_rank(rank, str(out_dir), "qwen3-0.6b", 2, device="cuda")
        seq_sharded_decode_rank(rank, str(out_dir), device="cuda")
        dist.barrier()
        if rank == 0:
            step = torch.load(out_dir / "spmd_step.pt")
            res["spmd_step_cuda"] = {k: step[k] for k in
                                     ("loss", "grad_norm", "params")}
            res["seq_decode_cuda"] = _seq_decode_summary(out_dir)
            res["device"] = torch.cuda.get_device_name(0)
            res["ok"] = (max(res["spmd_step_cuda"].values()) <= 2e-4
                         and res["seq_decode_cuda"]["ok"])
            print(json.dumps(res))
        dist.destroy_process_group()
        sys.exit(0 if rank or res["ok"] else 1)
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(spmd_step_rank, 4, tmp, "qwen3-0.6b", 2, timeout=600)
        step = torch.load(Path(tmp) / "spmd_step.pt")
        res["spmd_step"] = {k: step[k] for k in ("loss", "grad_norm",
                                                 "params")}
        run_ranks(seq_sharded_decode_rank, 4, tmp, timeout=600)
        res["seq_decode"] = _seq_decode_summary(Path(tmp))
        cfg = get_config("mixtral-8x22b", smoke=True)
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        rng = np.random.default_rng(2)
        np.savez(Path(tmp) / "moe_inputs.npz",
                 x=(rng.standard_normal((4, 64, cfg.d_model)) * 0.3)
                 .astype(np.float32),
                 tokens=rng.integers(0, cfg.vocab_size, (4, 64))
                 .astype(np.int32), **_flat(params_to_numpy(params)))
        run_ranks(moe_ep_rank, 8, tmp, timeout=600)
        out = np.load(Path(tmp) / "moe_out.npz")
        res["moe_ep"] = {
            "max_abs_diff": float(np.abs(out["y_ep"] - out["y_ref"]).max()),
            "lb_rel_diff": abs(float(out["lb_ep"]) - float(out["lb_ref"]))
            / abs(float(out["lb_ref"])),
            "softmax_diff": float(out["softmax_diff"]),
            "n_all_to_all": int(out["n_a2a"])}
    ok = (max(res["spmd_step"].values()) <= 2e-4
          and res["seq_decode"]["ok"]
          and res["moe_ep"]["max_abs_diff"] <= 1e-5
          and res["moe_ep"]["lb_rel_diff"] <= 1e-6
          and res["moe_ep"]["softmax_diff"] < 5e-3
          and res["moe_ep"]["n_all_to_all"] >= 1)
    res["ok"] = ok
    print(json.dumps(res))
    if args.out_dir:
        Path(args.out_dir).mkdir(parents=True, exist_ok=True)
        (Path(args.out_dir) / "mesh_ranks_check.json").write_text(
            json.dumps(res, indent=1))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
