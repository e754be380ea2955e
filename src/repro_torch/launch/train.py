"""Training launcher over a device mesh (port of ``repro.launch.train``):
a thin shell over ``repro_torch.api.Session`` + ``SpmdTrainJob``.

Single-model training over a mesh — the substrate Hydra's multi-model
layer schedules over sub-meshes of.  One process is one rank on one
device: alone it trains on a (1, 1) mesh; under ``torchrun
--nproc-per-node N`` every rank takes one GPU (``LOCAL_RANK``) and the
"auto" mesh spans the N ranks (NCCL on the card, gloo with ``--device
cpu``).  The loop itself lives in ``repro_torch.api.session._run_spmd``;
rank 0 prints the log lines and the JSON summary.

Usage:
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 20 \\
      --device cpu
  python -m repro_torch.launch.train --arch qwen3-0.6b --steps 10 \\
      --ckpt-dir /tmp/ckpt
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-0.6b --steps 20
"""

from __future__ import annotations

import argparse
import json

from repro_torch.api import Session, SpmdTrainJob
from repro_torch.configs import get_config


def job_from_args(args) -> SpmdTrainJob:
    cfg = get_config(args.arch, smoke=args.smoke)
    return SpmdTrainJob(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        accum=args.accum, lr=args.lr, optimizer=args.optimizer,
        seed=args.seed, data=args.data, mesh=args.mesh,
        multi_pod=args.multi_pod, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)


def train(args) -> dict:
    session = Session(device=getattr(args, "device", "cuda"))
    jid = session.submit(job_from_args(args))
    report = session.run()
    return report.spmd[jid]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=None, help="token .bin (else synthetic)")
    ap.add_argument("--mesh", default="auto", choices=["auto", "production"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    import torch.distributed as dist
    args = parser().parse_args(argv)
    out = train(args)
    if dist.get_rank() == 0:
        print(json.dumps({k: v for k, v in out.items() if k != "history"}))
    dist.destroy_process_group()      # the process's own group, started
    return out                        # by the run's mesh


if __name__ == "__main__":
    main()
