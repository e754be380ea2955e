"""Dry runs of the PyTorch port (port of ``repro.launch.dryrun``).

``--plan`` is the Session plan dry run: it builds a ``Session`` over
``TrainJob``s of the ``--arch`` list, emits its ``Plan`` (partitions,
spill placement, the schedule estimate) as JSON without executing a
single unit, and asserts that the JSON round-trips byte for byte.  The
Plan written here is the same object ``Session.run`` consumes.

  python -m repro_torch.launch.dryrun --plan --arch qwen3-0.6b,bert-large-1b \\
      --smoke --budget-mb 18 --out results/plan_smoke.json

The JAX package's other mode lowers and compiles every (arch x input
shape x mesh) step on a 512-device mesh and records memory, cost and
collectives; it needs the mesh and the sharding rules of ROADMAP Queue 1
item 9.4, and raises here until they are ported.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.api import HydraConfig, Plan, Session, TrainJob
from repro_torch.configs import get_config
from repro_torch.models import api


def _plan_loader(cfg, batch, seq, seed, device):
    """Endless random batches (the plan reads none of them)."""

    class Loader:
        def __iter__(self):
            gen = torch.Generator(device).manual_seed(seed)
            while True:
                yield api.make_dummy_batch(cfg, batch, seq, generator=gen,
                                           device=device)

    return Loader()


def plan_dryrun(args) -> dict:
    """Build a Session over --arch TrainJobs, emit its Plan as JSON, and
    verify that the JSON round-trips byte for byte."""
    archs = [a.strip() for a in (args.arch or "qwen3-0.6b").split(",")
             if a.strip()]
    # what-if pricing: --profile plans against another machine's measured
    # facts (loaded without the freshness gate); the default (None, not
    # "auto") pins analytic pricing, so the plan does not depend on any
    # profile cached on this machine
    profile = None
    if args.profile:
        from repro_torch.profiler import load_facts
        profile = load_facts(args.profile, require_fresh=False)
    session = Session(HydraConfig(
        n_devices=args.n_devices,
        device_budget_bytes=int(args.budget_mb * 10**6)),
        device=args.device, profile=profile)
    for i, arch in enumerate(archs):
        cfg = get_config(arch, smoke=args.smoke)
        loader = _plan_loader(cfg, 2, 64, i, args.device)
        session.submit(TrainJob(cfg, loader, epochs=1, steps_per_epoch=2,
                                seed=i, batch=2, seq=64))
    plan = session.plan()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    plan.save(args.out)
    if Plan.load(args.out).to_json() != plan.to_json():
        raise AssertionError(f"plan JSON does not round-trip ({args.out})")

    summary = plan.summary()
    print(json.dumps(summary))
    est = summary["est_makespan_s"]
    print(f"plan -> {args.out}  ({len(plan.jobs)} jobs, "
          f"est makespan {est:.3e}s, round-trip OK)" if est is not None
          else f"plan -> {args.out}  ({len(plan.jobs)} jobs, round-trip OK)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--out", default="results/plan.json")
    # session-plan mode: partition/spill/schedule, no execution
    ap.add_argument("--plan", action="store_true",
                    help="emit a Session Plan JSON (the only mode ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="(--plan) reduced configs")
    ap.add_argument("--n-devices", type=int, default=2,
                    help="(--plan) virtual device count")
    ap.add_argument("--budget-mb", type=float, default=18,
                    help="(--plan) per-device budget, MB")
    ap.add_argument("--profile", default=None,
                    help="(--plan) MachineFacts JSON to price the plan "
                    "with — the what-if tool; default analytic")
    ap.add_argument("--device", default="cuda",
                    help="(--plan) cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.plan:
        return plan_dryrun(args)
    raise NotImplementedError(
        "the lowering dry run (every arch x input shape x mesh step, "
        "its memory, cost and collectives) needs the mesh and sharding "
        "rules of ROADMAP Queue 1 item 9.4; --plan works")


if __name__ == "__main__":
    main()
