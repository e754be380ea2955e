"""CLI: ``python -m repro_torch.profiler`` — probe this machine, persist
facts (port of ``python -m repro.profiler``).

    python -m repro_torch.profiler                 # full probes, the card
    python -m repro_torch.profiler --quick         # capped CI-sized probes
    python -m repro_torch.profiler --quick --device cpu --out /tmp/f.json
    python -m repro_torch.profiler --show          # summarize a profile
    python -m repro_torch.profiler --smoke --device cpu
        the profile-smoke A/B: quick dense probes, then plan and run ONE
        train + serve session twice (without and with the fresh facts),
        assert the plans' provenance differs (analytic vs measured
        pricing) and survives JSON, while both runs generate identical
        tokens — measured costs change estimates, never results.

Prints the facts' summary as JSON; the smoke prints one JSON record as
its last line.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.profiler import DEFAULT_PATH, MachineFacts, build_facts


def _smoke(out_path: str, device="cuda", facts=None) -> dict:
    """The plan-twice A/B of ``repro.profiler --smoke``: a TrainJob and a
    ServeJob of qwen3-0.6b smoke planned and run with no facts and with
    ``facts`` (quick dense probes on ``device``, saved to ``out_path``,
    when None)."""
    import numpy as np

    from repro_torch.api import HydraConfig, Plan, ServeJob, Session, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens

    if facts is None:
        facts = build_facts(quick=True, families=["dense"], device=device)
        facts.save(out_path)

    cfg = get_config("qwen3-0.6b", smoke=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 8, dtype=np.int32)
               for _ in range(3)]

    def plan_and_run(profile):
        session = Session(HydraConfig(n_devices=2,
                                      device_budget_bytes=18 * 10**6),
                          device=device, profile=profile)
        loader = SyntheticTokens(DataConfig(batch_size=2, seq_len=32,
                                            vocab_size=cfg.vocab_size))
        session.submit(TrainJob(cfg, loader, epochs=1, steps_per_epoch=2,
                                seed=0, batch=2, seq=32))
        sid = session.submit(ServeJob(cfg, seed=0, capacity=3, max_seq=64))
        plan = session.plan()
        # provenance must survive the wire: plan -> JSON -> plan
        rt = Plan.from_json(plan.to_json())
        if rt.provenance != plan.provenance:
            raise AssertionError("provenance lost in JSON")
        reqs = [session.submit_request(sid, p, 5) for p in prompts]
        session.run(rt)
        return plan, [list(map(int, r.generated)) for r in reqs]

    plan_a, toks_a = plan_and_run(None)          # unprofiled: analytic
    plan_b, toks_b = plan_and_run(facts)         # profiled: measured

    prov_a, prov_b = plan_a.provenance, plan_b.provenance
    checks = {"analytic plan cites no facts": prov_a["n_measured"] == 0
              and prov_a["profile"] is None,
              "profiled plan cites measured facts": prov_b["n_measured"] > 0
              and prov_b["profile"] is not None,
              "provenance differs": prov_a != prov_b,
              "every request got its tokens": all(
                  len(t) == 5 for t in toks_a + toks_b)}
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"profile smoke: {what} failed "
                                 f"({prov_a}, {prov_b})")
    if toks_a != toks_b:
        raise AssertionError(
            "measured-cost planning changed generated tokens — cost facts "
            "may only change estimates, never execution")
    return {
        "ok": True,
        "profile_path": out_path,
        "device": device,
        "decode_families": sorted(facts.decode),
        "transfer_points": len(facts.transfer.get("h2d", [])),
        "kernels": sorted(facts.kernels),
        "analytic_queries_a": prov_a["n_analytic"],
        "measured_queries_b": prov_b["n_measured"],
        "provenance_differs": prov_a != prov_b,
        "tokens_identical": toks_a == toks_b,
        "est_makespan_analytic_s": plan_a.schedule.get("est_makespan_s"),
        "est_makespan_measured_s": plan_b.schedule.get("est_makespan_s"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.profiler",
        description="measure this machine; persist MachineFacts JSON")
    ap.add_argument("--quick", action="store_true",
                    help="capped probe grids (CI-sized)")
    ap.add_argument("--out", default=DEFAULT_PATH,
                    help=f"facts path (default {DEFAULT_PATH})")
    ap.add_argument("--families", default=None,
                    help="comma list of decode-probe families "
                    "(default: all in full mode, dense in --quick)")
    ap.add_argument("--skip-kernels", action="store_true")
    ap.add_argument("--skip-decode", action="store_true")
    ap.add_argument("--show", action="store_true",
                    help="summarize an existing profile and exit")
    ap.add_argument("--smoke", action="store_true",
                    help="profile-smoke A/B (see module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="device the probes run on (default cuda)")
    args = ap.parse_args(argv)

    if args.show:
        facts = MachineFacts.load(args.out)
        print(json.dumps(facts.summary(), indent=1))
        return 0

    if args.smoke:
        out = args.out if args.out != DEFAULT_PATH \
            else "results/profile_smoke_torch.json"
        rec = _smoke(out, device=args.device)
        print(json.dumps({"profile_smoke": rec}))
        return 0

    fams = [f.strip() for f in args.families.split(",")] \
        if args.families else None
    facts = build_facts(quick=args.quick, families=fams,
                        skip_kernels=args.skip_kernels,
                        skip_decode=args.skip_decode, device=args.device)
    path = facts.save(args.out)
    print(json.dumps(facts.summary(), indent=1))
    print(f"profile -> {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
