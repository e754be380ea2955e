"""CLI: ``python -m repro_torch.profiler`` — probe this machine, persist
facts (port of ``python -m repro.profiler``).

    python -m repro_torch.profiler                 # full probes, the card
    python -m repro_torch.profiler --quick         # capped CI-sized probes
    python -m repro_torch.profiler --quick --device cpu --out /tmp/f.json
    python -m repro_torch.profiler --show          # summarize a profile

Prints the facts' summary as JSON.  ``--smoke`` (the JAX CLI's plan-twice
A/B over a train and a serve job) needs the serve half of ``Session``,
which comes with a later slice of the port, and raises.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.profiler import DEFAULT_PATH, MachineFacts, build_facts


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
                    help="profile-smoke A/B (needs the serve half of "
                    "Session: not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="device the probes run on (default cuda)")
    args = ap.parse_args(argv)

    if args.show:
        facts = MachineFacts.load(args.out)
        print(json.dumps(facts.summary(), indent=1))
        return 0

    if args.smoke:
        raise NotImplementedError(
            "profiler --smoke plans and runs a ServeJob; the serve half of "
            "Session (ServeJob) comes with a later slice of the port")

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
