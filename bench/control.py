"""Upper readings of a cell's checks: the plain reference put in the
program's place in a lower precision (the control), and planted faults,
each compared with the float32 reference exactly as a run compares the
program.  The benchmark's own runs never run this.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 \\
        [--device cuda] [--smoke]

Prints one JSON line a seed: {"seed", "control": readings, "half_batch":
readings, "unchanged": readings}, as the traffic kind's
``control_readings`` (``bench/kinds/<kind>.py``) reads them.  The control
computes every product from float8 e4m3 operands, the step below the
configuration's bf16 compute; "half_batch" takes the loss over half of each batch's rows;
"unchanged" (training) is a step that leaves the state as it was.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from bench import harness
    r = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT,
                        smoke=args.smoke)
    device = torch.device(args.device)
    for seed in args.seeds:
        read = r["kind"].control_readings(r, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **read}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
