"""Batched serving on the PyTorch port — ``examples/serve_batched.py``
through ``hydra_torch``: three architecture families (dense GQA, MoE, and
a recurrent xLSTM whose state is O(1) in context length) served side by
side through one ``hydra.Session``, the session's LRTF policy picking
which model's engine ticks next.

The dense model admits with power-of-two length buckets (mixed prompt
lengths share one padded prefill); the recurrent model keeps exact-length
groups — its state cannot be rewound past a pad tail — and so does the
MoE model, whose capacity-bounded routing would let pad tokens displace
real tokens' expert routes.  One model starts ``cold``: its params live
spilled in the session's host store until the first request promotes
them (SHARP-for-inference).

    PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]

Runs on a CUDA device, or on the CPU when asked.  The prompts come from a
numpy generator (the JAX example draws them with ``jax.random``).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

import hydra_torch as hydra  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402

ARCHS = ("qwen3-0.6b", "mixtral-8x22b", "xlstm-350m")
COLD = "mixtral-8x22b"
GEN = 8


def prompts_for(cfg, n, seed):
    # deliberately mixed lengths: bucketing groups them into one prefill
    lens = [11 + 2 * i for i in range(n)]
    return [np.random.default_rng(seed + i).integers(
        0, cfg.vocab_size, (L,)).astype(np.int32) for i, L in enumerate(lens)]


def main(device="cuda", cfgs=None, params=None, prompts=None, gen=GEN,
         budget=None) -> dict:
    """Returns ``{"serve": {job id: the engine's record}, "schedule":
    the session's serve trace, "tokens": {model: each request's generated
    tokens}}``.  ``cfgs`` (one per model, in ``ARCHS`` order) default to
    the smoke configs; ``params`` (one tree or None per model) to each
    model's weights from seed i; ``prompts`` ({model: list of token
    arrays}) to three per model from ``prompts_for``; ``budget`` (the
    device bytes the cold model's shards are cut for) to
    ``HydraConfig``'s."""
    cfgs = cfgs or [get_config(a, smoke=True) for a in ARCHS]
    params = params or (None,) * len(cfgs)
    sized = {} if budget is None else {"device_budget_bytes": budget}
    session = hydra.Session(hydra.HydraConfig(scheduler="lrtf", **sized),
                            device=device)
    for i, cfg in enumerate(cfgs):
        session.submit(hydra.ServeJob(
            cfg, seed=i, name=cfg.name, capacity=4, max_seq=64,
            bucket_sizes="pow2",            # no-op on moe/recurrent families
            cold=(cfg.name == COLD), params=params[i]))

    requests = {}
    for i, cfg in enumerate(cfgs):
        ps = (prompts[cfg.name] if prompts is not None
              else prompts_for(cfg, 3, seed=10 * i))
        requests[cfg.name] = [session.submit_request(cfg.name, p, gen)
                              for p in ps]

    report = session.run()
    for jid, rec in sorted(report.serve.items()):
        cold = (f"  (cold: promoted {rec['promote_bytes'] / 1e6:.0f} MB "
                f"in {rec['promote_s'] * 1e3:.0f} ms)"
                if rec.get("cold") else "")
        print(f"{rec['model']:18s} {rec['n_completed']} done   "
              f"prefill_calls={rec['prefill_calls']} "
              f"buckets={rec['bucket_sizes']}   "
              f"decode {rec['decode_tok_per_s'] or 0:8.1f} tok/s{cold}")
    print(f"schedule: {report.serve_trace[:12]} ...")
    return {"serve": dict(report.serve), "schedule": list(report.serve_trace),
            "tokens": {m: [list(r.generated) for r in reqs]
                       for m, reqs in requests.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
