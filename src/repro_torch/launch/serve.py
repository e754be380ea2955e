"""Serving CLI of the PyTorch port: a thin shell over
``repro_torch.api.Session`` + ``ServeJob`` (as ``repro.launch.serve``).

Synthetic requests are prefilled in batched calls and decoded with
continuous batching; greedy sampling keeps outputs deterministic.
``--stagger`` drips requests in between decode steps so late arrivals
join mid-flight, a comma-separated ``--arch`` list serves several models
at once with the session's scheduling policy (``--scheduler``, LRTF by
default) picking which model steps next, ``--buckets`` pads prompt
groups to power-of-two length buckets, ``--cold`` starts models spilled
in the host store (promoted on the first request), and ``--backend
slot|paged|spec`` picks the decode backend once (``--paged`` is the
legacy spelling of ``--backend paged``; ``--no-prefix-share`` disables
copy-on-write prompt-prefix page sharing; ``--backend spec`` takes
``--draft-model ARCH --draft-k N [--spec-inner slot|paged]``).
``--policy``, ``--deadline-ms``, ``--priority`` and ``--max-ttft-ms`` set
each model's admission policy and SLO defaults.  Weights are made on the
device from ``--seed`` (a draft's too, so a same-arch draft accepts every
proposal); prompts are drawn with numpy from ``--seed + 1``.  Prints the
same ``engines`` / ``schedule`` / ``requests`` / ``sample`` JSON keys as
``repro.launch.serve``.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --backend paged \\
      --batch 8 --prompt-len 256 --gen 32 --capacity 8
  python -m repro_torch.launch.serve --arch qwen3-0.6b --backend spec \\
      --draft-model qwen3-0.6b --draft-k 4 --spec-inner paged
  python -m repro_torch.launch.serve --arch qwen3-0.6b,xlstm-350m --smoke \\
      --device cpu --batch 3 --stagger 1 --cold

The recurrent families (``zamba2-1.2b``, hybrid; ``xlstm-350m``, ssm)
serve from the slot backend and prefill token by token; ``--backend
paged`` or ``spec`` (and ``--buckets``) falls back with a warning, as
in the JAX CLI.

With ``--http`` the CLI instead brings the models up behind the online
HTTP front end (``repro_torch.serving.server``): OpenAI-compatible
``/v1/completions`` and ``/v1/chat/completions`` with SSE token
streaming, ``/v1/cancel`` and ``DELETE /v1/requests/<id>``,
``/v1/models``, ``/v1/metrics`` and ``/health``.  It prints ``{"url":
..., "models": [...]}`` as its first line once the socket is bound
(``--port 0`` binds an ephemeral port) and serves until interrupted;
``--no-stream`` refuses streaming requests and ``--endpoint NAME`` adds a
route alias (``ServeJob.stream`` / ``ServeJob.endpoint``).

  python -m repro_torch.launch.serve --arch qwen3-0.6b --backend paged \
      --http --port 0
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.api import HydraConfig, ServeJob, Session
from repro_torch.configs import get_config


def build_serve_job(arch: str, args) -> ServeJob:
    cfg = get_config(arch, smoke=args.smoke)
    max_seq = args.max_seq or (args.prompt_len + args.gen + 8)
    budget = int(args.kv_budget_mb * 2**20) if args.kv_budget_mb else None
    draft = args.draft_model
    # pass both spellings through: ServeJob.requested_backend() resolves
    # the legacy --paged flag and rejects a conflicting --backend slot
    return ServeJob(cfg, seed=args.seed, name=arch, capacity=args.capacity,
                    max_seq=max_seq, kv_budget_bytes=budget,
                    bucket_sizes="pow2" if args.buckets else None,
                    cold=args.cold, backend=args.backend, paged=args.paged,
                    block_size=args.block_size,
                    prefix_share=not args.no_prefix_share,
                    draft_model=get_config(draft, smoke=args.smoke)
                    if draft else None,
                    draft_seed=args.seed, draft_k=args.draft_k,
                    spec_inner=args.spec_inner,
                    stream=not args.no_stream, endpoint=args.endpoint,
                    policy=args.policy,
                    deadline_ms=args.deadline_ms,
                    priority=args.priority or "normal",
                    max_ttft_ms=args.max_ttft_ms)


def synth_prompts(cfg, n: int, prompt_len: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size, (n, prompt_len), dtype=np.int32)


def serve(args) -> dict:
    archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    session = Session(HydraConfig(scheduler=args.scheduler, seed=args.seed),
                      device=args.device)
    jids = {a: session.submit(build_serve_job(a, args)) for a in archs}

    pending = []            # (model, prompt row) not yet submitted
    for arch in archs:
        cfg = session.jobs()[jids[arch]].cfg
        prompts = synth_prompts(cfg, args.batch, args.prompt_len, args.seed)
        pending.extend((arch, prompts[i]) for i in range(args.batch))

    # submit everything up front, or drip --stagger at a time between ticks
    drip = args.stagger if args.stagger > 0 else len(pending)
    while session.serve_has_work() or pending:
        for model, prompt in pending[:drip]:
            session.submit_request(model, prompt, args.gen)
        pending = pending[drip:]
        session.serve_tick()

    report = session.run()     # no train/eval jobs: collects serve summaries
    out = {"engines": {a: {k: v for k, v in report.serve[jids[a]].items()
                           if k != "requests"} for a in archs},
           "schedule": report.serve_trace if len(archs) > 1 else None,
           "requests": [r for a in archs
                        for r in report.serve[jids[a]].get("requests", [])]}
    if len(archs) == 1:
        eng = session.engine(archs[0])
        out["sample"] = eng.completed[0].generated[:8] if eng.completed else []
    return out


def serve_http(args) -> None:
    """Bring the models up behind the HTTP/SSE front end and block until
    interrupted."""
    from repro_torch.serving import HydraHTTPServer, MultiModelServer

    archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    session = Session(HydraConfig(scheduler=args.scheduler, seed=args.seed),
                      device=args.device)
    jids = {a: session.submit(build_serve_job(a, args)) for a in archs}
    engines = {a: session.engine(a) for a in archs}   # build + promote now
    options = {a: session.jobs()[jids[a]].http_options() for a in archs}
    server = MultiModelServer(engines, scheduler=args.scheduler)
    http = HydraHTTPServer(server, host=args.host, port=args.port,
                           model_options=options)
    http.start()
    # machine-readable first line: scripts parse the bound address
    # (--port 0 binds an ephemeral port)
    print(json.dumps({"url": http.url, "models": archs}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="model id, or comma-separated list for multi-model")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests per model")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=4,
                    help="decode lanes per model")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-lane cache length (default prompt+gen+8)")
    ap.add_argument("--kv-budget-mb", type=float, default=0,
                    help="KV admission budget per model (0 = uncapped)")
    ap.add_argument("--stagger", type=int, default=0,
                    help="submit N requests per tick instead of all upfront")
    ap.add_argument("--buckets", action="store_true",
                    help="pad prompt groups to power-of-two length buckets")
    ap.add_argument("--cold", action="store_true",
                    help="start models spilled; promote on first request")
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
                    help="KV rows per physical block (paged backend)")
    ap.add_argument("--no-prefix-share", action="store_true",
                    help="disable copy-on-write prompt-prefix page sharing "
                    "(paged backend)")
    ap.add_argument("--scheduler", default="lrtf",
                    choices=["lrtf", "srtf", "fifo", "random", "slo"],
                    help="multi-model routing policy; 'slo' adds a "
                    "deadline-urgency pre-pass over LRTF")
    ap.add_argument("--policy", default="slo", choices=["slo", "fifo"],
                    help="per-engine admission policy (ServeJob.policy): "
                    "'slo' = EDF with priority tiers + aging + paged "
                    "preemption; 'fifo' = arrival order")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default end-to-end deadline budget for every "
                    "request to this model (requests may override)")
    ap.add_argument("--priority", default=None,
                    choices=["high", "normal", "low"],
                    help="default priority tier for requests to this model")
    ap.add_argument("--max-ttft-ms", type=float, default=None,
                    help="default time-to-first-token budget (ms)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP (OpenAI-compatible /v1 endpoints "
                    "with SSE streaming) instead of a synthetic batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (0 binds an ephemeral port)")
    ap.add_argument("--no-stream", action="store_true",
                    help="disable SSE streaming on the served models "
                    "(ServeJob.stream=False)")
    ap.add_argument("--endpoint", default=None,
                    help="extra route alias clients may pass as 'model' "
                    "(ServeJob.endpoint; single-model serving)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.http:
        serve_http(args)
    else:
        print(json.dumps(serve(args)))


if __name__ == "__main__":
    main()
