#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, and serves.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. environment — torch / CUDA versions, the card's name and power limit;
2. build — every CUDA kernel of the port, from ``src/repro_torch/kernels/
   csrc``, with nvcc for sm_90a (one nvcc per source, in parallel);
3. kernel vs plain — the paged-attention kernel against its plain PyTorch
   version at the serving shapes of qwen3-0.6b (16 heads, 8 KV heads,
   head_dim 128, block 16; 8 and 32 lanes; ragged lengths 1..4096 with
   block boundaries; one inactive lane on the garbage block; one sliding-
   window case) in bf16 (tolerance 2e-2) and f32 (2e-5), with CUDA-event
   times of the kernel, the plain version and ``scaled_dot_product_attention``
   over pre-gathered K/V (the library yardstick; the port never calls it);
4. serve — full-width qwen3-0.6b (bf16 compute, f32 params seeded on the
   card) through ``InferenceEngine(backend="paged")``: 8 requests with
   prompts of 64..1024 tokens, two sharing a 256-token prefix (one also a
   partial boundary block, so aliasing and copy-on-write both run), 32
   tokens each, 8 lanes, block 16.  The kernel's launch count over this
   run must equal decode_steps x n_layers;
5. one decode step of the phase-4 engine state both ways — kernel and
   plain attention, both bf16 — each held against the same step in f32
   compute: the kernel's logits may be at most 2x as far from the f32
   step as the plain bf16 path's (bf16 noise over 28 layers, not the
   kernel, dominates); a small float32 engine served both ways must give
   identical tokens; and one profiled decode step (device busy share).

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "bfloat16": 989e12}   # dense bf16 tensor-core rate
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_REL = 2.0     # kernel vs f32 step, relative to plain bf16 vs f32
NH, NKV, HD, BS = 16, 8, 128, 16
GEN, CAPACITY = 32, 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20, flush=None) -> float:
    """Median device time of ``fn`` by CUDA events, after one warm-up;
    ``flush`` (a large buffer) is rewritten before each launch so the
    inputs come from HBM, as they do on the serving path, where each
    layer's pages were last touched a whole decode step earlier."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ---------------------------------------------------------------------------
# phase 3: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------

def paged_bytes_flops(lengths, tables_width, dtype_bytes, q_bytes, n, window):
    """Least bytes a launch must move — q read, out written, the K and V
    rows each lane attends to (rows inside [length - window, length)),
    tables, lengths — and the flops it must do (q.k and p.v over those
    rows), from these inputs."""
    rows = sum(int(le) - (max(0, int(le) - window) if window else 0)
               for le in lengths)
    nbytes = (rows * NKV * HD * 2 * dtype_bytes
              + 2 * n * NH * HD * q_bytes + 4 * n * tables_width + 4 * n)
    flops = 4 * rows * NH * HD
    return nbytes, flops


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measure_paged(q, kp, vp, tables, lengths, window, dtype_name, flush):
    """Kernel vs plain on one set of inputs: error, times, bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    out = ops.paged_attention(q, kp, vp, tables, lengths, window=window,
                              impl="cuda")
    exp = ref.paged_attention_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    # library yardstick: SDPA over K/V gathered and head-expanded ahead
    n, B = tables.shape
    S = B * BS
    g = NH // NKV
    tl = tables.long()
    k = kp[tl].reshape(n, S, NKV, HD).repeat_interleave(g, 2).transpose(1, 2)
    v = vp[tl].reshape(n, S, NKV, HD).repeat_interleave(g, 2).transpose(1, 2)
    pos = torch.arange(S, device=q.device)[None, :]
    le = lengths.long()[:, None]
    mask = pos < le
    if window:
        mask &= pos > le - 1 - window
    mask = mask[:, None, None, :]
    qh = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (lib()[:, :, 0].float() - exp.float()).abs().max()
    res = {
        "max_abs_err": float(diff.max()),
        "library_max_abs_err": float(lib_err),
        "within_tol": ok and finite,
        "ms": cuda_ms(lambda: ops.paged_attention(
            q, kp, vp, tables, lengths, window=window, impl="cuda"),
            flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_ref(
            q, kp, vp, tables, lengths, window=window), iters=5,
            flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = paged_bytes_flops(
        lengths.tolist(), B, kp.element_size(), q.element_size(), n, window)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def sweep_inputs(n, dtype, seed, max_len=4096):
    """Ragged lengths 1..max_len with block boundaries, distinct random
    physical blocks per lane, the last lane inactive (all-garbage table,
    length 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    edge = [min(e, max_len)
            for e in (1, BS - 1, BS, BS + 1, max_len, max_len - 1, 2 * BS,
                      1000)]
    lengths = rng.integers(1, max_len + 1, n)
    lengths[:min(n - 1, len(edge))] = edge[:min(n - 1, len(edge))]
    lengths[-1] = 1
    B = -(-max_len // BS)
    need = [-(-int(x) // BS) for x in lengths[:-1]]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((n, B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    dev = "cuda"
    q = torch.randn(n, NH, HD, device=dev).to(dtype)
    kp = torch.randn(P, BS, NKV, HD, device=dev).to(dtype)
    vp = torch.randn(P, BS, NKV, HD, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def phase_kernel_sweep(flush):
    import torch
    cases = [("bfloat16", 8, None), ("bfloat16", 32, None),
             ("float32", 8, None), ("float32", 32, None),
             ("bfloat16", 32, 512)]
    rows = []
    for i, (dt, n, window) in enumerate(cases):
        torch.manual_seed(i)
        args = sweep_inputs(n, getattr(torch, dt), seed=i)
        r = measure_paged(*args, window, dt, flush)
        r.update(dtype=dt, lanes=n, window=window,
                 lengths=args[4].tolist())
        rows.append(r)
        log(f"[kernel] paged_attention {dt} lanes={n} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}")
        if not r["within_tol"]:
            fail(f"paged_attention kernel disagrees with its plain version "
                 f"({dt}, {n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 4-5: serve full-width qwen3-0.6b, then one step both ways
# ---------------------------------------------------------------------------

def serve_prompts(vocab, seed=0):
    """8 prompts of 64..1024 tokens; prompt 1 is the first 264 tokens of
    prompt 0: it shares prompt 0's 256-token (16-block) prefix and the
    first half of its next block, so it aliases 17 blocks and
    copy-on-writes the partial one at its first decode step."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, 8)
    lens[0] = max(int(lens[0]), 300)
    prompts = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lens]
    prompts[1] = prompts[0][:256 + BS // 2].copy()
    return prompts


def phase_serve(cfg, params):
    import torch

    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.serving.engine import InferenceEngine

    prompts = serve_prompts(cfg.vocab_size)
    max_seq = max(len(p) for p in prompts) + GEN
    # warm-up engine (cuBLAS handles, kernel library load): not measured
    warm = InferenceEngine(cfg, params, capacity=2, max_seq=128,
                           block_size=BS, device="cuda")
    for p in prompts[2:4]:
        warm.submit(p[:64], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          block_size=BS, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(p, GEN, request_id=f"r{i}")
    paged_attention_lanes.launches = 0          # count the main path only
    t0 = time.perf_counter()
    snap = None
    while eng.step():
        if eng.decode_steps == 8 and snap is None:
            be = eng.backend
            snap = {"pages": {k: v.clone() for k, v in be.pool.pages.items()},
                    "tables": be._tables.copy(),
                    "lengths": be._lengths.copy(),
                    "tokens": eng._tokens[:, 0, :].copy()}
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention_lanes.launches
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"served {len(done)} of {len(prompts)} requests")
    for rid, r in done.items():
        if len(r.generated) != GEN or r.status.value != "finished":
            fail(f"{rid}: {len(r.generated)} tokens, status {r.status}")
    expect = summary["decode_steps"] * cfg.n_layers
    if launches != expect:
        fail(f"paged_attention launched {launches} times on the serve "
             f"path; expected decode_steps x layers = {expect}")
    if summary["shared_block_hits"] < 16 or summary["cow_copies"] < 1:
        fail(f"prefix sharing did not run: {summary['shared_block_hits']} "
             f"shared blocks, {summary['cow_copies']} copy-on-write copies")
    res = {
        "requests": len(done), "gen": GEN, "wall_s": wall,
        "prompt_lens": [len(p) for p in prompts],
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **{k: summary[k] for k in (
            "decode_steps", "prefill_calls", "prefill_tok_per_s",
            "decode_tok_per_s", "kv_page_peak_bytes", "kv_peak_bytes",
            "shared_block_hits", "cow_copies", "peak_concurrency",
            "paged_impl", "n_blocks", "block_bytes")},
        "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
        "sample": done["r0"].generated[:8],
    }
    log(f"[serve] qwen3-0.6b full width: {len(done)} requests x {GEN} "
        f"tokens, prefill {res['prefill_tok_per_s']} tok/s, decode "
        f"{res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, kernel launches {launches}, "
        f"kv_page_peak_bytes {res['kv_page_peak_bytes']}, "
        f"max_memory_allocated {res['max_memory_allocated']}, "
        f"shared_block_hits {res['shared_block_hits']}, cow_copies "
        f"{res['cow_copies']}")
    return eng, snap, res


def phase_both_ways(cfg, eng, snap, params):
    """One decode step of the snapshot state through the kernel and
    through the plain attention (both bf16), each held against the same
    step in float32 compute with the plain attention.  bf16 rounding over
    28 layers of random weights moves the logits far more than the
    kernel's own error, so the gate is relative to that noise: the
    kernel's logits may be at most LOGIT_REL times as far from the f32
    step as the plain bf16 step's are."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, eng.params, "cuda"),
            "ref": (cfg, eng.params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_decode_step(
                c, p, pages, tables, lengths, tokens, impl=impl).float()
            del pages
    torch.cuda.synchronize()
    a, b, f = logits["cuda"], logits["ref"], logits["f32"]
    err_k = float((a - f).abs().max())
    err_p = float((b - f).abs().max())
    res = {"max_abs_logit_diff_kernel_vs_plain": float((a - b).abs().max()),
           "max_abs_err_kernel_vs_f32": err_k,
           "max_abs_err_plain_vs_f32": err_p,
           "mean_abs_err_kernel_vs_f32": float((a - f).abs().mean()),
           "mean_abs_err_plain_vs_f32": float((b - f).abs().mean()),
           "max_abs_logit": float(f.abs().max()),
           "argmax_flips_kernel_vs_plain": int(
               (a.argmax(-1) != b.argmax(-1)).sum()),
           "argmax_flips_kernel_vs_f32": int(
               (a.argmax(-1) != f.argmax(-1)).sum()),
           "argmax_flips_plain_vs_f32": int(
               (b.argmax(-1) != f.argmax(-1)).sum()),
           "lanes": int(a.shape[0])}
    res["within_tol"] = (err_k <= LOGIT_REL * err_p
                         and bool(torch.isfinite(a).all()))
    log(f"[both-ways] one decode step: kernel vs plain max abs logit diff "
        f"{res['max_abs_logit_diff_kernel_vs_plain']:.4g}; vs the f32 step "
        f"kernel {err_k:.4g}, plain {err_p:.4g} (gate: kernel <= "
        f"{LOGIT_REL} x plain; max |logit| {res['max_abs_logit']:.3g}); "
        f"argmax flips kernel/plain {res['argmax_flips_kernel_vs_plain']}, "
        f"kernel/f32 {res['argmax_flips_kernel_vs_f32']}, plain/f32 "
        f"{res['argmax_flips_plain_vs_f32']} of {res['lanes']}")
    if not res["within_tol"]:
        fail("decode-step logits through the kernel are farther from the "
             f"f32 step ({err_k}) than {LOGIT_REL} x the plain bf16 "
             f"path's ({err_p})")
    return res


def phase_profile(cfg, eng, snap):
    """One decode step of the snapshot state under torch.profiler: device
    time summed over CUDA kernels against the step's wall time (the
    device's busy share), kernel launches, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    dev = "cuda"
    args = (torch.from_numpy(snap["tables"]).to(dev),
            torch.from_numpy(snap["lengths"]).to(dev),
            torch.from_numpy(snap["tokens"]).long().to(dev))
    pages = {k: v.clone() for k, v in snap["pages"].items()}
    with torch.no_grad():
        api.paged_decode_step(cfg, eng.params, pages, *args)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            api.paged_decode_step(cfg, eng.params, pages, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    del pages

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kern)
    res = {"wall_ms": wall * 1e3,
           "device_ms": busy_us / 1e3 if kern else None,
           "device_busy_share": busy_us / 1e6 / wall if kern else None,
           "kernel_launches": sum(e.count for e in kern),
           "top": [{"name": e.key[:80], "count": e.count,
                    "ms": dev_us(e) / 1e3}
                   for e in sorted(kern, key=dev_us, reverse=True)[:8]]}
    log(f"[profile] one decode step (8 lanes, profiler on): wall "
        f"{res['wall_ms']:.2f} ms, device {res['device_ms']} ms, busy "
        f"share {res['device_busy_share']}, {res['kernel_launches']} "
        f"kernel launches")
    for t in res["top"]:
        log(f"[profile]   {t['ms']:.3f} ms x{t['count']} {t['name']}")
    return res


def phase_small_f32():
    """A small float32 engine served through the kernel and through the
    plain attention must give identical tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(3),
                             "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9)]
    out = {}
    for impl in ("cuda", "ref"):
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                              block_size=8, paged_impl=impl, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(p, 12, request_id=f"s{i}")
        eng.run()
        out[impl] = {r.request_id: r.generated for r in eng.completed}
    same = out["cuda"] == out["ref"] and len(out["cuda"]) == len(prompts)
    log(f"[small-f32] smoke engine, kernel vs plain attention: tokens "
        f"identical = {same}")
    if not same:
        fail("small f32 engine: kernel and plain attention gave different "
             "tokens")
    return {"identical_tokens": same}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy  # noqa: F401

        from repro_torch import kernels
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.models import api
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report: dict = {}

    # 1. environment
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {name} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")
    report["env"] = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "device": name, "nvidia_smi": smi}

    # 2. build
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(kernels.KERNELS)} built in {build_s:.2f} s "
        f"(nvcc {_build.nvcc_path()}, sm_90a)")
    for k, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {k}: {line.strip()}")
    report["build_s"] = build_s

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    # 3. kernel vs plain over the sweep
    report["sweep"] = phase_kernel_sweep(flush)

    # 4. serve full-width qwen3-0.6b
    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    eng, snap, report["serve"] = phase_serve(cfg, params)

    # the kernel's numbers at the serve path's own inputs (layer 0 pages
    # and the lanes' lengths at the snapshot step)
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    tb = torch.from_numpy(snap["tables"]).cuda()
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(torch.bfloat16)
    main_path = measure_paged(q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                              tb, le, None, "bfloat16", flush)
    main_path["lengths"] = le.tolist()
    log(f"[kernel] paged_attention at the serve path's inputs "
        f"(lengths {main_path['lengths']}): ms={main_path['ms']:.4f} "
        f"plain_ms={main_path['plain_ms']:.4f} "
        f"library_ms={main_path['library_ms']:.4f} "
        f"bound_ms={main_path['bound_ms']:.4f} "
        f"max_abs_err={main_path['max_abs_err']:.3g}")
    if not main_path["within_tol"]:
        fail("paged_attention kernel disagrees with its plain version at "
             "the serve path's inputs")
    report["main_path_kernel"] = main_path

    # 5. one step both ways, and a small f32 engine both ways
    report["both_ways"] = phase_both_ways(cfg, eng, snap, params)
    report["profile"] = phase_profile(cfg, eng, snap)
    del eng, snap, params
    report["small_f32"] = phase_small_f32()
    report["total_s"] = time.perf_counter() - t_start

    kernel_line = {"kernels": [{
        "name": "paged_attention_lanes",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:76",
        "launches": report["serve"]["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
    }]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s")
    print(json.dumps(kernel_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
