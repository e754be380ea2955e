#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. environment — torch / CUDA versions, the card's name and power limit;
2. build — every CUDA kernel of the port, from ``src/repro_torch/kernels/
   csrc`` (``paged_attention.cu``: the split-KV fp and int8 decode
   kernels, two CUDA launches per op call — splits of 128 rows, grid
   (kv_head, lane, split), then their merge in a fixed order;
   ``paged_verify.cu``: the split-KV verify kernel, two CUDA launches per
   op call — the splits of 256 rows, grid (kv_head, lane, split), then
   their merge in a fixed order (``split_kv.cuh``, shared by both);
   ``flash_attention.cu``: the bf16 flash
   kernel on the tensor cores (wgmma, 128-byte-swizzled cp.async ring)
   and the f32 flash kernel on the CUDA cores beside it, chosen by dtype;
   ``fused_decode.cu``: the fused decode layer, eight CUDA launches per
   op call — the split-KV decode kernel and its merge (``paged_decode.cuh``,
   shared with ``paged_attention.cu``), then the weight-streaming products
   (``stream_gemm.cuh``: bf16 on the tensor cores, f32 on the CUDA cores)
   and the row passes as programmatic dependent launches; ``rmsnorm.cu``:
   a row held in registers from 16-byte loads; ``swiglu.cu``: at most 32
   bf16 / 8 f32 rows the fused layer's streaming products (4 launches),
   past that two tiled mma.sync launches, f32 split into bf16 hi + lo;
   ``ssd_scan.cu``: bf16 on the tensor cores (mma.sync), f32 on the
   CUDA cores; shared device code in ``*.cuh``), with nvcc for
   sm_90a, one nvcc per source, in parallel;
3. kernel vs plain — each kernel against its plain PyTorch version at the
   serving shapes of qwen3-0.6b (16 heads, 8 KV heads, head_dim 128,
   block 16; 8 and 32 lanes; ragged lengths up to 4096 with block
   boundaries; one lane on the garbage block; one sliding-window case):
   the paged-attention kernel in bf16 (tolerance 2e-2) and f32 (2e-5); the
   verify kernel at k = 1, 4, 8 in bf16 and f32; the int8 kernel with bf16
   q over int8 pages (2e-2).  A paged, int8 or verify op call is two CUDA
   launches (split kernel and merge) counted as one.  Each with
   CUDA-event times of the kernel,
   the plain version and ``scaled_dot_product_attention`` over K/V
   gathered (and for int8 dequantized) ahead with an explicit mask — the
   library yardstick, which the port never calls (every ``[kernel]`` line
   also gives ``bound_share`` = bound_ms / ms); the fused decode layer
   (d 1024, f 3072; 8 and 32 lanes, the same ragged lengths, garbage lane
   and window case) in bf16 (2e-2) and f32 (2e-4); the harness floor
   (``cuda_ms`` of an empty kernel), then RMSNorm and SwiGLU at rows {1,
   8, 32, 33, 127, 2048} of d 1024 (f 3072; SwiGLU's routes meet at 32 |
   33 rows in bf16, 8 | 9 in f32), RMSNorm at 512 x 1022 (its element
   path), both at the profiler's probe shapes (512, 512[, 1024]), in
   bf16 (2e-2) and f32
   (2e-5 / 2e-4), with ``F.rms_norm`` as RMSNorm's yardstick (the fused
   layer and SwiGLU have no one-call equivalent; bf16 SwiGLU rows also
   time the cuBLAS composition, which rounds the hidden to bf16: not the
   same function);
4. serve — full-width qwen3-0.6b (bf16 compute, f32 params seeded on the
   card) through ``InferenceEngine(backend="paged")``: 8 requests with
   prompts of 64..1024 tokens, two sharing a 256-token prefix (one also a
   partial boundary block, so aliasing and copy-on-write both run), 32
   tokens each, 8 lanes, block 16.  The paged-attention kernel's launch
   count over this run must equal decode_steps x n_layers;
5. one decode step of the phase-4 engine state both ways — kernel and
   plain attention, both bf16 — each held against the same step in f32
   compute: the kernel's logits may be at most 2x as far from the f32
   step as the plain bf16 path's (bf16 noise over 28 layers, not the
   kernel, dominates); and one profiled decode step (device busy share);
5b. fused serve — the same requests through ``paged_impl="fused"``: the
   fused layer must run decode_steps x n_layers times; one decode step
   both ways (fused kernel and fused plain version, bf16), each gated
   against the f32 step as in phase 5; one fused step profiled beside
   phase 5's; tokens matching phase 4 reported, not gated (bf16);
6. speculative serve — the same requests through ``backend="spec",
   spec_inner="paged"``, draft_k 4: (a) with the target's own parameters
   as the draft, (b) with a random 4-layer qwen3-0.6b draft (seed 1), so
   rollback runs every round.  The verify kernel must launch spec_rounds
   x n_layers times, and the pool and the ledger must be empty after; one
   verify round both ways, gated as in phase 5; one draft chain and one
   verify forward profiled, for each draft;
7. int8 serve — the same requests through ``backend="paged",
   kv_dtype="int8"``: the int8 kernel must launch decode_steps x n_layers
   times and a block cost 2·28·16·8·(128+4) B; one int8 decode step both
   ways, gated as in phase 5, and one profiled;
8. small float32 engines — paged decode through the kernel and the plain
   version, speculative decode through the verify kernel against plain
   paged greedy, int8 pages through the int8 kernel and the plain
   version, and the fused decode layer's kernel against the plain unfused
   paged engine must each give identical tokens;
9. flash kernel vs plain — 16/8 heads, head_dim 128, b 1 and 2, sq = sk
   in {64, 127, 128, 129, 1000, 2048, 4096} and two sq < sk, causal and
   not, window 512, bf16 (2e-2: the tensor-core kernel) and f32 (2e-5:
   the CUDA-core kernel), with the kernel's, the plain version's and
   SDPA's times (same mask) and the bound;
10. SHARP training — two full-width qwen3-0.6b TrainJobs (seeds 0 and 1,
   lr 1e-4 and 3e-4, AdamW, SyntheticTokens batch 2 x seq 1024, 3 steps)
   through ``Session`` on two virtual devices of 5 GB: at least 3 shards a
   model, models x steps x 2 x shards units, the ledger never over its
   budget, and each model's losses equal to plain full-model training on
   the card (``train_sequential_reference``) at 3e-4;
11. spilled eval — an ``EvalJob`` of 2 batches over model 0's trained
   params through the shard queue (2 GB budget), with the flash kernel
   and with plain attention: the kernel must launch batches x 28 times;
   one full forward through the kernel, gated against an f32 forward as
   in phase 5; the kernel's numbers at layer 0's q/k/v of the batch;
12. one SHARP forward unit and one backward unit (promotion, compute,
   and for the backward the optimizer step and demotion) profiled;
13. profiler — ``build_facts()`` on the card (transfer rows in GB/s, the
   dense, ssm and hybrid decode grids, the seven kernel rows — the JAX
   probe has no SSD row; saved to ``build/profile_facts.json``), counting
   the RMSNorm and SwiGLU kernels' launches; phase 10's session planned
   with those facts (measured queries > 0, none without, the same shard
   boundaries); a smoke-width two-model session trained with and without
   the facts (identical losses);
14. build — ``ssd_scan.cu`` is part of phase 2's parallel build;
15. SSD kernel vs plain — ``ssd_scan_bshpn`` against the plain chunked
   scan in bf16 (2e-2) and f32 (2e-4, the JAX test's tolerance), rel+abs:
   zamba2's Mamba2 (b 1 and 2, s 256 / 1024 / 4096, h 64, p = n = 64,
   chunk 256, B/C broadcast over heads and contiguous), xlstm-350m's
   mLSTM (b 1, s 1024, h 4, p = n = 512), the four shapes of
   tests/test_kernels.py, and the decay edges log_a = 0 and -30 a step;
   with the kernel's and the plain version's times and the bound (no one
   PyTorch call computes this function: no library yardstick);
16. full-width zamba2-1.2b (38 Mamba2 layers, d 2048, shared block 32/32
   heads of 64 after every 6th layer; bf16 compute, f32 params seeded on
   the card): (a) serve — ``InferenceEngine`` (slot backend), 8 requests
   with prompts of 16..128 tokens (numpy seed 0), 16 tokens each, 8
   lanes: every request gets exactly 16 tokens, decode and prefill tok/s,
   one decode step profiled, and ``backend="paged"`` falls back to slot
   with the warning; (b) spilled eval — an ``EvalJob`` of 2 batches of
   2 x 1024 through the shard queue (2 GB budget) with the flash kernel
   and without: the kernel must launch batches x 6 times; one flash call
   at the shared block's shape held against its plain version; (c) one
   forward of the eval batch composed as the hybrid shard plan's segments
   with every Mamba2 scan through ``ssd_scan_bshpn``: exactly 38
   launches, logits gated against an f32 forward as in phase 5, and the
   kernel's numbers at layer 0's scan inputs; (d) SHARP — two TrainJobs
   (seeds 0 and 1, AdamW, 2 x 1024, 2 steps) on two virtual devices of
   8 GB (3 shards a model), gated as phase 10; (e) a small f32 zamba2
   engine whose lanes at different positions give the tokens each request
   gets alone.

Each kernel's launch count is zeroed just before the run of its own path
(a serve run, the spilled eval, the profiler's ``build_facts`` for
RMSNorm and SwiGLU, the zamba2 kernel forward for the SSD scan) and read
just after; the kernel line reports it with the kernel's numbers at that
path's inputs.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name/power line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Details also go to ``build/chip_smoke.json``.  ``--out-dir DIR`` puts
that file in DIR instead, beside ``chip_smoke.log``, a copy of every line
the run printed (the log of a failed run too).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "bfloat16": 989e12}   # dense bf16 tensor-core rate
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_REL = 2.0     # kernel vs f32 step, relative to plain bf16 vs f32
NH, NKV, HD, BS = 16, 8, 128, 16
GEN, CAPACITY, DRAFT_K = 32, 8, 4


LOG_FILE = None      # set by --out-dir: every printed line is copied there


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    _copy_line(f"chip_smoke FAILED: {msg}")
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)
    _copy_line(msg)


def _copy_line(msg: str) -> None:
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as f:
            f.write(msg + "\n")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


SPIN_CYCLES = 1_000_000     # ~0.5 ms of device time at the H100's clocks


def cuda_ms(fn, iters: int = 20, flush=None) -> float:
    """Median device time of ``fn`` by CUDA events, after one warm-up;
    ``flush`` (a large buffer) is rewritten before each launch so the
    inputs come from HBM, as they do on the serving path, where each
    layer's pages were last touched a whole decode step earlier.  A spin
    kernel ahead of the start event keeps the stream busy while the host
    enqueues ``fn``, so a slow host adds no idle gap to the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def set_bound(res, nbytes, flops, dtype_name):
    """Put the bound (ms, what bounds it) and the bound's share of the
    measured time, ``bound_ms / ms``, into a kernel's result."""
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, flops, dtype_name)
    res["bound_share"] = res["bound_ms"] / res["ms"]


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
    set_bound(res, nbytes, flops, dtype_name)
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
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_attention kernel disagrees with its plain version "
                 f"({dt}, {n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 3b: the verify kernel against its plain version
# ---------------------------------------------------------------------------

def verify_bytes_flops(lengths, kq, tables_width, dtype_bytes, q_bytes, n,
                       window):
    """Least bytes a verify launch must move — q read, out written, each
    lane's K/V rows [lo, lengths + k) once, tables, lengths — and its flops
    (q.k and p.v of every query row over the rows it attends), from these
    inputs."""
    cap = tables_width * BS
    rows = qk_rows = 0
    for le in lengths:
        le = int(le)
        lo = max(0, le - window + 1) if window else 0
        rows += max(0, min(le + kq, cap) - lo)
        for i in range(kq):
            lo_i = max(0, le + i - window + 1) if window else 0
            qk_rows += max(0, min(le + i + 1, cap) - lo_i)
    nbytes = (rows * NKV * HD * 2 * dtype_bytes
              + 2 * n * kq * NH * HD * q_bytes + 4 * n * tables_width + 4 * n)
    return nbytes, 4 * qk_rows * NH * HD


def verify_mask(lengths, kq, S, window, device):
    """(n, 1, k, S) rows each query attends, for the library yardstick."""
    import torch
    pos = torch.arange(S, device=device)[None, None, :]
    lim = lengths.long()[:, None, None] \
        + torch.arange(kq, device=device)[None, :, None]
    mask = pos <= lim
    if window:
        mask &= pos > lim - window
    return mask[:, None]


def measure_verify(q, kp, vp, tables, lengths, window, dtype_name, flush,
                   lanes=None):
    """Verify kernel vs plain on one set of inputs: error (over ``lanes``,
    default all), times, bound; SDPA over K/V gathered and head-expanded
    ahead, with an explicit mask, is the library yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    out = ops.paged_verify(q, kp, vp, tables, lengths, window=window,
                           impl="cuda")
    exp = ref.paged_verify_ref(q, kp, vp, tables, lengths, window=window)
    torch.cuda.synchronize()
    sel = slice(None) if lanes is None else lanes
    diff = (out[sel].float() - exp[sel].float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp[sel].float().abs()).all())
    finite = bool(torch.isfinite(out[sel]).all())
    n, B = tables.shape
    kq = q.shape[1]
    S = B * BS
    g = NH // NKV
    tl = tables.long()
    k = kp[tl].reshape(n, S, NKV, HD).repeat_interleave(g, 2).transpose(1, 2)
    v = vp[tl].reshape(n, S, NKV, HD).repeat_interleave(g, 2).transpose(1, 2)
    mask = verify_mask(lengths, kq, S, window, q.device)
    qh = q.transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)

    lib_err = (lib().transpose(1, 2)[sel].float()
               - exp[sel].float()).abs().max()
    res = {
        "max_abs_err": float(diff.max()),
        "library_max_abs_err": float(lib_err),
        "within_tol": ok and finite,
        "ms": cuda_ms(lambda: ops.paged_verify(
            q, kp, vp, tables, lengths, window=window, impl="cuda"),
            flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_verify_ref(
            q, kp, vp, tables, lengths, window=window), iters=5,
            flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = verify_bytes_flops(
        lengths.tolist(), kq, B, kp.element_size(), q.element_size(), n,
        window)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def verify_sweep_inputs(n, kq, dtype, seed, max_len=4096):
    """Committed lengths 0..max_len-k with block edges (a round's queries
    straddling one), distinct random physical blocks per lane, the last
    lane on the garbage block as the spec backend leaves lanes outside a
    round (its length is not reset)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    top = max_len - kq
    edge = [min(e, top) for e in (0, BS - 1, BS - kq // 2, BS, top, 2 * BS,
                                  1000, top - 1)]
    lengths = rng.integers(0, top + 1, n)
    lengths[:min(n - 1, len(edge))] = edge[:min(n - 1, len(edge))]
    lengths[-1] = 37
    B = -(-max_len // BS)
    need = [-(-(int(x) + kq) // BS) for x in lengths[:-1]]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((n, B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    dev = "cuda"
    q = torch.randn(n, kq, NH, HD, device=dev).to(dtype)
    kp = torch.randn(P, BS, NKV, HD, device=dev).to(dtype)
    vp = torch.randn(P, BS, NKV, HD, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))


def phase_verify_sweep(flush):
    import torch
    cases = [("bfloat16", 8, 1, None), ("bfloat16", 8, 4, None),
             ("bfloat16", 32, 8, None), ("float32", 8, 4, None),
             ("float32", 32, 8, None), ("bfloat16", 32, 4, 512)]
    rows = []
    for i, (dt, n, kq, window) in enumerate(cases):
        torch.manual_seed(100 + i)
        args = verify_sweep_inputs(n, kq, getattr(torch, dt), seed=100 + i)
        r = measure_verify(*args, window, dt, flush)
        r.update(dtype=dt, lanes=n, k=kq, window=window,
                 lengths=args[4].tolist())
        rows.append(r)
        log(f"[kernel] paged_verify {dt} lanes={n} k={kq} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_verify kernel disagrees with its plain version "
                 f"({dt}, {n} lanes, k={kq}, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del args
    return rows


# ---------------------------------------------------------------------------
# phase 3c: the int8 kernel against its plain version
# ---------------------------------------------------------------------------

def quant_bytes_flops(lengths, tables_width, q_bytes, n, window):
    """Least bytes an int8 launch must move — q, out, the attended rows'
    int8 K/V (hd bytes each) and f32 scales (4 bytes each), tables,
    lengths — and its flops (q.k, p.v and the dequantizing products)."""
    rows = sum(int(le) - (max(0, int(le) - window) if window else 0)
               for le in lengths)
    nbytes = (rows * NKV * (HD + 4) * 2
              + 2 * n * NH * HD * q_bytes + 4 * n * tables_width + 4 * n)
    return nbytes, 4 * rows * NH * HD + 2 * rows * NKV * HD


def measure_quant(q, kq8, vq8, ks, vs, tables, lengths, window, flush):
    """int8 kernel vs plain on one set of inputs; the library yardstick is
    SDPA over K/V gathered, dequantized to q's dtype and head-expanded
    ahead, with an explicit mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    args = (q, kq8, vq8, ks, vs, tables, lengths)
    out = ops.paged_attention_quant(*args, window=window, impl="cuda")
    exp = ref.paged_attention_quant_ref(*args, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL["bfloat16"]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    n, B = tables.shape
    S = B * BS
    g = NH // NKV
    tl = tables.long()

    def deq(p8, sc):
        x = ref.dequantize_kv(p8[tl].reshape(n, S, NKV, HD),
                              sc[tl].reshape(n, S, NKV)).to(q.dtype)
        return x.repeat_interleave(g, 2).transpose(1, 2)

    k, v = deq(kq8, ks), deq(vq8, vs)
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
        "ms": cuda_ms(lambda: ops.paged_attention_quant(
            *args, window=window, impl="cuda"), flush=flush),
        "plain_ms": cuda_ms(lambda: ref.paged_attention_quant_ref(
            *args, window=window), iters=5, flush=flush),
        "library_ms": cuda_ms(lib, flush=flush),
    }
    nbytes, flops = quant_bytes_flops(lengths.tolist(), B, q.element_size(),
                                      n, window)
    set_bound(res, nbytes, flops, "bfloat16")
    res["bytes"], res["flops"] = nbytes, flops
    del k, v
    return res


def phase_quant_sweep(flush):
    import torch

    from repro_torch.kernels import ref
    cases = [(8, None), (32, None), (32, 512)]
    rows = []
    for i, (n, window) in enumerate(cases):
        torch.manual_seed(200 + i)
        q, kp, vp, tables, lengths = sweep_inputs(n, torch.float32,
                                                  seed=200 + i)
        kq8, ks = ref.quantize_kv(kp)
        vq8, vs = ref.quantize_kv(vp)
        del kp, vp
        r = measure_quant(q.to(torch.bfloat16), kq8, vq8, ks, vs, tables,
                          lengths, window, flush)
        r.update(dtype="bfloat16 q, int8 pages", lanes=n, window=window,
                 lengths=lengths.tolist())
        rows.append(r)
        log(f"[kernel] paged_attention_quant bf16/int8 lanes={n} "
            f"window={window}: max_abs_err={r['max_abs_err']:.3g} (tol "
            f"{TOL['bfloat16']}) ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} bound_share={r['bound_share']:.3f}")
        if not r["within_tol"]:
            fail(f"paged_attention_quant kernel disagrees with its plain "
                 f"version ({n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
    return rows


# ---------------------------------------------------------------------------
# phase 3d: the fused decode layer against its plain version
# ---------------------------------------------------------------------------

D_MODEL, D_FF = 1024, 3072
MM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # kernels ending in matmuls


def fused_weights(dtype, seed, d=D_MODEL, f=D_FF):
    """wo, the MLP norm scale, Wg, Wu, Wd at qwen3-0.6b's widths, scaled
    as the model's initializer scales them (N(0, 1/fan_in))."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)

    def dense(fan_in, fan_out):
        return (torch.randn(fan_in, fan_out, device="cuda", generator=g)
                / fan_in ** 0.5).to(dtype)
    scale = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0)
    return (dense(NH * HD, d), scale.to(dtype), dense(d, f), dense(d, f),
            dense(f, d))


def fused_bytes_flops(lengths, tables_width, n, window, act_bytes, kv_bytes,
                      d=D_MODEL, f=D_FF):
    """Least bytes of one fused layer: the K/V rows the lanes attend, q, h
    and out, tables and lengths, and the weights read once for all lanes;
    flops: the attention's and 2 n (nh hd d + 3 d f) for the products."""
    nbytes, flops = paged_bytes_flops(lengths, tables_width, kv_bytes,
                                      act_bytes, n, window)
    nbytes -= n * NH * HD * act_bytes            # out is (n, d), not q-sized
    nbytes += (2 * n * d + NH * HD * d + 3 * d * f + d) * act_bytes
    flops += 2 * n * (NH * HD * d + 3 * d * f)
    return nbytes, flops


def measure_fused(h, q, kp, vp, tables, lengths, weights, window,
                  dtype_name, flush):
    """Fused kernel vs plain on one set of inputs: error, times, bound."""
    import torch

    from repro_torch.kernels import ops, ref

    args = (h, q, kp, vp, tables, lengths, *weights)
    out = ops.fused_decode_layer(*args, window=window, impl="cuda")
    exp = ref.fused_decode_layer_ref(*args, window=window)
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = MM_TOL[dtype_name]
    res = {"max_abs_err": float(diff.max()),
           "within_tol": bool((diff <= tol + tol * exp.float().abs()).all()
                              and torch.isfinite(out).all()),
           "ms": cuda_ms(lambda: ops.fused_decode_layer(
               *args, window=window, impl="cuda"), flush=flush),
           "plain_ms": cuda_ms(lambda: ref.fused_decode_layer_ref(
               *args, window=window), iters=5, flush=flush),
           "library_ms": None}     # no one PyTorch call computes the layer
    nbytes, flops = fused_bytes_flops(
        lengths.tolist(), tables.shape[1], h.shape[0], window,
        h.element_size(), kp.element_size())
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    return res


def phase_fused_sweep(flush):
    import torch
    cases = [("bfloat16", 8, None), ("bfloat16", 32, None),
             ("float32", 8, None), ("float32", 32, None),
             ("bfloat16", 32, 512)]
    rows = []
    for i, (dt, n, window) in enumerate(cases):
        torch.manual_seed(100 + i)
        dtype = getattr(torch, dt)
        q, kp, vp, tables, lengths = sweep_inputs(n, dtype, seed=100 + i)
        h = torch.randn(n, D_MODEL, device="cuda").to(dtype)
        r = measure_fused(h, q, kp, vp, tables, lengths,
                          fused_weights(dtype, 100 + i), window, dt, flush)
        r.update(dtype=dt, lanes=n, window=window, lengths=lengths.tolist())
        rows.append(r)
        log(f"[kernel] fused_decode_layer {dt} lanes={n} window={window}: "
            f"max_abs_err={r['max_abs_err']:.3g} (tol {MM_TOL[dt]}) "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f} ({r['bound_by']})")
        if not r["within_tol"]:
            fail(f"fused_decode_layer kernel disagrees with its plain "
                 f"version ({dt}, {n} lanes, window={window}): max abs err "
                 f"{r['max_abs_err']}")
        del q, kp, vp
    return rows


# ---------------------------------------------------------------------------
# phase 3e: RMSNorm and SwiGLU against their plain versions
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the profiler's probe shapes: rms_norm (rows, d), swiglu (rows, d, f)
PROBE_SHAPE = (512, 512, 1024)
# rows at qwen3-0.6b's widths: decode lanes, SwiGLU's route boundaries
# (bf16 32 stream | 33 tiled; f32 8 | 9), a ragged prefill, a long one
SWEEP_ROWS = (1, 8, 32, 33, 127, 2048)
RAGGED_RMS = (512, 1022)      # d % 8 != 0: RMSNorm's element path


def rms_swiglu_inputs(rows, d, f, dtype_name):
    """x ~ N(0, 1), the norm scale ~ 1 + N(0, 0.01), SwiGLU weights ~
    N(0, 1/fan_in), on the card, from a generator seeded by the shape."""
    import torch
    dtype = getattr(torch, dtype_name)
    g = torch.Generator("cuda").manual_seed(rows + d + f)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    w = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0).to(dtype)
    mats = [(torch.randn(a, b, device="cuda", generator=g) / a ** 0.5)
            .to(dtype) for a, b in ((d, f), (d, f), (f, d))]
    return x, w, mats


def harness_floor_ms(flush) -> float:
    """``cuda_ms`` of an empty kernel (``torch.cuda._sleep(0)``), with the
    flush and the spin: the least time the timer can report."""
    import torch
    return cuda_ms(lambda: torch.cuda._sleep(0), flush=flush)


def swiglu_bound(rows, d, f, dtype_name, item):
    """SwiGLU's least bytes (x, out, the three weights) and the time of
    the products its route issues: the tiled f32 route splits each
    operand into two bf16 parts and issues three tensor-core products for
    each of the reference's (``swiglu.bound_flops``)."""
    import torch

    from repro_torch.kernels.swiglu import bound_flops
    nbytes = (2 * rows * d + 3 * d * f) * item
    flops, unit = bound_flops(rows, d, f, getattr(torch, dtype_name))
    peak = PEAK_FLOPS["bfloat16" if unit == "tensor" else "float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return nbytes, flops, max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def _gate(name, r, tol, shape):
    if not r["within_tol"]:
        fail(f"{name} kernel disagrees with its plain version ({shape}): "
             f"max abs err {r['max_abs_err']}")


def _compare(got, exp, tol):
    import torch
    torch.cuda.synchronize()
    diff = (got.float() - exp.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "within_tol": bool((diff <= tol + tol * exp.float().abs()).all()
                               and torch.isfinite(got).all())}


def measure_rms(rows, d, dtype_name, flush):
    """RMSNorm over (rows, d), kernel vs plain: error, times, bound, and
    ``F.rms_norm`` (one PyTorch call) as the library yardstick."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    x, w, _ = rms_swiglu_inputs(rows, d, 8, dtype_name)
    tol = RMS_TOL[dtype_name]
    r = _compare(ops.rms_norm(x, w, impl="cuda"), ref.rms_norm_ref(x, w),
                 tol)
    r.update(ms=cuda_ms(lambda: ops.rms_norm(x, w, impl="cuda"),
                        flush=flush),
             plain_ms=cuda_ms(lambda: ref.rms_norm_ref(x, w), iters=5,
                              flush=flush),
             library_ms=cuda_ms(lambda: F.rms_norm(x, (d,), w, 1e-6),
                                flush=flush),
             rows=rows, d=d, f=None, dtype=dtype_name)
    set_bound(r, (2 * rows * d + d) * x.element_size(), 4 * rows * d,
              dtype_name)
    log(f"[kernel] rms_norm {dtype_name} rows={rows} d={d}: max_abs_err="
        f"{r['max_abs_err']:.3g} (tol {tol}) ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} bound_ms="
        f"{r['bound_ms']:.4f} bound_share={r['bound_share']:.3f} "
        f"({r['bound_by']})")
    _gate("rms_norm", r, tol, f"{dtype_name}, rows {rows}, d {d}")
    return r


def measure_swiglu(rows, d, f, dtype_name, flush):
    """SwiGLU over (rows, d, f), kernel vs plain: error, times, the bound
    of its route's products; no one PyTorch call computes it (library
    null).  Beside the plain time, bf16 rows also time the cuBLAS
    composition (F.silu(x @ Wg) * (x @ Wu)) @ Wd in bf16 — not the same
    function (it rounds the hidden to bf16), a measure of how far the
    products are from the card's library."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.swiglu import swiglu_route
    x, _, mats = rms_swiglu_inputs(rows, d, f, dtype_name)
    wg, wu, wd = mats
    tol = MM_TOL[dtype_name]
    r = _compare(ops.swiglu(x, *mats, impl="cuda"),
                 ref.swiglu_ref(x, *mats), tol)
    r.update(ms=cuda_ms(lambda: ops.swiglu(x, *mats, impl="cuda"),
                        flush=flush),
             plain_ms=cuda_ms(lambda: ref.swiglu_ref(x, *mats), iters=5,
                              flush=flush),
             library_ms=None,
             cublas_bf16_ms=(cuda_ms(lambda: (F.silu(x @ wg) * (x @ wu))
                                     @ wd, flush=flush)
                             if dtype_name == "bfloat16" else None),
             route=swiglu_route(rows, x.dtype), rows=rows, d=d, f=f,
             dtype=dtype_name)
    r["bytes"], r["flops"], r["bound_ms"], r["bound_by"] = swiglu_bound(
        rows, d, f, dtype_name, x.element_size())
    r["bound_share"] = r["bound_ms"] / r["ms"]
    cub = ("" if r["cublas_bf16_ms"] is None else
           f" cublas_bf16_ms={r['cublas_bf16_ms']:.4f} (not the same "
           f"function: the hidden rounded to bf16)")
    log(f"[kernel] swiglu {dtype_name} rows={rows} d={d} f={f} route="
        f"{r['route']}: max_abs_err={r['max_abs_err']:.3g} (tol {tol}) "
        f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}{cub} bound_ms="
        f"{r['bound_ms']:.4f} bound_share={r['bound_share']:.3f} "
        f"({r['bound_by']})")
    _gate("swiglu", r, tol, f"{dtype_name}, rows {rows}, d {d}, f {f}")
    return r


def phase_rms_swiglu_sweep(flush):
    """The harness floor, then RMSNorm and SwiGLU at SWEEP_ROWS of
    qwen3-0.6b's widths, RMSNorm at RAGGED_RMS, and both at the profiler's
    probe shapes, in bf16 and f32.  Returns (report, the probe-shape f32
    rows — the shapes the profiler's path gives the kernels)."""
    floor = harness_floor_ms(flush)
    log(f"[kernel] harness floor: cuda_ms of an empty kernel "
        f"(torch.cuda._sleep(0), flush and spin) = {floor:.4f} ms")
    rows, probe = [], {}
    for dt in ("bfloat16", "float32"):
        for m in SWEEP_ROWS:
            rows.append({"rms_norm": measure_rms(m, D_MODEL, dt, flush),
                         "swiglu": measure_swiglu(m, D_MODEL, D_FF, dt,
                                                  flush)})
        rows.append({"rms_norm": measure_rms(*RAGGED_RMS, dt, flush)})
        r = {"rms_norm": measure_rms(*PROBE_SHAPE[:2], dt, flush),
             "swiglu": measure_swiglu(*PROBE_SHAPE, dt, flush)}
        rows.append(r)
        if dt == "float32":
            probe = r
    return {"harness_floor_ms": floor, "rows": rows}, probe


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


def paged_snapshot(eng):
    """The paged backend's state between two decode steps: pages (cloned),
    block tables, lengths and the lanes' next input tokens."""
    be = eng.backend
    return {"pages": {k: v.clone() for k, v in be.pool.pages.items()},
            "tables": be._tables.copy(), "lengths": be._lengths.copy(),
            "tokens": eng._tokens[:, 0, :].copy()}


def drive_serve(cfg, eng, prompts, counter, label, snap_step=None):
    """Submit every prompt, zero the kernel's launch count, drive the
    engine to the end (snapshotting the paged state at decode step
    ``snap_step``), check every request got exactly GEN tokens, and
    return (snapshot, result) with the count read just after the run."""
    import torch
    for i, p in enumerate(prompts):
        eng.submit(p, GEN, request_id=f"r{i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0                 # count this path's run only
    t0 = time.perf_counter()
    snap = None
    while eng.step():
        if snap_step is not None and eng.decode_steps == snap_step \
                and snap is None:
            snap = paged_snapshot(eng)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"{label}: served {len(done)} of {len(prompts)} requests")
    for rid, r in done.items():
        if len(r.generated) != GEN or r.status.value != "finished":
            fail(f"{label} {rid}: {len(r.generated)} tokens, status "
                 f"{r.status}")
    res = {
        "requests": len(done), "gen": GEN, "wall_s": wall,
        "prompt_lens": [len(p) for p in prompts],
        "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **{k: summary.get(k) for k in (
            "backend", "decode_steps", "prefill_calls", "prefill_tok_per_s",
            "decode_tok_per_s", "kv_page_peak_bytes", "kv_peak_bytes",
            "kv_reserved_bytes", "shared_block_hits", "cow_copies",
            "peak_concurrency", "paged_impl", "n_blocks", "block_bytes",
            "kv_dtype")},
        "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
        "tokens": {rid: r.generated for rid, r in done.items()},
    }
    return snap, res, summary


def phase_serve(cfg, params, prompts):
    import torch

    from repro_torch.kernels.paged_attention import paged_attention_lanes
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    # warm-up engine (cuBLAS handles, kernel library load): not measured
    warm = InferenceEngine(cfg, params, capacity=2, max_seq=128,
                           backend="paged", block_size=BS, device="cuda")
    for p in prompts[2:4]:
        warm.submit(p[:64], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts,
                                     paged_attention_lanes, "serve",
                                     snap_step=8)
    launches = res["launches"]
    expect = summary["decode_steps"] * cfg.n_layers
    if launches != expect:
        fail(f"paged_attention launched {launches} times on the serve "
             f"path; expected decode_steps x layers = {expect}")
    if summary["shared_block_hits"] < 16 or summary["cow_copies"] < 1:
        fail(f"prefix sharing did not run: {summary['shared_block_hits']} "
             f"shared blocks, {summary['cow_copies']} copy-on-write copies")
    log(f"[serve] qwen3-0.6b full width: {res['requests']} requests x {GEN} "
        f"tokens, prefill {res['prefill_tok_per_s']} tok/s, decode "
        f"{res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, kernel launches {launches}, "
        f"kv_page_peak_bytes {res['kv_page_peak_bytes']}, "
        f"max_memory_allocated {res['max_memory_allocated']}, "
        f"shared_block_hits {res['shared_block_hits']}, cow_copies "
        f"{res['cow_copies']}")
    return eng, snap, res


def phase_spec_serve(cfg, params, prompts, draft_cfg, draft_params, label,
                     snap_round=3):
    """Full-width speculative serve over the paged inner: the engine's
    verify forward is wrapped to snapshot one round's inputs (pages,
    tables, lengths, tokens) for the both-ways check and the kernel's
    numbers at the serve inputs.  Checks: every request gets exactly GEN
    tokens, the verify kernel runs once per layer per round, and the pool
    and the ledger are empty afterwards."""
    import torch

    from repro_torch.kernels.paged_verify import paged_verify_lanes
    from repro_torch.serving.engine import InferenceEngine

    from repro_torch.models import api
    from repro_torch.serving.paging import blocks_for_rows

    max_seq = max(len(p) for p in prompts) + GEN
    # the draft state's bytes are charged to the paged inner's ledger, as
    # in the JAX package: budget the worst-case target pages plus every
    # lane's draft state, so all CAPACITY lanes can run at once
    budget = (CAPACITY * blocks_for_rows(max_seq + DRAFT_K, BS)
              * api.kv_block_bytes(cfg, BS)
              + CAPACITY * api.decode_state_bytes(draft_cfg, 1,
                                                   max_seq + DRAFT_K))
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="spec", spec_inner="paged",
                          draft_cfg=draft_cfg, draft_params=draft_params,
                          draft_k=DRAFT_K, block_size=BS,
                          kv_budget_bytes=budget, device="cuda")
    be = eng.backend
    verify = be._verify
    snap = {}

    def snooping_verify(p, pages, tables, lengths, tokens):
        if be.spec_rounds == snap_round and not snap:
            snap.update(pages={k: v.clone() for k, v in pages.items()},
                        tables=tables.clone(), lengths=lengths.clone(),
                        tokens=tokens.clone())
        return verify(p, pages, tables, lengths, tokens)

    # host wall time of every round and of its two forwards, during the
    # run itself (each already ends in a device sync: the draft chain and
    # the round copy their tokens to the host; verify gets its own sync,
    # which the round's copy of the greedy tokens would do anyway)
    times = {"round": [], "draft_chain": [], "verify": []}

    def timed(key, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    be._verify = timed("verify", snooping_verify, sync=True)
    be._draft_chain = timed("draft_chain", be._draft_chain)
    be._spec_round = timed("round", be._spec_round)
    _, res, summary = drive_serve(cfg, eng, prompts, paged_verify_lanes,
                                  label)
    res["round_host_ms"] = {k: statistics.median(v) if v else None
                            for k, v in times.items()}
    expect = summary["spec_rounds"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"{label}: paged_verify launched {res['launches']} times; "
             f"expected spec_rounds x layers = {expect}")
    if eng.pool.n_used != 0 or eng.ledger.kv_reserved_bytes != 0:
        fail(f"{label}: {eng.pool.n_used} blocks still allocated and "
             f"{eng.ledger.kv_reserved_bytes} B still reserved after the "
             "run")
    if not snap:
        fail(f"{label}: the run ended before verify round {snap_round}")
    if summary["peak_concurrency"] != CAPACITY:
        fail(f"{label}: peak concurrency {summary['peak_concurrency']}, "
             f"expected all {CAPACITY} lanes busy")
    for k in ("spec_rounds", "target_steps", "spec_tokens",
              "accepted_tokens_per_target_step", "draft_accept_rate",
              "verify_impl", "draft_slot_bytes"):
        res[k] = summary[k]
    rt = res["round_host_ms"]
    log(f"[spec] {label}: per round, median of {len(times['round'])}: "
        f"round {rt['round']:.2f} ms = draft chain {rt['draft_chain']:.2f} ms "
        f"+ verify {rt['verify']:.2f} ms + the rest (host wall time)")
    # where a round's time goes: its draft chain (run on the draft state
    # the serve left behind: same shapes, whatever the lanes' indices) and
    # its verify forward on the snapshot round's inputs
    t_last = snap["tokens"][:, 0].cpu().numpy()
    res["profile_draft_chain"] = profiled(
        f"{label}: one draft chain ({DRAFT_K} draft steps, "
        f"{CAPACITY} lanes)", lambda: be._draft_chain(t_last))
    pages = {k: v.clone() for k, v in snap["pages"].items()}
    res["profile_verify"] = profiled(
        f"{label}: one verify forward ({CAPACITY} lanes x {DRAFT_K})",
        lambda: api.paged_verify_step(
            cfg, eng.params, pages, snap["tables"], snap["lengths"],
            snap["tokens"].long(), impl=be.verify_impl))
    del pages
    log(f"[spec] {label}: {res['requests']} requests x {GEN} tokens, "
        f"draft {draft_cfg.name} ({draft_cfg.n_layers} layers), k "
        f"{DRAFT_K}: spec_rounds {res['spec_rounds']}, target_steps "
        f"{res['target_steps']}, spec_tokens {res['spec_tokens']}, "
        f"accepted_tokens_per_target_step "
        f"{res['accepted_tokens_per_target_step']}, draft_accept_rate "
        f"{res['draft_accept_rate']}, decode {res['decode_tok_per_s']} "
        f"tok/s, prefill {res['prefill_tok_per_s']} tok/s, verify kernel "
        f"launches {res['launches']}, max_memory_allocated "
        f"{res['max_memory_allocated']}")
    return snap, res


def phase_int8_serve(cfg, params, prompts, fp_res):
    """Full-width serve from an int8 paged pool: the dequantizing kernel
    runs once per layer per decode step; a block costs rows * (hd + 4)."""
    from repro_torch.kernels.paged_attention import \
        paged_attention_quant_lanes
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", kv_dtype="int8", block_size=BS,
                          device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts,
                                     paged_attention_quant_lanes, "int8",
                                     snap_step=8)
    expect = summary["decode_steps"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"paged_attention_quant launched {res['launches']} times on "
             f"the int8 serve path; expected decode_steps x layers = "
             f"{expect}")
    want = 2 * cfg.n_layers * BS * NKV * (HD + 4)
    if summary["block_bytes"] != want:
        fail(f"int8 block_bytes {summary['block_bytes']}, expected {want}")
    res["block_ratio_vs_fp"] = summary["block_bytes"] / fp_res["block_bytes"]
    res["kv_page_peak_ratio_vs_fp"] = (res["kv_page_peak_bytes"]
                                       / fp_res["kv_page_peak_bytes"])
    same = sum(res["tokens"][r] == fp_res["tokens"][r] for r in res["tokens"])
    res["requests_token_identical_to_fp"] = same
    log(f"[int8] paged int8 KV: {res['requests']} requests x {GEN} tokens, "
        f"block_bytes {summary['block_bytes']} "
        f"({res['block_ratio_vs_fp']:.4f} x fp), kv_page_peak_bytes "
        f"{res['kv_page_peak_bytes']} vs fp {fp_res['kv_page_peak_bytes']}, "
        f"decode {res['decode_tok_per_s']} tok/s, decode_steps "
        f"{res['decode_steps']}, kernel launches {res['launches']}, "
        f"max_memory_allocated {res['max_memory_allocated']}, requests "
        f"token-identical to the bf16 pool {same} of {res['requests']}")
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
    return logit_gate("one decode step", logits)


def profiled(label, fn):
    """One call of ``fn`` under torch.profiler, after one warm call: its
    wall time, the device time summed over CUDA kernels, the device's busy
    share of the wall time, the kernel launches and the top kernels.  The
    profiler inflates the host side, so the busy share is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

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
    log(f"[profile] {label} (profiler on): wall {res['wall_ms']:.2f} ms, "
        f"device {res['device_ms']} ms, busy share "
        f"{res['device_busy_share']}, {res['kernel_launches']} kernel "
        "launches")
    for t in res["top"]:
        log(f"[profile]   {t['ms']:.3f} ms x{t['count']} {t['name']}")
    return res


def phase_profile(cfg, eng, snap, label="one decode step (8 lanes)",
                  impl=None):
    """One decode step of the snapshot state under the profiler."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    args = (torch.from_numpy(snap["tables"]).to(dev),
            torch.from_numpy(snap["lengths"]).to(dev),
            torch.from_numpy(snap["tokens"]).long().to(dev))
    pages = {k: v.clone() for k, v in snap["pages"].items()}
    res = profiled(label, lambda: api.paged_decode_step(
        cfg, eng.params, pages, *args, impl=impl))
    del pages
    return res


def logit_gate(label, logits):
    """The both-ways gate over {"cuda", "ref", "f32"} logits: the kernel's
    logits may be at most LOGIT_REL times as far (max abs) from the f32
    run as the plain bf16 path's are."""
    import torch
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
           "positions": int(a.numel() // a.shape[-1])}
    res["within_tol"] = (err_k <= LOGIT_REL * err_p
                         and bool(torch.isfinite(a).all()))
    log(f"[both-ways] {label}: kernel vs plain max abs logit diff "
        f"{res['max_abs_logit_diff_kernel_vs_plain']:.4g}; vs f32 kernel "
        f"{err_k:.4g}, plain {err_p:.4g} (gate: kernel <= {LOGIT_REL} x "
        f"plain; max |logit| {res['max_abs_logit']:.3g}); argmax flips "
        f"kernel/plain {res['argmax_flips_kernel_vs_plain']}, kernel/f32 "
        f"{res['argmax_flips_kernel_vs_f32']}, plain/f32 "
        f"{res['argmax_flips_plain_vs_f32']} of {res['positions']}")
    if not res["within_tol"]:
        fail(f"{label}: logits through the kernel are farther from the f32 "
             f"run ({err_k}) than {LOGIT_REL} x the plain bf16 path's "
             f"({err_p})")
    return res


def phase_verify_both_ways(cfg, snap, params, bf16_params):
    """One verify round of the spec run's snapshot through the kernel and
    through the plain path (both bf16), each against the same round in
    f32 compute; only the lanes in the round are compared (the others
    write into the garbage block in an unspecified order)."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    lanes = (snap["tables"] != 0).any(dim=1)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, bf16_params, "cuda"),
            "ref": (cfg, bf16_params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_verify_step(
                c, p, pages, snap["tables"], snap["lengths"],
                snap["tokens"].long(), impl=impl)[lanes].float()
            del pages
    torch.cuda.synchronize()
    res = logit_gate(f"one verify round ({int(lanes.sum())} lanes x "
                     f"{DRAFT_K} positions)", logits)
    res["lanes_in_round"] = int(lanes.sum())
    return res


def phase_int8_both_ways(cfg, snap, params, bf16_params):
    """One decode step of the int8 run's snapshot through the int8 kernel
    and through the plain int8 path (both bf16), each against the same
    step in f32 compute over the same int8 pages."""
    import torch

    from repro_torch.models import api

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"cuda": (cfg, bf16_params, "cuda"),
            "ref": (cfg, bf16_params, "ref"),
            "f32": (cfg32, api.prepare_params(cfg32, params, dev), "ref")}
    logits = {}
    with torch.no_grad():
        for key, (c, p, impl) in runs.items():
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            logits[key] = api.paged_decode_step(
                c, p, pages, tables, lengths, tokens, impl=impl).float()
            del pages
    torch.cuda.synchronize()
    return logit_gate("one int8 decode step", logits)


def step_turns(cfg, params, snap, tables, lengths, tokens, impls, rounds=3):
    """Host wall time of one decode step of the snapshot state per impl
    (each from fresh page copies, ended by a sync), taken in turns — A, B,
    B, A, ``rounds`` times — so the two share the host's drift."""
    import torch

    from repro_torch.models import api

    a, b = impls
    times = {a: [], b: []}
    with torch.no_grad():
        for key in [a, b, b, a] * rounds:
            pages = {k: v.clone() for k, v in snap["pages"].items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.paged_decode_step(cfg, params, pages, tables, lengths,
                                  tokens, impl=impls[key])
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            del pages
    return {k: {"median": statistics.median(v), "all": v}
            for k, v in times.items()}


def phase_fused_serve(cfg, params, prompts, fp_res, fp_profile, flush):
    """The phase-4 requests through ``paged_impl="fused"``: the fused
    layer's kernel chain runs once per layer per decode step; one decode
    step of the snapshot state both ways — the fused kernel and the fused
    plain version (bf16), each gated against the same step in f32 as
    phase 5 gates the attention kernel (at most LOGIT_REL x the plain
    unfused bf16 step's distance); one fused step profiled beside phase
    5's; and the kernel's numbers at layer 0's serve inputs."""
    import torch

    from repro_torch.kernels.fused_decode import fused_decode_layer
    from repro_torch.models import api
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine

    max_seq = max(len(p) for p in prompts) + GEN
    eng = InferenceEngine(cfg, params, capacity=CAPACITY, max_seq=max_seq,
                          backend="paged", paged_impl="fused",
                          block_size=BS, device="cuda")
    snap, res, summary = drive_serve(cfg, eng, prompts, fused_decode_layer,
                                     "fused", snap_step=8)
    expect = summary["decode_steps"] * cfg.n_layers
    if res["launches"] != expect:
        fail(f"fused_decode_layer launched {res['launches']} times on the "
             f"fused serve path; expected decode_steps x layers = {expect}")
    same = sum(res["tokens"][r] == fp_res["tokens"][r] for r in res["tokens"])
    res["requests_token_identical_to_paged"] = same
    log(f"[fused] paged_impl=fused: {res['requests']} requests x {GEN} "
        f"tokens, decode {res['decode_tok_per_s']} tok/s (paged "
        f"{fp_res['decode_tok_per_s']}), prefill {res['prefill_tok_per_s']} "
        f"tok/s, decode_steps {res['decode_steps']}, kernel launches "
        f"{res['launches']}, max_memory_allocated "
        f"{res['max_memory_allocated']}, requests token-identical to the "
        f"unfused paged run {same} of {res['requests']} (bf16: not gated)")

    dev = "cuda"
    tables = torch.from_numpy(snap["tables"]).to(dev)
    lengths = torch.from_numpy(snap["lengths"]).to(dev)
    tokens = torch.from_numpy(snap["tokens"]).long().to(dev)
    cfg32 = cfg.replace(dtype="float32")
    runs = {"fused": (cfg, eng.params, "fused"),
            "fused_ref": (cfg, eng.params, "fused_ref"),
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
    del runs
    res["both_ways_kernel"] = logit_gate(
        "one fused decode step, fused kernel", dict(
            cuda=logits["fused"], ref=logits["ref"], f32=logits["f32"]))
    res["both_ways_plain"] = logit_gate(
        "one fused decode step, fused plain version", dict(
            cuda=logits["fused_ref"], ref=logits["ref"], f32=logits["f32"]))
    res["max_abs_logit_diff_kernel_vs_fused_plain"] = float(
        (logits["fused"] - logits["fused_ref"]).abs().max())
    log(f"[both-ways] fused kernel vs fused plain version: max abs logit "
        f"diff {res['max_abs_logit_diff_kernel_vs_fused_plain']:.4g}")
    del logits
    res["step_host_ms"] = step_turns(cfg, eng.params, snap, tables, lengths,
                                     tokens, {"unfused": "cuda",
                                              "fused": "fused"})
    st = res["step_host_ms"]
    log(f"[fused] one decode step, host wall to a sync, median of "
        f"{len(st['fused']['all'])} in turns (unfused, fused, fused, "
        f"unfused): unfused {st['unfused']['median']:.2f} ms, fused "
        f"{st['fused']['median']:.2f} ms")
    res["profile"] = phase_profile(cfg, eng, snap,
                                   "one fused decode step (8 lanes)",
                                   impl="fused")
    pr = res["profile"]
    log(f"[fused] one decode step: {pr['kernel_launches']} launches, busy "
        f"share {pr['device_busy_share']} (unfused paged step: "
        f"{fp_profile['kernel_launches']} launches, busy share "
        f"{fp_profile['device_busy_share']})")

    # the kernel at the serve path's inputs: layer 0's pages and weights
    lp = transformer.layer_slices(eng.params["layers"], 1)[0]
    bf = torch.bfloat16
    weights = (lp["attn"]["wo"].to(bf).contiguous(),
               lp["mlp_norm"]["scale"].to(bf).contiguous(),
               lp["mlp"]["w_gate"].to(bf).contiguous(),
               lp["mlp"]["w_up"].to(bf).contiguous(),
               lp["mlp"]["w_down"].to(bf).contiguous())
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    h = torch.randn(CAPACITY, D_MODEL, device="cuda").to(bf)
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(bf)
    m = measure_fused(h, q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                      tables, le, weights, None, "bfloat16", flush)
    m["lengths"] = le.tolist()
    log(f"[kernel] fused_decode_layer at the fused serve path's inputs "
        f"(lengths {m['lengths']}): ms={m['ms']:.4f} "
        f"plain_ms={m['plain_ms']:.4f} bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("fused_decode_layer kernel disagrees with its plain version at "
             "the fused serve path's inputs")
    res["main_path_kernel"] = m
    del eng, snap
    return res


def phase_small_f32():
    """Small float32 engines: paged decode through the kernel and through
    the plain attention give identical tokens; speculative decode over the
    paged inner (verify through the kernel, a random draft) gives plain
    paged greedy's tokens; int8 pages through the int8 kernel and through
    the plain int8 path give identical tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(3),
                             "cuda")
    draft = api.init_params(cfg, torch.Generator("cuda").manual_seed(7),
                            "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 32, 9)]

    def serve(**kw):
        eng = InferenceEngine(cfg, params, capacity=2, max_seq=64,
                              block_size=8, device="cuda", **kw)
        for i, p in enumerate(prompts):
            eng.submit(p, 12, request_id=f"s{i}")
        eng.run()
        return eng, {r.request_id: r.generated for r in eng.completed}

    from repro_torch.kernels.fused_decode import fused_decode_layer
    out = {impl: serve(backend="paged", paged_impl=impl)[1]
           for impl in ("cuda", "ref")}
    fused_before = fused_decode_layer.launches
    out["fused"] = serve(backend="paged", paged_impl="fused")[1]
    fused_launches = fused_decode_layer.launches - fused_before
    spec_eng, out["spec"] = serve(backend="spec", spec_inner="paged",
                                  draft_cfg=cfg, draft_params=draft,
                                  draft_k=3)
    for impl in ("cuda", "ref"):
        out[f"int8_{impl}"] = serve(backend="paged", kv_dtype="int8",
                                    paged_impl=impl)[1]
    res = {"identical_tokens": out["cuda"] == out["ref"]
           and len(out["cuda"]) == len(prompts),
           "spec_identical_to_plain": out["spec"] == out["ref"],
           "spec_verify_impl": spec_eng.backend.verify_impl,
           "spec_draft_accept_rate":
               spec_eng.summary()["draft_accept_rate"],
           "int8_identical_kernel_vs_plain":
               out["int8_cuda"] == out["int8_ref"]
               and len(out["int8_cuda"]) == len(prompts),
           "fused_identical_to_plain": out["fused"] == out["ref"],
           "fused_launches": fused_launches}
    log(f"[small-f32] smoke engines, tokens identical: paged kernel vs "
        f"plain {res['identical_tokens']}; spec (verify "
        f"{res['spec_verify_impl']}, draft accept rate "
        f"{res['spec_draft_accept_rate']}) vs plain paged "
        f"{res['spec_identical_to_plain']}; int8 kernel vs plain int8 "
        f"{res['int8_identical_kernel_vs_plain']}; fused kernel "
        f"({fused_launches} launches) vs plain unfused paged "
        f"{res['fused_identical_to_plain']}")
    if not res["identical_tokens"]:
        fail("small f32 engine: kernel and plain attention gave different "
             "tokens")
    if not res["spec_identical_to_plain"] or res["spec_verify_impl"] != "cuda":
        fail("small f32 engine: speculative decode through the verify "
             "kernel did not give plain greedy's tokens")
    if not res["int8_identical_kernel_vs_plain"]:
        fail("small f32 engine: int8 pages through the kernel and through "
             "the plain version gave different tokens")
    if not res["fused_identical_to_plain"] or fused_launches == 0:
        fail("small f32 engine: the fused decode layer's kernel did not "
             "give the plain unfused paged engine's tokens")
    return res


# ---------------------------------------------------------------------------
# phase 9: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask lets through: key j < sk visible to
    query i iff j <= i (causal) and j > i - window (window)."""
    import numpy as np
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_mask(sq, sk, causal, window, device):
    import torch
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def measure_flash(q, k, v, causal, window, dtype_name, flush):
    """Flash kernel vs plain on one set of layer-layout inputs (q (b, sq,
    nh, hd), k/v (b, sk, nkv, hd)): error, times, bound.  The library
    yardstick is SDPA over head-expanded K/V made ahead, with the same
    mask (``is_causal`` where that mask is the plain causal one)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    b, sq, nh, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        exp = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="ref")
    torch.cuda.synchronize()
    diff = (out.float() - exp.float()).abs()
    tol = TOL[dtype_name]
    ok = bool((diff <= tol + tol * exp.float().abs()).all())
    finite = bool(torch.isfinite(out).all())
    g = nh // nkv
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(g, 2).transpose(1, 2)
    vh = v.repeat_interleave(g, 2).transpose(1, 2)
    plain_causal = causal and not window and sq == sk
    mask = None if plain_causal or (not causal and not window) \
        else flash_mask(sq, sk, causal, window, q.device)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              is_causal=plain_causal)

    with torch.no_grad():
        lib_err = (lib().transpose(1, 2).float() - exp.float()).abs().max()
        res = {
            "max_abs_err": float(diff.max()),
            "library_max_abs_err": float(lib_err),
            "within_tol": ok and finite,
            "ms": cuda_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window, impl="cuda"),
                flush=flush),
            "plain_ms": cuda_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window, impl="ref"),
                iters=5, flush=flush),
            "library_ms": cuda_ms(lib, flush=flush),
        }
    item = q.element_size()
    nbytes = (2 * b * sq * nh * hd + 2 * b * sk * nkv * hd) * item
    flops = 4 * hd * nh * b * visible_pairs(sq, sk, causal, window)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del kh, vh, mask
    return res


def phase_flash_sweep(flush):
    import torch
    cases = [  # b, sq, sk, causal, window, dtype
        (2, 64, 64, True, None, "bfloat16"),
        (2, 127, 127, True, None, "bfloat16"),
        (2, 128, 128, True, None, "bfloat16"),
        (2, 129, 129, True, None, "bfloat16"),
        (2, 1000, 1000, True, None, "bfloat16"),
        (2, 2048, 2048, True, None, "bfloat16"),
        (2, 4096, 4096, True, None, "bfloat16"),
        (1, 129, 129, True, None, "float32"),
        (1, 1000, 1000, True, None, "float32"),
        (1, 2048, 2048, True, None, "float32"),
        (1, 1000, 1000, False, None, "bfloat16"),
        (1, 2048, 2048, False, None, "float32"),
        (2, 2048, 2048, True, 512, "bfloat16"),
        (1, 4096, 4096, True, 512, "float32"),
        (1, 1000, 1000, False, 512, "bfloat16"),
        (1, 512, 2048, True, None, "bfloat16"),
        (1, 300, 1000, True, None, "float32"),
    ]
    rows = []
    for i, (b, sq, sk, causal, window, dt) in enumerate(cases):
        gen = torch.Generator("cuda").manual_seed(100 + i)
        dtype = getattr(torch, dt)
        q = torch.randn(b, sq, NH, HD, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, sk, NKV, HD, device="cuda",
                        generator=gen).to(dtype)
        v = torch.randn(b, sk, NKV, HD, device="cuda",
                        generator=gen).to(dtype)
        r = measure_flash(q, k, v, causal, window, dt, flush)
        r.update(dtype=dt, b=b, sq=sq, sk=sk, causal=causal, window=window)
        rows.append(r)
        log(f"[kernel] flash_attention {dt} b={b} sq={sq} sk={sk} "
            f"causal={causal} window={window}: max_abs_err="
            f"{r['max_abs_err']:.3g} (tol {TOL[dt]}) ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
            f" bound_ms={r['bound_ms']:.4f}"
            f" bound_share={r['bound_share']:.3f} ({r['bound_by']})")
        if not r["within_tol"]:
            fail(f"flash_attention kernel disagrees with its plain version "
                 f"({dt}, b={b}, sq={sq}, sk={sk}, causal={causal}, "
                 f"window={window}): max abs err {r['max_abs_err']}")
        del q, k, v
    return rows


# ---------------------------------------------------------------------------
# phase 10-12: SHARP training and spilled eval of full-width qwen3-0.6b
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3
TRAIN_BUDGET = 5 * 10**9      # per virtual device
EVAL_BUDGET = 2 * 10**9       # forward-only: cut the model into 2 shards
EVAL_BATCHES = 2
SHARP_TOL = 3e-4              # tests/test_orchestrator.py's bound
TRAIN_LRS = (1e-4, 3e-4)


def train_loader(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ,
                                      vocab_size=cfg.vocab_size, seed=seed))


def phase_sharp_train(cfg, budget=TRAIN_BUDGET, steps=TRAIN_STEPS):
    """Two full-width TrainJobs of ``cfg`` (seeds 0 and 1, lr 1e-4 and
    3e-4, AdamW) through the port's Session on two virtual devices of
    ``budget`` bytes each (qwen3-0.6b: 5 GB, 3 steps), ``steps`` steps of
    batch 2 x 1024 tokens; then each model's plain full-model training on
    the card.  Gates: >= 3 shards a model, units =
    models x steps x 2 x shards, the ledger never over its budget, SHARP
    losses equal to the sequential reference at 3e-4."""
    import numpy as np
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.core.orchestrator import (ModelTask,
                                               train_sequential_reference)

    lrs = TRAIN_LRS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(HydraConfig(n_devices=2,
                                  device_budget_bytes=budget),
                      device="cuda", profile=None)
    for seed, lr in enumerate(lrs):
        session.submit(TrainJob(cfg, train_loader(cfg, seed), lr=lr,
                                optimizer="adamw", epochs=1,
                                steps_per_epoch=steps, seed=seed,
                                batch=TRAIN_BATCH, seq=TRAIN_SEQ))
    plan = session.plan()
    setup_s = time.perf_counter() - t0
    peak_used = {}
    for dm in session.devices:       # the ledger's high-water mark
        def charge(nbytes, *, into_buffer, dm=dm, orig=dm.charge_promotion):
            orig(nbytes, into_buffer=into_buffer)
            peak_used[dm.device_id] = max(peak_used.get(dm.device_id, 0),
                                          dm.used_bytes())
        dm.charge_promotion = charge
    t0 = time.perf_counter()
    report = session.run(plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = report.train
    execs = session.train_execs
    shards = [len(m.partition.shards) for m in execs]
    promoted = sum(s.promoted_bytes for s in train.transfer.values())
    res = {"shards": shards,
           "shard_layers": [[(s.seg_lo, s.seg_hi) for s in m.partition]
                            for m in execs],
           "losses": {int(k): v for k, v in train.losses.items()},
           "units_executed": train.units_executed,
           "virtual_makespan_s": train.makespan,
           "avg_utilization": train.avg_utilization,
           "exposed_transfer_s": train.exposed_transfer_time,
           "hidden_transfer_s": train.hidden_transfer_time,
           "setup_s": setup_s, "wall_s": wall,
           "bytes_promoted": promoted,
           "effective_h2d_gb_per_s": promoted / wall / 1e9,
           "trained_tok_per_s": (len(execs) * steps * TRAIN_BATCH
                                 * TRAIN_SEQ / wall),
           "ledger_peak_bytes": peak_used,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "plan_provenance": plan.provenance,
           "plan_est_makespan_s": plan.schedule["est_makespan_s"],
           "plan_shard_bounds": [[(sh["seg_lo"], sh["seg_hi"])
                                  for sh in j.partition["shards"]]
                                 for j in plan.jobs]}
    log(f"[sharp] 2 x {cfg.name} full width, {steps} steps of "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens: shards {shards} "
        f"{res['shard_layers'][0]}, units {train.units_executed}, virtual "
        f"makespan {train.makespan:.4f} s, avg utilization "
        f"{train.avg_utilization:.4f}, wall {wall:.2f} s (setup "
        f"{setup_s:.2f} s), bytes promoted {promoted} "
        f"({res['effective_h2d_gb_per_s']:.3f} GB/s over the wall), "
        f"trained {res['trained_tok_per_s']:.1f} tok/s, ledger peak "
        f"{peak_used} of {budget}, max_memory_allocated "
        f"{res['max_memory_allocated']}")
    if min(shards) < 3:
        fail(f"SHARP partitioned {cfg.name} into {shards} shards at a "
             f"{budget} B budget; expected at least 3 a model")
    expect = len(execs) * steps * 2 * shards[0]
    if len(set(shards)) != 1 or train.units_executed != expect:
        fail(f"SHARP ran {train.units_executed} units; expected models x "
             f"steps x 2 x shards = {expect}")
    if max(peak_used.values()) > budget:
        fail(f"the device ledger went over its budget: {peak_used}")

    refs = {}
    for seed, lr in enumerate(lrs):
        _, refs[seed] = train_sequential_reference(
            ModelTask(cfg, train_loader(cfg, seed), lr=lr, epochs=1,
                      steps_per_epoch=steps, seed=seed,
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ), device="cuda")
        torch.cuda.empty_cache()
    res["sequential_losses"] = refs
    res["max_abs_loss_diff"] = max(
        float(np.abs(np.subtract(refs[i], train.losses[i])).max())
        for i in refs)
    log(f"[sharp] losses {res['losses']}; sequential reference {refs}; "
        f"max abs diff {res['max_abs_loss_diff']:.3g} (tol {SHARP_TOL})")
    for i in refs:
        if not np.allclose(train.losses[i], refs[i], rtol=SHARP_TOL,
                           atol=SHARP_TOL):
            fail(f"model {i}: SHARP losses {train.losses[i]} differ from "
                 f"sequential training's {refs[i]}")
    return session, res


def layer0_qkv(cfg, params, batch):
    """Layer 0's roped q, k, v of ``batch`` (bf16, layer layout), as the
    eval path hands them to the flash kernel."""
    import torch

    from repro_torch.configs import torch_dtype
    from repro_torch.core.spilling import to_device
    from repro_torch.models import layers as nn
    from repro_torch.models import transformer

    with torch.no_grad():
        embed = to_device(params["embed"], "cuda")
        lp = to_device(transformer.layer_slices(params["layers"], 1)[0],
                       "cuda")
        x = nn.embed(embed, batch["tokens"], torch_dtype(cfg.dtype))
        q, k, v = nn._project_qkv(lp["attn"],
                                  transformer._norm(cfg, lp["attn_norm"], x),
                                  cfg)
        pos = torch.arange(x.shape[1], device="cuda")[None, :]
        return (nn.apply_rope(q, pos, cfg.rope_theta),
                nn.apply_rope(k, pos, cfg.rope_theta), v)


def phase_spilled_eval(cfg, trained, flush):
    """An EvalJob of 2 batches (2 x 1024) over model 0's trained params,
    forward-only through the shard queue, once with the flash kernel
    (attn_impl 'cuda') and once with the default plain attention.  The
    kernel must launch batches x layers times; one full forward through
    the kernel may be at most LOGIT_REL x as far from an f32 forward as
    the plain bf16 forward; and the kernel's numbers at layer 0's q/k/v
    of the first batch."""
    import torch

    from repro_torch.api import EvalJob, HydraConfig, Session
    from repro_torch.core.spilling import to_device
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.models import api

    res = {}
    for impl in ("cuda", "xla"):
        session = Session(HydraConfig(n_devices=1,
                                      device_budget_bytes=EVAL_BUDGET),
                          device="cuda")
        session.submit(EvalJob(cfg.replace(attn_impl=impl),
                               train_loader(cfg, 10), n_batches=EVAL_BATCHES,
                               params=trained, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ))
        session.plan()                          # build stores and shards
        torch.cuda.synchronize()
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        ev = session.run().evals["eval-0"]
        torch.cuda.synchronize()
        ev["wall_s"] = time.perf_counter() - t0
        ev["launches"] = flash_attention_bhsd.launches
        res[impl] = ev
        log(f"[eval] attn_impl={impl}: {ev['n_shards']} shards, losses "
            f"{ev['losses']}, mean {ev['mean_loss']:.6f}, perplexity "
            f"{ev['perplexity']:.3f}, bytes moved {ev['bytes_moved']}, wall "
            f"{ev['wall_s']:.3f} s, flash launches {ev['launches']}")
        del session
    expect = EVAL_BATCHES * cfg.n_layers
    if res["cuda"]["launches"] != expect:
        fail(f"flash_attention launched {res['cuda']['launches']} times on "
             f"the eval path; expected batches x layers = {expect}")
    if res["xla"]["launches"] != 0:
        fail("the default attn_impl launched the flash kernel")
    if res["cuda"]["n_shards"] < 2:
        fail("the eval ran unspilled (one shard)")

    batch = as_tensors(next(iter(train_loader(cfg, 10))), "cuda")
    with torch.no_grad():
        dev_params = to_device(trained, "cuda")
        cfg32 = cfg.replace(dtype="float32")
        logits = {
            "cuda": api.forward(cfg.replace(attn_impl="cuda"), dev_params,
                                batch),
            "ref": api.forward(cfg, dev_params, batch),
            "f32": api.forward(cfg32, dev_params, batch)}
    res["both_ways"] = logit_gate("one full forward (2 x 1024)", logits)
    del logits, dev_params
    torch.cuda.empty_cache()
    q, k, v = layer0_qkv(cfg, trained, batch)
    m = measure_flash(q, k, v, True, None, "bfloat16", flush)
    log(f"[kernel] flash_attention at the eval path's layer 0 q/k/v "
        f"(b {TRAIN_BATCH}, s {TRAIN_SEQ}, causal): ms={m['ms']:.4f} "
        f"plain_ms={m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} "
        f"bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} ({m['bound_by']}) "
        f"max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("flash_attention kernel disagrees with its plain version at "
             "the eval path's inputs")
    res["main_path_kernel"] = m
    return res


def phase_unit_profiles(session):
    """One SHARP forward unit and one backward unit of model 0's middle
    shard, each as the executor runs it (promote; forward — or backward,
    optimizer step and demote), under the profiler."""
    import torch

    from repro_torch.data.pipeline import as_tensors

    m = session.train_execs[0]
    shards = m.partition.shards
    mid = shards[len(shards) // 2]
    batch = as_tensors(next(iter(train_loader(m.cfg, 20))), "cuda")
    act = {}
    with torch.no_grad():
        for s in shards[:mid.index]:
            own, shared, _ = m.store.promote_shard(s)
            act, _ = m.fns.fwd(s)(own, shared, act, batch)
    cot = {"x": torch.full_like(act["x"], 1e-3)}
    entry = act

    def fwd_unit():
        own, shared, _ = m.store.promote_shard(mid)
        return m.fns.fwd(mid)(own, shared, entry, batch)

    def bwd_unit():
        own, shared, opt_state = m.store.promote_shard(mid)
        g_own, _, g_act = m.fns.bwd(mid)(own, shared, entry, cot, batch)
        new_own, new_opt = m.fns._step(own, g_own, opt_state)
        m.store.demote_shard(mid, new_own, new_opt)
        return g_act

    label = (f"SHARP {{}} unit, qwen3-0.6b shard {mid.index} (layers "
             f"{mid.seg_lo - 1}..{mid.seg_hi - 2}, "
             f"{m.store.shard_transfer_bytes(mid)} B promoted)")
    return {"shard": mid.index,
            "fwd": profiled(label.format("forward"), fwd_unit),
            "bwd": profiled(label.format("backward"), bwd_unit)}


# ---------------------------------------------------------------------------
# phase 13: the machine profiler and measured-cost planning
# ---------------------------------------------------------------------------

def smoke_loader(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    return SyntheticTokens(DataConfig(batch_size=2, seq_len=64,
                                      vocab_size=cfg.vocab_size, seed=seed))


def phase_profiler(cfg, sharp_res):
    """``build_facts()`` on the card (every probe, full size; saved under
    build/), with the launches of the RMSNorm and SwiGLU kernels its
    kernel probe makes; phase 10's two-model session planned again with
    those facts (measured queries > 0 where phase 10's analytic plan had
    0, and the same shard boundaries); a smoke-width two-model session
    trained with and without the facts (identical losses: facts change
    estimates, never execution)."""
    import torch

    from repro_torch.api import HydraConfig, Session, TrainJob
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import rms_norm_2d
    from repro_torch.kernels.swiglu import swiglu_2d
    from repro_torch.profiler import build_facts

    counters = {"rms_norm_2d": rms_norm_2d, "swiglu_2d": swiglu_2d}
    for c in counters.values():
        c.launches = 0                   # count this path's run only
    t0 = time.perf_counter()
    facts = build_facts(device="cuda")
    res = {"build_facts_s": time.perf_counter() - t0,
           "launches": {k: c.launches for k, c in counters.items()}}
    res["path"] = facts.save(str(ROOT / "build" / "profile_facts.json"))
    res.update(transfer=facts.transfer, decode=facts.decode,
               kernels=facts.kernels, accept_rates=facts.accept_rates,
               notes=facts.notes, fingerprint=facts.fingerprint)
    log(f"[profiler] build_facts() on {facts.fingerprint['device_kind']}: "
        f"{res['build_facts_s']:.2f} s, saved to build/profile_facts.json; "
        f"kernel launches of the probe {res['launches']}")
    for d in ("h2d", "d2h"):
        log(f"[profiler] {d}: " + ", ".join(
            f"{r['bytes']} B {r['gbytes_per_s']:.3f} GB/s"
            for r in facts.transfer[d]))
    for fam in ("dense", "ssm", "hybrid"):
        if fam not in facts.decode:
            fail(f"the decode probe measured no {fam} grid: "
                 f"{facts.notes.get('decode_errors')}")
        g = facts.decode[fam]
        log(f"[profiler] {fam} decode grid ({g['arch']}, batches "
            f"{g['batches']} x seqs {g['seqs']}): decode_step_s "
            f"{g['decode_step_s']}, prefill_s_per_token "
            f"{g['prefill_s_per_token']}")
    log(f"[profiler] families whose decode probe failed: "
        f"{sorted(facts.notes.get('decode_errors', {}))}; accept probe "
        f"errors {sorted(facts.notes.get('accept_errors', {}))}")
    log(f"[profiler] accept rates: {facts.accept_rates}")
    for name, r in facts.kernels.items():
        log(f"[profiler] kernel {name}: kernel_us {r['kernel_us']:.1f} "
            f"ref_us {r['ref_us']:.1f} fallback_delta "
            f"{r['fallback_delta']:.3f} default_impl {r['default_impl']}")
    want = {"flash_attention", "rms_norm", "swiglu", "paged_attention",
            "paged_verify", "paged_attention_quant", "fused_decode_layer"}
    if set(facts.kernels) != want or any(
            r["default_impl"] != "cuda" for r in facts.kernels.values()):
        fail(f"the kernel probe's rows {sorted(facts.kernels)} are not the "
             f"seven kernels on the card")
    if min(res["launches"].values()) == 0:
        fail(f"the profiler's kernel probe launched no RMSNorm / SwiGLU "
             f"kernel: {res['launches']}")

    # phase 10's session, planned with the facts
    session = Session(HydraConfig(n_devices=2,
                                  device_budget_bytes=TRAIN_BUDGET),
                      device="cuda", profile=facts)
    for seed, lr in enumerate(TRAIN_LRS):
        session.submit(TrainJob(cfg, train_loader(cfg, seed), lr=lr,
                                optimizer="adamw", epochs=1,
                                steps_per_epoch=TRAIN_STEPS, seed=seed,
                                batch=TRAIN_BATCH, seq=TRAIN_SEQ))
    plan = session.plan()
    bounds = [[(sh["seg_lo"], sh["seg_hi"]) for sh in j.partition["shards"]]
              for j in plan.jobs]
    analytic = sharp_res["plan_provenance"]
    res["plan"] = {"n_measured": plan.provenance["n_measured"],
                   "n_analytic": plan.provenance["n_analytic"],
                   "est_makespan_s": plan.schedule["est_makespan_s"],
                   "analytic_n_measured": analytic["n_measured"],
                   "analytic_est_makespan_s":
                       sharp_res["plan_est_makespan_s"],
                   "same_shard_bounds":
                       bounds == sharp_res["plan_shard_bounds"]}
    del session, plan
    torch.cuda.empty_cache()
    pl = res["plan"]
    log(f"[profiler] phase 10's session planned with the facts: "
        f"{pl['n_measured']} measured / {pl['n_analytic']} analytic "
        f"queries (without: {pl['analytic_n_measured']} measured), "
        f"est_makespan_s {pl['est_makespan_s']} (analytic "
        f"{pl['analytic_est_makespan_s']}), same shard boundaries "
        f"{pl['same_shard_bounds']}")
    if pl["n_measured"] <= 0 or pl["analytic_n_measured"] != 0 \
            or not pl["same_shard_bounds"]:
        fail("measured-cost planning: expected measured queries with the "
             "facts, none without, and the same shard boundaries")

    # smoke-width two-model training both ways
    scfg = get_config("qwen3-0.6b", smoke=True)
    runs = []
    for profile in (None, facts):
        s = Session(HydraConfig(n_devices=2, device_budget_bytes=18 * 10**6),
                    device="cuda", profile=profile)
        for seed in (0, 1):
            s.submit(TrainJob(scfg, smoke_loader(scfg, seed), epochs=1,
                              steps_per_epoch=2, seed=seed, batch=2, seq=64))
        p = s.plan()
        runs.append((p.provenance["n_measured"],
                     {int(k): v for k, v in s.run(p).train.losses.items()}))
    res["smoke_train"] = {"n_measured": [r[0] for r in runs],
                          "losses": [r[1] for r in runs],
                          "identical": runs[0][1] == runs[1][1]}
    log(f"[profiler] smoke two-model training, analytic plan "
        f"({runs[0][0]} measured queries) vs measured plan ({runs[1][0]}): "
        f"losses {runs[0][1]} vs {runs[1][1]}, identical "
        f"{res['smoke_train']['identical']}")
    if not res["smoke_train"]["identical"] or runs[1][0] == 0:
        fail("training losses changed with the cost facts: facts may "
             "change estimates, never execution")
    return res


# ---------------------------------------------------------------------------
# phase 15: the SSD scan kernel against its plain version
# ---------------------------------------------------------------------------

SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # f32: the JAX test's MM_TOL


def distinct_bytes(t):
    """Bytes of the distinct elements a view covers: a broadcast axis
    (stride 0) counts once, as the kernel must read it once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def measure_ssd(x, log_a, b_coef, c_coef, chunk, dtype_name, flush):
    """SSD kernel vs plain chunked scan on one set of inputs: error, times,
    bound.  Least bytes: x, log_a, B, C read once (``distinct_bytes``) and
    y written once; operations: ``ssd_flops`` (the causal half of each
    chunk's products).  No one PyTorch call computes this function, so
    there is no library yardstick."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_flops

    with torch.no_grad():
        out = ops.ssd_scan(x, log_a, b_coef, c_coef, chunk=chunk,
                           impl="cuda")[0]
        exp = ref.ssd_chunked_ref(x, log_a, b_coef, c_coef, chunk)[0]
        torch.cuda.synchronize()
        diff = (out.float() - exp.float()).abs()
        tol = SSD_TOL[dtype_name]
        ok = bool((diff <= tol + tol * exp.float().abs()).all())
        res = {"max_abs_err": float(diff.max()),
               "max_abs_ref": float(exp.float().abs().max()),
               "within_tol": ok and bool(torch.isfinite(out).all()),
               "ms": cuda_ms(lambda: ops.ssd_scan(
                   x, log_a, b_coef, c_coef, chunk=chunk, impl="cuda"),
                   flush=flush),
               "plain_ms": cuda_ms(lambda: ref.ssd_chunked_ref(
                   x, log_a, b_coef, c_coef, chunk), iters=5, flush=flush),
               "library_ms": None}
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    nbytes = sum(distinct_bytes(t) for t in (x, log_a, b_coef, c_coef)) \
        + x.numel() * x.element_size()
    flops = ssd_flops(bsz, s, h, p, n, chunk)
    set_bound(res, nbytes, flops, dtype_name)
    res["bytes"], res["flops"] = nbytes, flops
    del out, exp, diff
    return res


def ssd_inputs(b, s, h, p, n, dtype, seed, broadcast=False, log_a=None):
    """The reference tests' scales (x ~ N(0,1), log decay -|N(0,1)|·0.1,
    B and C ~ N(0,1)·0.3), made on the card from ``seed``; ``broadcast``
    expands one B/C group over the heads (head stride 0, the Mamba2
    block's layout); ``log_a`` pins every decay to one value."""
    import torch
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = randn(b, s, h, p).to(dtype)
    la = (-randn(b, s, h).abs() * 0.1 if log_a is None
          else torch.full((b, s, h), float(log_a), device="cuda"))
    hb = 1 if broadcast else h
    bc = (randn(b, s, hb, n) * 0.3).to(dtype)
    cc = (randn(b, s, hb, n) * 0.3).to(dtype)
    if broadcast:
        bc, cc = bc.expand(b, s, h, n), cc.expand(b, s, h, n)
    return x, la, bc, cc


def phase_ssd_sweep(flush):
    """zamba2's Mamba2 (b 1, 2; s 256, 1024, 4096; h 64, p = n = 64, chunk
    256; B/C broadcast and contiguous), xlstm-350m's mLSTM (b 1, s 1024,
    h 4, p = n = 512), the four shapes of tests/test_kernels.py, and the
    decay edges (log_a = 0 and -30 per step), in bf16 and f32."""
    import torch
    cases = []          # b, s, h, p, n, chunk, broadcast, log_a
    for b in (1, 2):
        for s in (256, 1024, 4096):
            for bc in (True, False):
                cases.append((b, s, 64, 64, 64, 256, bc, None))
    cases.append((1, 1024, 4, 512, 512, 256, False, None))
    cases += [(2, 256, 2, 16, 8, 64, False, None),
              (1, 128, 4, 64, 32, 32, False, None),
              (1, 64, 1, 8, 8, 64, False, None),
              (2, 96, 2, 32, 16, 32, False, None)]
    cases += [(1, 1024, 64, 64, 64, 256, True, 0.0),
              (1, 1024, 64, 64, 64, 256, True, -30.0)]
    rows = []
    for dt in ("bfloat16", "float32"):
        for i, (b, s, h, p, n, chunk, bc, la) in enumerate(cases):
            x, lg, bm, cm = ssd_inputs(b, s, h, p, n, getattr(torch, dt),
                                       300 + i, broadcast=bc, log_a=la)
            r = measure_ssd(x, lg, bm, cm, chunk, dt, flush)
            r.update(dtype=dt, b=b, s=s, h=h, p=p, n=n, chunk=chunk,
                     broadcast=bc, log_a=la)
            rows.append(r)
            log(f"[kernel] ssd_scan {dt} b={b} s={s} h={h} p={p} n={n} "
                f"chunk={chunk} broadcast_bc={bc} log_a={la}: max_abs_err="
                f"{r['max_abs_err']:.3g} (tol {SSD_TOL[dt]} rel+abs, max "
                f"|ref| {r['max_abs_ref']:.3g}) ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
                f" bound_share={r['bound_share']:.3f} "
                f"({r['bound_by']})")
            if not r["within_tol"]:
                fail(f"ssd_scan kernel disagrees with its plain version "
                     f"({dt}, b={b}, s={s}, h={h}, p={p}, n={n}, chunk="
                     f"{chunk}, broadcast={bc}, log_a={la}): max abs err "
                     f"{r['max_abs_err']}")
            del x, lg, bm, cm
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 16: full-width zamba2-1.2b — serve, spilled eval, kernel forward,
# SHARP, small f32 engine
# ---------------------------------------------------------------------------

Z_GEN, Z_CAPACITY, Z_REQUESTS = 16, 8, 8
Z_TRAIN_BUDGET = 8 * 10**9    # per virtual device: 3 shards a model
Z_TRAIN_STEPS = 2


def zamba_prompts(vocab, seed=0):
    """8 prompts of 16..128 tokens (numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 129, Z_REQUESTS)
    return [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lens]


def phase_zamba_serve(cfg, params, prompts):
    """Full-width zamba2 through ``InferenceEngine`` (slot backend): every
    request gets exactly Z_GEN tokens; decode and prefill tok/s; one
    decode step over the final pool state profiled; ``backend="paged"``
    falls back to slot with a CapabilityFallbackWarning."""
    import warnings

    import torch

    from repro_torch.models import api
    from repro_torch.models.registry import CapabilityFallbackWarning
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_map

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        peng = InferenceEngine(cfg, params, capacity=1, max_seq=32,
                               backend="paged", device="cuda")
    s = peng.summary()
    fell_back = (any(issubclass(w.category, CapabilityFallbackWarning)
                     for w in caught)
                 and (s["backend"], s["requested_backend"])
                 == ("slot", "paged"))
    del peng
    if not fell_back:
        fail("zamba2: backend='paged' did not fall back to slot with a "
             "CapabilityFallbackWarning")
    warm = InferenceEngine(cfg, params, capacity=2, max_seq=32,
                           device="cuda")
    for p in prompts[:2]:
        warm.submit(p[:8], 2)
    warm.run()
    del warm
    torch.cuda.empty_cache()

    max_seq = max(len(p) for p in prompts) + Z_GEN
    eng = InferenceEngine(cfg, params, capacity=Z_CAPACITY, max_seq=max_seq,
                          device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(p, Z_GEN, request_id=f"z{i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = eng.summary()
    done = {r.request_id: r for r in eng.completed}
    if len(done) != len(prompts):
        fail(f"zamba2 serve: served {len(done)} of {len(prompts)} requests")
    for rid, r in done.items():
        if len(r.generated) != Z_GEN or r.status.value != "finished":
            fail(f"zamba2 serve {rid}: {len(r.generated)} tokens, status "
                 f"{r.status}")
    res = {"requests": len(done), "gen": Z_GEN, "wall_s": wall,
           "fell_back_from_paged": fell_back,
           "prompt_lens": [len(p) for p in prompts],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **{k: summary.get(k) for k in (
               "backend", "slot_bytes", "decode_steps", "prefill_calls",
               "prefill_tok_per_s", "decode_tok_per_s", "kv_peak_bytes",
               "peak_concurrency")},
           "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
           "tokens": {rid: r.generated for rid, r in done.items()}}
    log(f"[zamba2 serve] full width (38 Mamba2 layers, 6 shared-block "
        f"sites): {res['requests']} requests x {Z_GEN} tokens, prompts "
        f"{res['prompt_lens']}, prefill {res['prefill_tok_per_s']} tok/s "
        f"(token by token), decode {res['decode_tok_per_s']} tok/s, "
        f"decode_steps {res['decode_steps']}, prefill_calls "
        f"{res['prefill_calls']}, slot_bytes {res['slot_bytes']}, wall "
        f"{wall:.2f} s, max_memory_allocated {res['max_memory_allocated']}"
        f"; paged request fell back to slot: {fell_back}")
    state = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                     else t, eng.pool.state)
    toks = torch.zeros((Z_CAPACITY, 1), dtype=torch.long, device="cuda")
    res["profile"] = profiled(
        "zamba2 one decode step (8 lanes)",
        lambda: api.decode_step(cfg, eng.params, state, toks))
    del eng, state
    torch.cuda.empty_cache()
    return res


def hybrid_site0_qkv(cfg, params, batch):
    """The roped q, k, v the shared block's first invocation site computes
    for ``batch`` (bf16, layer layout): embed, the Mamba2 layers up to the
    first flagged one, the shared block's attention norm and projection."""
    import numpy as np
    import torch

    from repro_torch.configs import torch_dtype
    from repro_torch.models import hybrid
    from repro_torch.models import layers as nn
    from repro_torch.models.transformer import layer_slices

    first = int(np.argmax(hybrid.attn_flags(cfg)))
    sp = params["shared_attn"]
    with torch.no_grad():
        x = nn.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
        for lp in layer_slices(params["layers"], first + 1):
            x = hybrid.apply_layer(cfg, lp, x, sp, False)
        q, k, v = nn._project_qkv(sp["attn"],
                                  nn.rms_norm(sp["attn_norm"], x), cfg)
        pos = torch.arange(x.shape[1], device="cuda")[None, :]
        return (nn.apply_rope(q, pos, cfg.rope_theta),
                nn.apply_rope(k, pos, cfg.rope_theta), v)


def plan_forward(cfg, params, batch, use_kernel):
    """One forward composed of the hybrid shard plan's segments (embed,
    38 layer segments, head), each Mamba2 layer through
    ``mamba2_forward(use_kernel=...)`` as ``_hybrid_plan``'s layer apply
    would run with the switch on."""
    import torch

    from repro_torch.core import shard_graph as sg
    from repro_torch.models import hybrid

    plan = sg.build_plan(cfg)
    flags = hybrid.attn_flags(cfg)
    act = {}
    with torch.no_grad():
        for seg in plan.segments:
            apply = seg.apply
            if seg.name.startswith("mamba"):
                i = int(seg.name[len("mamba"):])
                apply = sg.hybrid_layer_apply(bool(flags[i]),
                                              use_kernel=use_kernel)
            own = sg.resolve_ref(params, seg.param_ref)
            shared = {n: sg.resolve_ref(params, plan.shared_refs[n])
                      for n in seg.shared}
            act = apply(cfg, own, shared, act, batch)
    return act["logits"]


def phase_zamba_eval(cfg, params, flush):
    """(b) An EvalJob of 2 batches (2 x 1024) through the shard queue,
    with the flash kernel (attn_impl 'cuda') and with plain attention: the
    flash kernel must launch batches x 6 times; one flash call at the
    shared block's shape (its first site's q/k/v) against its plain
    version.  (c) One forward of the eval batch composed as the hybrid
    plan's segments with every Mamba2 scan through the SSD kernel: 38
    launches exactly, and its logits at most LOGIT_REL x as far from an
    f32 forward as the plain bf16 forward's; the kernel's numbers at layer
    0's scan inputs of that batch."""
    import torch

    from repro_torch.api import EvalJob, HydraConfig, Session
    from repro_torch.data.pipeline import as_tensors
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ssd_scan import ssd_scan_bshpn
    from repro_torch.models import hybrid, ssm
    from repro_torch.models import layers as nn
    from repro_torch.models.transformer import layer_slices

    sites = hybrid.n_attn_invocations(cfg)
    res = {}
    for impl in ("cuda", "xla"):
        session = Session(HydraConfig(n_devices=1,
                                      device_budget_bytes=EVAL_BUDGET),
                          device="cuda", profile=None)
        session.submit(EvalJob(cfg.replace(attn_impl=impl),
                               train_loader(cfg, 10), n_batches=EVAL_BATCHES,
                               params=params, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ))
        session.plan()
        torch.cuda.synchronize()
        flash_attention_bhsd.launches = 0
        t0 = time.perf_counter()
        ev = session.run().evals["eval-0"]
        torch.cuda.synchronize()
        ev["wall_s"] = time.perf_counter() - t0
        ev["launches"] = flash_attention_bhsd.launches
        res[impl] = ev
        log(f"[zamba2 eval] attn_impl={impl}: {ev['n_shards']} shards, "
            f"losses {ev['losses']}, mean {ev['mean_loss']:.6f}, perplexity "
            f"{ev['perplexity']:.3f}, bytes moved {ev['bytes_moved']}, wall "
            f"{ev['wall_s']:.3f} s, flash launches {ev['launches']}")
        del session
        torch.cuda.empty_cache()
    if res["cuda"]["launches"] != EVAL_BATCHES * sites:
        fail(f"zamba2 eval: flash_attention launched "
             f"{res['cuda']['launches']} times; expected batches x sites = "
             f"{EVAL_BATCHES * sites}")
    if res["xla"]["launches"] != 0:
        fail("zamba2 eval: the default attn_impl launched the flash kernel")
    if res["cuda"]["n_shards"] < 2:
        fail("zamba2 eval ran unspilled (one shard)")

    batch = as_tensors(next(iter(train_loader(cfg, 10))), "cuda")
    q, k, v = hybrid_site0_qkv(cfg, params, batch)
    m = measure_flash(q, k, v, True, None, "bfloat16", flush)
    log(f"[kernel] flash_attention at the shared block's first site "
        f"(b {TRAIN_BATCH}, s {TRAIN_SEQ}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.head_dim}, causal): ms={m['ms']:.4f} plain_ms="
        f"{m['plain_ms']:.4f} library_ms={m['library_ms']:.4f} bound_ms="
        f"{m['bound_ms']:.4f} bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err="
        f"{m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("flash_attention kernel disagrees with its plain version at "
             "the shared block's shape")
    res["flash_hybrid_shape"] = m
    del q, k, v

    # (c) the forward through the SSD kernel, gated both ways
    torch.cuda.synchronize()
    ssd_scan_bshpn.launches = 0
    t0 = time.perf_counter()
    kernel_logits = plan_forward(cfg, params, batch, True)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = ssd_scan_bshpn.launches
    logits = {"cuda": kernel_logits,
              "ref": plan_forward(cfg, params, batch, False),
              "f32": plan_forward(cfg.replace(dtype="float32"), params,
                                  batch, False)}
    log(f"[zamba2 kernel forward] every Mamba2 scan through ssd_scan_bshpn: "
        f"{launches} launches, forward {fwd_s:.3f} s")
    if launches != cfg.n_layers:
        fail(f"ssd_scan_bshpn launched {launches} times in the kernel "
             f"forward; expected one per Mamba2 layer = {cfg.n_layers}")
    res["kernel_forward"] = {"launches": launches, "wall_s": fwd_s,
                             **logit_gate("zamba2 forward through the SSD "
                                          "kernel (2 x 1024)", logits)}
    del logits, kernel_logits
    torch.cuda.empty_cache()
    with torch.no_grad():
        lp = layer_slices(params["layers"], 1)[0]
        x = nn.embed(params["embed"], batch["tokens"], torch.bfloat16)
        xdt, la, bc, cc, _, _ = ssm.mamba2_scan_inputs(
            lp["mamba"], nn.rms_norm(lp["norm"], x), cfg)
    m = measure_ssd(xdt, la, bc, cc, cfg.ssm_chunk, "bfloat16", flush)
    log(f"[kernel] ssd_scan at the kernel forward's layer 0 inputs (b "
        f"{TRAIN_BATCH}, s {TRAIN_SEQ}, h {xdt.shape[2]}, p {xdt.shape[3]}, "
        f"n {bc.shape[3]}, B/C broadcast): ms={m['ms']:.4f} plain_ms="
        f"{m['plain_ms']:.4f} bound_ms={m['bound_ms']:.4f}"
        f" bound_share={m['bound_share']:.3f} "
        f"({m['bound_by']}) max_abs_err={m['max_abs_err']:.3g}")
    if not m["within_tol"]:
        fail("ssd_scan kernel disagrees with its plain version at the "
             "kernel forward's inputs")
    res["main_path_kernel"] = m
    return res


def phase_small_hybrid_f32():
    """A small float32 zamba2 engine (smoke width): lanes at different
    positions in one pooled step give each request the tokens it gets
    decoded alone."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config("zamba2-1.2b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(5),
                             "cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (5, 17, 9, 12)]

    def serve(ps, capacity, stagger):
        eng = InferenceEngine(cfg, params, capacity=capacity, max_seq=40,
                              device="cuda")
        pending = list(enumerate(ps))
        while pending or eng.has_work():
            for i, p in pending[:stagger]:
                eng.submit(p, 10, request_id=f"h{i}")
            pending = pending[stagger:]
            eng.step()
        eng.run()
        return {r.request_id: r.generated for r in eng.completed}

    pooled = serve(prompts, 3, 1)
    alone = {}
    for i, p in enumerate(prompts):
        alone.update({f"h{i}": serve([p], 1, 1)["h0"]})
    same = sum(pooled[k] == alone[k] for k in alone)
    log(f"[small f32] zamba2 smoke engine, 3 lanes joining one tick apart: "
        f"{same} of {len(alone)} requests token-identical to decoding "
        f"alone")
    if same != len(alone):
        fail("zamba2 smoke f32: pooled lanes at different positions did "
             "not give the tokens each request gets alone")
    return {"requests": len(alone), "identical": same}


def kernel_entry(name, source, replaces, launches, m):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "bound_share": m["bound_share"]}


def main() -> None:
    import argparse
    global LOG_FILE
    ap = argparse.ArgumentParser(description="chip smoke run of the port")
    ap.add_argument("--out-dir", default=None,
                    help="write chip_smoke.json and chip_smoke.log here "
                    "(default: chip_smoke.json under build/, no log copy)")
    args = ap.parse_args()
    out_dir = Path(args.out_dir) if args.out_dir else ROOT / "build"
    if args.out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        LOG_FILE = out_dir / "chip_smoke.log"
        LOG_FILE.write_text("")
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
        from repro_torch.kernels.paged_attention import SPLIT_ROWS, n_splits
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

    # 2 (and 14). build: paged_attention.cu (fp and int8 entry points),
    #    paged_verify.cu, flash_attention.cu, fused_decode.cu, rmsnorm.cu,
    #    swiglu.cu and ssd_scan.cu, one nvcc each, in parallel
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(kernels.KERNELS)} (paged_attention_lanes "
        f"and paged_attention_quant_lanes: split-KV, {SPLIT_ROWS}-row "
        f"splits, then a fixed-order merge, two launches an op call; "
        f"paged_verify_lanes, "
        f"flash_attention_bhsd, fused_decode_layer, rms_norm_2d, "
        f"swiglu_2d, ssd_scan_bshpn) built in "
        f"{build_s:.2f} s (nvcc {_build.nvcc_path()}, sm_90a)")
    for k, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {k}: {line.strip()}")
    report["build_s"] = build_s

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    # 3. each kernel against its plain version over its sweep
    report["sweep"] = phase_kernel_sweep(flush)
    report["verify_sweep"] = phase_verify_sweep(flush)
    report["quant_sweep"] = phase_quant_sweep(flush)
    report["fused_sweep"] = phase_fused_sweep(flush)
    report["rms_swiglu_sweep"], probe_shape = phase_rms_swiglu_sweep(flush)

    # 4. serve full-width qwen3-0.6b on the paged backend
    cfg = get_config("qwen3-0.6b")
    params = api.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    prompts = serve_prompts(cfg.vocab_size)
    eng, snap, report["serve"] = phase_serve(cfg, params, prompts)

    # the kernel's numbers at the serve path's own inputs (layer 0 pages
    # and the lanes' lengths at the snapshot step)
    le = torch.from_numpy(snap["lengths"] + 1).cuda()
    tb = torch.from_numpy(snap["tables"]).cuda()
    q = torch.randn(CAPACITY, NH, HD, device="cuda").to(torch.bfloat16)
    main_path = measure_paged(q, snap["pages"]["k"][0], snap["pages"]["v"][0],
                              tb, le, None, "bfloat16", flush)
    main_path["lengths"] = le.tolist()
    main_path["splits"] = n_splits(tb.shape[1], BS)
    log(f"[kernel] paged_attention at the serve path's inputs "
        f"(lengths {main_path['lengths']}, {tb.shape[1]}-block tables, "
        f"splits={main_path['splits']}): ms={main_path['ms']:.4f} "
        f"plain_ms={main_path['plain_ms']:.4f} "
        f"library_ms={main_path['library_ms']:.4f} "
        f"bound_ms={main_path['bound_ms']:.4f}"
        f" bound_share={main_path['bound_share']:.3f} "
        f"max_abs_err={main_path['max_abs_err']:.3g}")
    if not main_path["within_tol"]:
        fail("paged_attention kernel disagrees with its plain version at "
             "the serve path's inputs")
    report["main_path_kernel"] = main_path

    # 5. one step both ways, and one profiled step
    report["both_ways"] = phase_both_ways(cfg, eng, snap, params)
    report["profile"] = phase_profile(cfg, eng, snap)
    bf16_params = eng.params
    del eng, snap
    torch.cuda.empty_cache()

    # 5b. the same requests through the fused decode layer
    report["fused_serve"] = phase_fused_serve(
        cfg, params, prompts, report["serve"], report["profile"], flush)
    torch.cuda.empty_cache()

    # 6. speculative serve over the paged inner: (a) the target's own
    #    parameters as the draft (every round accepts k), (b) a random
    #    4-layer qwen3-0.6b draft from seed 1 (rollback every round)
    _, report["spec_self"] = phase_spec_serve(
        cfg, params, prompts, cfg, params, "spec (a) self-draft")
    dcfg = cfg.replace(n_layers=4)
    dparams = api.init_params(dcfg, torch.Generator("cuda").manual_seed(1),
                              "cuda")
    vsnap, report["spec_random"] = phase_spec_serve(
        cfg, params, prompts, dcfg, dparams, "spec (b) random 4-layer draft")
    del dparams
    for key in ("spec_self", "spec_random"):
        r = report[key]
        r["requests_token_identical_to_paged"] = sum(
            r["tokens"][k] == report["serve"]["tokens"][k]
            for k in r["tokens"])
    lanes = (vsnap["tables"] != 0).any(dim=1)
    qv = torch.randn(CAPACITY, DRAFT_K, NH, HD,
                     device="cuda").to(torch.bfloat16)
    verify_path = measure_verify(qv, vsnap["pages"]["k"][0],
                                 vsnap["pages"]["v"][0], vsnap["tables"],
                                 vsnap["lengths"], None, "bfloat16", flush,
                                 lanes=lanes)
    verify_path["lengths"] = vsnap["lengths"].tolist()
    verify_path["lanes_in_round"] = int(lanes.sum())
    log(f"[kernel] paged_verify at the spec serve path's inputs (k "
        f"{DRAFT_K}, lengths {verify_path['lengths']}, "
        f"{verify_path['lanes_in_round']} lanes in the round): "
        f"ms={verify_path['ms']:.4f} plain_ms={verify_path['plain_ms']:.4f} "
        f"library_ms={verify_path['library_ms']:.4f} "
        f"bound_ms={verify_path['bound_ms']:.4f}"
        f" bound_share={verify_path['bound_share']:.3f} "
        f"max_abs_err={verify_path['max_abs_err']:.3g}")
    if not verify_path["within_tol"]:
        fail("paged_verify kernel disagrees with its plain version at the "
             "spec serve path's inputs")
    report["verify_path_kernel"] = verify_path
    report["verify_both_ways"] = phase_verify_both_ways(cfg, vsnap, params,
                                                        bf16_params)
    del vsnap
    torch.cuda.empty_cache()

    # 7. serve from an int8 paged pool
    ieng, isnap, report["int8_serve"] = phase_int8_serve(
        cfg, params, prompts, report["serve"])
    del ieng
    qq = torch.randn(CAPACITY, NH, HD, device="cuda").to(torch.bfloat16)
    pg = isnap["pages"]
    quant_path = measure_quant(
        qq, pg["k"][0], pg["v"][0], pg["k_scale"][0], pg["v_scale"][0],
        torch.from_numpy(isnap["tables"]).cuda(),
        torch.from_numpy(isnap["lengths"] + 1).cuda(), None, flush)
    quant_path["lengths"] = (isnap["lengths"] + 1).tolist()
    quant_path["splits"] = n_splits(isnap["tables"].shape[1], BS)
    log(f"[kernel] paged_attention_quant at the int8 serve path's inputs "
        f"(lengths {quant_path['lengths']}, {isnap['tables'].shape[1]}-block"
        f" tables, splits={quant_path['splits']}): "
        f"ms={quant_path['ms']:.4f} "
        f"plain_ms={quant_path['plain_ms']:.4f} "
        f"library_ms={quant_path['library_ms']:.4f} "
        f"bound_ms={quant_path['bound_ms']:.4f}"
        f" bound_share={quant_path['bound_share']:.3f} "
        f"max_abs_err={quant_path['max_abs_err']:.3g}")
    if not quant_path["within_tol"]:
        fail("paged_attention_quant kernel disagrees with its plain version "
             "at the int8 serve path's inputs")
    report["quant_path_kernel"] = quant_path
    report["int8_both_ways"] = phase_int8_both_ways(cfg, isnap, params,
                                                    bf16_params)
    report["int8_profile"] = phase_profile(
        cfg, SimpleNamespace(params=bf16_params), isnap,
        "one int8 decode step (8 lanes)")
    del isnap, bf16_params, params
    torch.cuda.empty_cache()

    # 8. small float32 engines both ways
    report["small_f32"] = phase_small_f32()
    torch.cuda.empty_cache()

    # 9. the flash kernel against its plain version over its sweep
    report["flash_sweep"] = phase_flash_sweep(flush)
    torch.cuda.empty_cache()

    # 10. SHARP training of two full-width models through the Session
    session, report["sharp_train"] = phase_sharp_train(cfg)
    torch.cuda.empty_cache()

    # 11. spilled eval of model 0's trained params, kernel and plain
    report["spilled_eval"] = phase_spilled_eval(
        cfg, session.train_execs[0].store.model_params(), flush)
    flash_path = report["spilled_eval"]["main_path_kernel"]
    torch.cuda.empty_cache()

    # 12. one SHARP forward unit and one backward unit, profiled
    report["unit_profiles"] = phase_unit_profiles(session)
    del session
    torch.cuda.empty_cache()

    # 13. the machine profiler, and plans priced with its facts
    report["profiler"] = phase_profiler(cfg, report["sharp_train"])
    torch.cuda.empty_cache()

    # 15. the SSD scan kernel against its plain version over its sweep
    report["ssd_sweep"] = phase_ssd_sweep(flush)

    # 16. full-width zamba2-1.2b: (a) serve, (b) spilled eval and (c) a
    #     forward through the SSD kernel, (d) SHARP, (e) small f32 engine
    zcfg = get_config("zamba2-1.2b")
    zparams = api.init_params(zcfg, torch.Generator("cuda").manual_seed(0),
                              "cuda")
    report["zamba_serve"] = phase_zamba_serve(zcfg, zparams,
                                              zamba_prompts(zcfg.vocab_size))
    report["zamba_eval"] = phase_zamba_eval(zcfg, zparams, flush)
    ssd_path = report["zamba_eval"]["main_path_kernel"]
    del zparams
    torch.cuda.empty_cache()
    zsession, report["zamba_sharp"] = phase_sharp_train(
        zcfg, Z_TRAIN_BUDGET, Z_TRAIN_STEPS)
    del zsession
    torch.cuda.empty_cache()
    report["zamba_small_f32"] = phase_small_hybrid_f32()
    report["total_s"] = time.perf_counter() - t_start

    src = "src/repro_torch/kernels/csrc/"
    kernel_line = {"kernels": [
        kernel_entry("paged_attention_lanes", src + "paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:76",
                     report["serve"]["launches"], main_path),
        kernel_entry("paged_verify_lanes", src + "paged_verify.cu",
                     "src/repro/kernels/paged_verify.py:81",
                     report["spec_random"]["launches"], verify_path),
        kernel_entry("paged_attention_quant_lanes",
                     src + "paged_attention.cu",
                     "src/repro/kernels/paged_attention.py:164",
                     report["int8_serve"]["launches"], quant_path),
        kernel_entry("flash_attention_bhsd", src + "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:74",
                     report["spilled_eval"]["cuda"]["launches"],
                     flash_path),
        kernel_entry("fused_decode_layer", src + "fused_decode.cu",
                     "src/repro/kernels/fused_decode.py:92",
                     report["fused_serve"]["launches"],
                     report["fused_serve"]["main_path_kernel"]),
        kernel_entry("rms_norm_2d", src + "rmsnorm.cu",
                     "src/repro/kernels/rmsnorm.py:22",
                     report["profiler"]["launches"]["rms_norm_2d"],
                     probe_shape["rms_norm"]),
        kernel_entry("swiglu_2d", src + "swiglu.cu",
                     "src/repro/kernels/swiglu.py:44",
                     report["profiler"]["launches"]["swiglu_2d"],
                     probe_shape["swiglu"]),
        kernel_entry("ssd_scan_bshpn", src + "ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:60",
                     report["zamba_eval"]["kernel_forward"]["launches"],
                     ssd_path),
    ]}
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['total_s']:.1f} s")
    log(json.dumps(kernel_line))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
