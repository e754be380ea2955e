"""Microbenchmark probes — the measurements behind ``MachineFacts`` (port
of ``repro.profiler.probes``).

Each probe runs on ``device`` (the card unless the caller asks for the
CPU) and has a ``quick`` mode sized for CI smoke:

* ``probe_transfer`` — host<->device bandwidth both directions at a few
  payload sizes: ``non_blocking`` copies between pinned host memory and
  the card, timed to a ``synchronize``.
* ``probe_decode``   — per-family prefill + pooled-decode step latency on
  a small rectangular (batch, seq) grid, driven through the real
  ``InferenceEngine`` (admission, cache writes and token readback
  included — the seconds a serving plan pays).  The first engine step is
  a warm-up; later steps are timed through the engine's own
  ``decode_s``/``decode_steps`` counters, and prefill on a second
  admission wave.  Families the port has not ported fail, and land in
  ``_errors``.
* ``probe_kernels``  — every ``kernels/ops.py`` entry point against its
  plain version at the JAX probe's shapes (f32): on the card the CUDA
  kernel, on the CPU the plain version itself (``default_impl`` says
  which).
* ``probe_accept_rates`` — measured greedy-exact draft acceptance per
  spec-draftable family, through the port's spec backend.

``build_facts`` assembles a ``MachineFacts``; ``python -m
repro_torch.profiler`` is the CLI.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.profiler.facts import MachineFacts, current_fingerprint

# one servable smoke arch per probe family (the JAX probe's map; only the
# dense family is ported so far — the others fail into ``_errors``)
PROBE_FAMILY_ARCHS = {"dense": "qwen3-0.6b", "ssm": "xlstm-350m",
                      "hybrid": "zamba2-1.2b", "moe": "mixtral-8x22b"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, *args, device: torch.device, iters: int = 5) -> float:
    """Seconds per call, first (warm-up) call excluded; the device is
    synchronized before the clock starts and before it stops."""
    fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# host <-> device transfer
# ---------------------------------------------------------------------------

def probe_transfer(*, quick: bool = False, iters: int = 3,
                   device="cuda") -> dict:
    """Bandwidth rows per direction: [{"bytes", "seconds", "gbytes_per_s"}].
    On the card the host side is pinned (the memory SHARP's host store
    promotes from); on the CPU both sides are host memory."""
    dev = resolve_device(device)
    sizes = [1 << 16, 1 << 20, 1 << 22] if quick else \
        [1 << 16, 1 << 20, 1 << 24, 1 << 26]
    pin = dev.type == "cuda"
    h2d, d2h = [], []
    for n in sizes:
        host = torch.ones(n, dtype=torch.uint8, pin_memory=pin)
        back = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
        on_dev = torch.empty(n, dtype=torch.uint8, device=dev)
        for rows, dst, src in ((h2d, on_dev, host), (d2h, back, on_dev)):
            s = _time_call(lambda: dst.copy_(src, non_blocking=True),
                           device=dev, iters=iters)
            rows.append({"bytes": n, "seconds": s,
                         "gbytes_per_s": n / s / 1e9 if s else None})
    return {"h2d": h2d, "d2h": d2h}


# ---------------------------------------------------------------------------
# per-family decode / prefill grid
# ---------------------------------------------------------------------------

def _probe_family_grid(cfg, params, batches: Sequence[int],
                       seqs: Sequence[int], iters: int, device) -> dict:
    from repro_torch.serving.engine import InferenceEngine
    step_grid = [[0.0] * len(seqs) for _ in batches]
    prefill_grid = [[0.0] * len(seqs) for _ in batches]
    for i, b in enumerate(batches):
        for j, s in enumerate(seqs):
            eng = InferenceEngine(cfg, params, capacity=b, max_seq=s,
                                  model_name=f"probe-{cfg.name}",
                                  device=device)
            plen = max(4, s // 4)
            prompts = [np.random.default_rng(1000 + 17 * i + j * 3 + r)
                       .integers(0, cfg.vocab_size, plen, dtype=np.int32)
                       for r in range(b)]
            # wave 1: the first step warms up, later steps are timed
            for p in prompts:
                eng.submit(p, iters + 2)
            eng.step()
            d0, n0 = eng.decode_s, eng.decode_steps
            for _ in range(iters):
                eng.step()
            dn = eng.decode_steps - n0
            step_grid[i][j] = (eng.decode_s - d0) / max(1, dn)
            eng.run()                            # drain stragglers
            # wave 2: the same (n, plen) group, warm
            p0, t0 = eng.prefill_s, eng.prefill_tokens
            for p in prompts:
                eng.submit(p, 1)
            eng.step()
            new_tok = eng.prefill_tokens - t0
            prefill_grid[i][j] = (eng.prefill_s - p0) / max(1, new_tok)
            eng.run()
    return {"arch": cfg.name,
            "n_active_params": int(cfg.n_active_params),
            "batches": list(batches), "seqs": list(seqs),
            "decode_step_s": step_grid,
            "prefill_s_per_token": prefill_grid}


def probe_decode(*, quick: bool = False,
                 families: Optional[Sequence[str]] = None,
                 iters: Optional[int] = None, device="cuda") -> dict:
    """Per-family (batch, seq) latency grids via the live engine surface.

    A family whose probe fails (not ported, unservable, OOM, ...) is
    simply absent from the result — the CostModel falls back to analytic
    pricing for it, which is the contract everywhere else too.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import api as mapi
    dev = resolve_device(device)
    if families is None:
        families = ["dense"] if quick else list(PROBE_FAMILY_ARCHS)
    batches = [1, 2] if quick else [1, 2, 4]
    seqs = [32, 64] if quick else [64, 128, 256]
    iters = iters if iters is not None else (2 if quick else 5)
    out: dict[str, dict] = {}
    errors: dict[str, str] = {}
    for fam in families:
        arch = PROBE_FAMILY_ARCHS.get(fam)
        if arch is None:
            errors[fam] = f"no probe arch registered for family {fam!r}"
            continue
        try:
            cfg = get_config(arch, smoke=True)
            params = mapi.init_params(
                cfg, torch.Generator(dev).manual_seed(0), dev)
            out[fam] = _probe_family_grid(cfg, params, batches, seqs, iters,
                                          dev)
        except Exception as e:      # record, don't abort the whole profile
            errors[fam] = f"{type(e).__name__}: {e}"
    if errors:
        out["_errors"] = errors
    return out


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------

def probe_kernels(*, quick: bool = False, iters: int = 3,
                  device="cuda") -> dict:
    """Per-kernel {ref_us, kernel_us, fallback_delta, rows_per_s} rows for
    every ``kernels/ops.py`` entry point, at the JAX probe's shapes (f32).

    ``kernel_us`` times the entry point under its default impl for the
    device (the CUDA kernel on a card, the plain version on the CPU);
    ``ref_us`` times the plain version.  ``fallback_delta = ref_us /
    kernel_us`` (> 1 means the kernel wins).
    """
    from repro_torch.kernels import ops, ref
    dev = resolve_device(device)
    impl = ops.default_paged_impl(dev)
    gen = torch.Generator(dev).manual_seed(0)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def row(ref_fn, kern_fn, args, rows):
        ref_s = _time_call(ref_fn, *args, device=dev, iters=iters)
        kern_s = _time_call(kern_fn, *args, device=dev, iters=iters)
        return _kernel_row(ref_s, kern_s, rows=rows, impl=impl)

    out: dict[str, dict] = {}
    # flash attention: plain layout (b, nh, s, hd); ops layout (b, s, nh, hd)
    b, s, nh, nkv, hd = (1, 32, 4, 2, 32) if quick else (1, 128, 8, 2, 64)
    qkv = (normal(b, nh, s, hd), normal(b, nkv, s, hd), normal(b, nkv, s, hd))
    out["flash_attention"] = row(
        lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
        lambda q, k, v: ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, impl=impl), qkv, rows=b * s)

    m, d = (64, 128) if quick else (512, 512)
    x, w = normal(m, d), torch.ones(d, device=dev)
    out["rms_norm"] = row(ref.rms_norm_ref,
                          lambda x, w: ops.rms_norm(x, w, impl=impl),
                          (x, w), rows=m)

    m, d, f = (64, 128, 256) if quick else (512, 512, 1024)
    mlp = (normal(m, d), normal(d, f, scale=0.05), normal(d, f, scale=0.05),
           normal(f, d, scale=0.05))
    out["swiglu"] = row(ref.swiglu_ref,
                        lambda *a: ops.swiglu(*a, impl=impl), mlp, rows=m)

    # the paged decode hot path: one block-table fixture for the four
    # paged kernels (decode attention, multi-query verify, int8-dequant
    # attention, fused layer)
    n, nkv, g, hd, bs, B = (4, 2, 2, 32, 8, 4) if quick \
        else (8, 2, 4, 64, 16, 8)
    kk, P = 3, n * B + 1
    kp, vp = normal(P, bs, nkv, hd), normal(P, bs, nkv, hd)
    qd, qv = normal(n, nkv * g, hd), normal(n, kk, nkv * g, hd)
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(
        (rng.permutation(P - 1)[: n * B] + 1).reshape(n, B)
        .astype(np.int32)).to(dev)
    lengths = torch.from_numpy(
        rng.integers(1, B * bs - kk, n).astype(np.int32)).to(dev)

    out["paged_attention"] = row(
        ref.paged_attention_ref,
        lambda *a: ops.paged_attention(*a, impl=impl),
        (qd, kp, vp, tables, lengths), rows=n)
    out["paged_verify"] = row(
        ref.paged_verify_ref, lambda *a: ops.paged_verify(*a, impl=impl),
        (qv, kp, vp, tables, lengths), rows=n * kk)
    kq, ksc = ref.quantize_kv(kp)
    vq, vsc = ref.quantize_kv(vp)
    out["paged_attention_quant"] = row(
        ref.paged_attention_quant_ref,
        lambda *a: ops.paged_attention_quant(*a, impl=impl),
        (qd, kq, vq, ksc, vsc, tables, lengths), rows=n)

    d = nkv * g * hd
    f = 2 * d
    args = (normal(n, d), qd, kp, vp, tables, lengths,
            normal(nkv * g * hd, d, scale=0.05),
            normal(d, scale=0.1) + 1.0, normal(d, f, scale=0.05),
            normal(d, f, scale=0.05), normal(f, d, scale=0.05))
    out["fused_decode_layer"] = row(
        ref.fused_decode_layer_ref,
        lambda *a: ops.fused_decode_layer(*a, impl=impl), args, rows=n)
    return out


def _kernel_row(ref_s: float, kern_s: float, *, rows: int,
                impl: str) -> dict:
    return {"ref_us": ref_s * 1e6, "kernel_us": kern_s * 1e6,
            "fallback_delta": ref_s / max(kern_s, 1e-12),
            "ref_rows_per_s": rows / max(ref_s, 1e-12),
            "kernel_rows_per_s": rows / max(kern_s, 1e-12),
            "default_impl": impl}


# ---------------------------------------------------------------------------
# draft-acceptance rates (speculative decode priors)
# ---------------------------------------------------------------------------

def probe_accept_rates(*, quick: bool = False, device="cuda") -> dict:
    """Measured greedy-exact draft-acceptance rate per spec-draftable
    family: a tiny spec workload with the canonical shrunk draft (the
    family's smoke arch at half depth, same vocab) through the real
    ``SpecDecodeBackend``.  ``CostModel.draft_plan`` prefers these over
    its fixed 0.8 prior.  A family whose probe fails (here: every family
    not ported yet) is simply absent, recorded in ``_errors``.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import api as mapi
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.serving.engine import InferenceEngine
    dev = resolve_device(device)
    out: dict[str, dict] = {}
    errors: dict[str, str] = {}
    n_req, gen = (3, 6) if quick else (6, 12)
    for fam, arch in PROBE_FAMILY_ARCHS.items():
        try:
            fspec = family_spec(fam)
            if not (fspec.spec_draftable and fspec.servable):
                continue
            cfg = get_config(arch, smoke=True)
            draft_cfg = cfg.replace(n_layers=max(1, cfg.n_layers // 2),
                                    name=f"{cfg.name}-draft-probe")
            params = mapi.init_params(
                cfg, torch.Generator(dev).manual_seed(0), dev)
            draft_params = mapi.init_params(
                draft_cfg, torch.Generator(dev).manual_seed(0), dev)
            eng = InferenceEngine(cfg, params, capacity=min(4, n_req),
                                  max_seq=64, backend="spec",
                                  draft_cfg=draft_cfg,
                                  draft_params=draft_params, draft_k=3,
                                  model_name=f"accept-probe-{cfg.name}",
                                  device=dev)
            for r in range(n_req):
                prompt = np.random.default_rng(7000 + r).integers(
                    0, cfg.vocab_size, 4 + r, dtype=np.int32)
                eng.submit(prompt, gen)
            eng.run()
            s = eng.summary()
            out[fam] = {"target": cfg.name, "draft": draft_cfg.name,
                        "draft_k": 3,
                        "accept_rate": s["draft_accept_rate"],
                        "rounds": s["spec_rounds"]}
        except Exception as e:      # record, don't abort the profile
            errors[fam] = f"{type(e).__name__}: {e}"
    if errors:
        out["_errors"] = errors
    return out


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def build_facts(*, quick: bool = False,
                families: Optional[Sequence[str]] = None,
                skip_kernels: bool = False,
                skip_decode: bool = False, device="cuda") -> MachineFacts:
    """Run every probe on ``device`` and assemble one ``MachineFacts``."""
    dev = resolve_device(device)
    facts = MachineFacts(fingerprint=current_fingerprint(dev),
                         created_unix=time.time())
    facts.notes = {"quick": bool(quick), "device": str(dev)}
    facts.transfer = probe_transfer(quick=quick, device=dev)
    if not skip_decode:
        decode = probe_decode(quick=quick, families=families, device=dev)
        facts.notes["decode_errors"] = decode.pop("_errors", {})
        facts.decode = decode
        accept = probe_accept_rates(quick=quick, device=dev)
        facts.notes["accept_errors"] = accept.pop("_errors", {})
        facts.accept_rates = accept
    if not skip_kernels:
        facts.kernels = probe_kernels(quick=quick, device=dev)
    return facts
