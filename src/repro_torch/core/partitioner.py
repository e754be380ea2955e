"""Automated model partitioning (paper §4.3, Algorithm 1), port of
``repro.core.partitioner``.

Greedy, dynamic: pack the longest prefix of remaining segments that fits
the device memory budget.  Two fitting oracles:

* ``analytic`` (default) — a memory cost model over the segment's actual
  param trees: params + grads + optimizer state + boundary activations +
  recompute workspace.  Its figures are decisions, not measurements: for
  the same config, params and budget they are the JAX package's byte for
  byte.
* ``probe`` — the paper's "pilot run".  Where the JAX package compiles
  the candidate shard's forward+backward and reads XLA's
  ``memory_analysis()``, the port runs it: zero-filled params, entry
  activation and batch of the shapes and dtypes SHARP's units hold, the
  chain forward, then its backward — from zero cotangents of its exit as
  in the JAX package, and from the loss for a chain that ends the model,
  as SHARP's last backward unit runs it (the JAX chain stops at the
  logits, and the loss's backward sets that unit's peak).  The peak is
  the caching allocator's own count on a card
  (``max_memory_allocated`` over ``memory_allocated`` before the pilot),
  and on the CPU a live-bytes count of every storage the pilot makes
  (``LiveBytes``).  The fitting rule is the JAX package's word for word.
  A pilot that runs out of device memory does not fit; any other error
  propagates (the JAX package reports every exception as "does not
  fit").

The partitioner also records per-shard pilot *runtimes* (analytic or
profiled priors; the SHARP executor's pilot pass measures them) — these
feed Sharded-LRTF exactly as in the paper.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.core import shard_graph as sg
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class Shard:
    index: int
    seg_lo: int                    # [seg_lo, seg_hi) into plan.segments
    seg_hi: int
    param_bytes: int = 0
    act_bytes: int = 0
    est_runtime: float = 0.0       # seconds, fwd+bwd (pilot)
    fwd_runtime: float = 0.0
    bwd_runtime: float = 0.0

    @property
    def n_segments(self) -> int:
        return self.seg_hi - self.seg_lo


@dataclass
class ProbeRecord:
    """One pilot of the ``probe`` oracle: candidate ``[lo, hi)``, the peak
    the rule read (``None`` when it ran out of memory), the live-bytes
    count of the same pilot (``None`` on a card), the rule's two sides,
    and the pilot's wall seconds (0 when the peak was supplied)."""
    lo: int
    hi: int
    peak: Optional[int]
    counted: Optional[int]
    lhs: Optional[int]
    limit: float
    fits: bool
    seconds: float = 0.0


@dataclass
class PartitionResult:
    shards: list[Shard]
    shared_bytes: int
    budget_bytes: int
    oracle: str
    # the probe oracle's pilots, in the order the greedy loop ran them
    # (planning telemetry: not part of a Plan's JSON)
    probes: list[ProbeRecord] = field(default_factory=list)

    def __iter__(self):
        return iter(self.shards)

    def __len__(self):
        return len(self.shards)


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() if hasattr(x, "element_size")
               else x.nbytes for x in tree_leaves(tree))


def _act_width(cfg) -> int:
    """Bytes per (batch·seq) element of the inter-segment activation."""
    w = cfg.d_model * torch_dtype(cfg.dtype).itemsize
    if cfg.family == "audio":
        w *= 2     # decoder segments also carry the enc pass-through
    return w


def segment_cost(cfg, params, seg: sg.Segment, batch: int, seq: int,
                 *, train: bool = True) -> tuple[int, int]:
    """Returns (param_bytes, peak_act_bytes) for one segment."""
    own = sg.resolve_ref(params, seg.param_ref)
    pbytes = tree_bytes(own) if own is not None else 0
    opt_mult = 4 if train else 1        # params + grads + adam(mu, nu)
    act = batch * seq * _act_width(cfg)
    if seg.name in ("embed", "head", "frontend"):
        # head materializes logits in f32
        act = max(act, batch * seq * cfg.vocab_size * 4 // 8)  # sharded est.
    # remat inside segments: workspace ~ 4 live activation copies
    return pbytes * opt_mult, act * 4


def shared_cost(cfg, params, plan: sg.ShardPlan, *, train: bool = True) -> int:
    total = 0
    for name, ref in plan.shared_refs.items():
        total += tree_bytes(sg.resolve_ref(params, ref))
    return total * (4 if train else 1)


def analytic_fits(cfg, params, plan, lo, hi, batch, seq, budget, shared_bytes,
                  buffer_frac: float, train: bool = True) -> bool:
    total = shared_bytes
    for i in range(lo, hi):
        p, a = segment_cost(cfg, params, plan.segments[i], batch, seq,
                            train=train)
        total += p
        peak_act = a
    total += peak_act
    return total <= budget * (1.0 - buffer_frac)


# ---------------------------------------------------------------------------
# the probe oracle: one pilot forward/backward per candidate shard
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Counts the bytes of every storage an op run under it makes, until
    that storage is freed, and keeps the maximum (``peak``).  A storage
    is counted once, whatever its views; one that existed before the mode
    was entered is counted if an op writes into it."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def _freed(self, key: int, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, nbytes=nbytes: self._freed(key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self._track(t)
        return out


def _spec(a) -> torch.Tensor:
    return torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")


def _shard_param_specs(cfg, params, plan, lo, hi):
    """Meta tensors of the shard's own params (a tuple by segment) and of
    the shared groups its segments read (a dict by name): the shapes and
    dtypes of the host store's tensors."""
    own = tuple(sg.resolve_ref(params, plan.segments[i].param_ref)
                for i in range(lo, hi))
    shared_names = sorted({n for i in range(lo, hi)
                           for n in plan.segments[i].shared})
    shared = {n: sg.resolve_ref(params, plan.shared_refs[n])
              for n in shared_names}
    return tree_map(_spec, own), tree_map(_spec, shared)


def _meta(*shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_spec(cfg, batch, seq):
    """The batch a SHARP unit reads: int64 tokens and labels, as the
    port's loaders give them (``data.pipeline.as_tensors``); the audio
    family's bf16 ``enc_embeds`` (batch, encoder_len, d) beside them, and
    a family that takes embeddings bf16 ``embeds`` (batch, seq, d) in
    place of the tokens (``models.api.input_specs``)."""
    out = {"labels": _meta(batch, seq, dtype=torch.int64)}
    if cfg.family == "audio":
        out["enc_embeds"] = _meta(batch, cfg.encoder_len, cfg.d_model,
                                  dtype=torch.bfloat16)
    elif cfg.takes_embeddings:
        out["embeds"] = _meta(batch, seq, cfg.d_model, dtype=torch.bfloat16)
        return out
    out["tokens"] = _meta(batch, seq, dtype=torch.int64)
    return out


def _entry_act_spec(cfg, plan, lo, batch, seq):
    """The entry activation of a shard starting at segment ``lo``: the
    previous shard's exit, ``{"x": (batch, seq, d_model)}`` in the
    compute dtype, and for the moe family the f32 scalar aux sums
    ``{"aux": {"lb", "z"}}`` (none for the first shard).  An audio shard
    that starts at or before the bridge reads the encoder stream
    ``{"enc_x": (batch, encoder_len, d_model)}``; one that starts past it
    reads ``{"x", "enc"}``, the decoder stream and the encoder output.
    (The JAX package gives every audio shard the encoder's entry, so its
    probe finds no fit for a shard past the bridge.)"""
    if lo == 0:
        return {}
    dt = torch_dtype(cfg.dtype)
    x = _meta(batch, seq, cfg.d_model, dtype=dt)
    if cfg.family == "audio":
        enc = _meta(batch, cfg.encoder_len, cfg.d_model, dtype=dt)
        bridge = [seg.name for seg in plan.segments].index("bridge")
        return {"enc_x": enc} if lo <= bridge else {"x": x, "enc": enc}
    spec = {"x": x}
    if cfg.family == "moe":
        spec["aux"] = {k: _meta(dtype=torch.float32) for k in ("lb", "z")}
    return spec


def _pilot_fwd_bwd(cfg, plan, lo, hi, own, shared, act, batch):
    """The chain of segments ``[lo, hi)`` forward with autograd, then its
    backward: from zero cotangents of the exit activation (the JAX
    package's ``fwd_bwd``), or, for a chain that ends the model, from its
    loss, as SHARP's backward unit runs it — the loss's backward is what
    the last shard's unit holds at its peak.  Returns the gradients of
    every floating input, live at the end as they are in the unit."""
    leaves = [t for t in tree_leaves((own, shared, act))
              if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        out = act
        for k, i in enumerate(range(lo, hi)):
            seg = plan.segments[i]
            out = seg.apply(cfg, own[k], {n: shared[n] for n in seg.shared},
                            out, batch)
        if hi == len(plan.segments):
            loss = plan.loss(cfg, out, batch)
            return torch.autograd.grad(loss, leaves, torch.ones_like(loss),
                                       allow_unused=True)
        outs = [o for o in tree_leaves(out) if o.requires_grad]
        if not outs:
            return []
        return torch.autograd.grad(outs, leaves,
                                   [torch.zeros_like(o) for o in outs],
                                   allow_unused=True)


def pilot_peak(cfg, params, plan, lo, hi, batch, seq,
               device="cuda", *, count: bool = False
               ) -> tuple[int, Optional[int]]:
    """Run one pilot of candidate shard ``[lo, hi)`` on ``device``:
    returns ``(peak, counted)``.  ``counted`` is ``LiveBytes``'s peak of
    the pilot: always on the CPU, where it is also ``peak``; on a card
    only when ``count`` is asked for (it dispatches every op through
    Python), else None, and ``peak`` is the allocator's maximum over
    what was allocated before the pilot.  Every pilot adds one to
    ``pilot_peak.pilots``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    count = count or not cuda
    pilot_peak.pilots += 1
    own_spec, shared_spec = _shard_param_specs(cfg, params, plan, lo, hi)
    act_spec = _entry_act_spec(cfg, plan, lo, batch, seq)
    batch_spec = _batch_spec(cfg, batch, seq)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    counter = LiveBytes() if count else None
    with counter or contextlib.nullcontext():
        def zeros(m):
            return torch.zeros(m.shape, dtype=m.dtype, device=dev)
        grads = _pilot_fwd_bwd(cfg, plan, lo, hi, tree_map(zeros, own_spec),
                               tree_map(zeros, shared_spec),
                               tree_map(zeros, act_spec),
                               tree_map(zeros, batch_spec))
        del grads
    counted = counter.peak if count else None
    if not cuda:
        return counted, counted
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base, counted


pilot_peak.pilots = 0


def probe_fits(cfg, params, plan, lo, hi, batch, seq, budget, shared_bytes,
               buffer_frac: float, train: bool = True, *, device="cuda",
               peaks: Optional[Callable[[int, int], int]] = None,
               record: Optional[list] = None) -> bool:
    """The pilot-run oracle: the JAX package's rule over a measured peak,
    ``peak + opt_bytes + shared_bytes // 2 <= budget * (1 -
    buffer_frac)`` with ``opt_bytes`` twice the shard's own param bytes.
    ``peaks(lo, hi)``, when given, supplies the peak in place of a pilot.
    A pilot that runs out of device memory does not fit; every other
    error propagates.  Appends a ``ProbeRecord`` to ``record``."""
    limit = budget * (1.0 - buffer_frac)
    counted = None
    t0 = time.perf_counter()
    if peaks is not None:
        peak = peaks(lo, hi)
    else:
        try:
            peak, counted = pilot_peak(cfg, params, plan, lo, hi, batch, seq,
                                       device)
        except torch.OutOfMemoryError:
            peak = None
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if peak is None:
        lhs, fits = None, False
    else:
        opt_bytes = 2 * sum(
            tree_bytes(p) for p in
            (sg.resolve_ref(params, plan.segments[i].param_ref)
             for i in range(lo, hi)) if p is not None)
        lhs = peak + opt_bytes + shared_bytes // 2
        fits = lhs <= limit
    if record is not None:
        record.append(ProbeRecord(lo, hi, peak, counted, lhs, limit, fits,
                                  0.0 if peaks is not None
                                  else time.perf_counter() - t0))
    return fits


# ---------------------------------------------------------------------------
# Algorithm 1 (greedy dynamic partitioning)
# ---------------------------------------------------------------------------

def partition(cfg, params, plan: sg.ShardPlan, *,
              budget_bytes: int,
              batch: int, seq: int,
              oracle: str = "analytic",
              buffer_frac: float = 0.05,
              train: bool = True,
              measure: bool = False,
              measure_batch=None,
              cost_model=None,
              device=None,
              _peaks: Optional[Callable[[int, int], int]] = None
              ) -> PartitionResult:
    """Greedy prefix packing of segments into shards under ``budget_bytes``.

    ``buffer_frac`` reserves the double-buffer loading zone (paper §4.6:
    ~5% of device memory suffices since intermediates dominate and are not
    double-buffered).  ``oracle="probe"`` pilots each candidate once on
    ``device`` (CUDA unless the caller asks for the CPU); ``_peaks(lo,
    hi)`` stands in for the pilots (tests).  ``measure`` and
    ``measure_batch`` are accepted and unused, as in the JAX package.
    """
    probes: list[ProbeRecord] = []
    if oracle == "analytic":
        fits = analytic_fits
    else:
        if _peaks is None:
            device = resolve_device("cuda" if device is None else device)

        def fits(*args):
            return probe_fits(*args, device=device, peaks=_peaks,
                              record=probes)
    shared_bytes = shared_cost(cfg, params, plan, train=train)
    n = len(plan.segments)
    shards: list[Shard] = []
    lo = 0
    while lo < n:
        hi = lo + 1
        if not fits(cfg, params, plan, lo, hi, batch, seq, budget_bytes,
                    shared_bytes, buffer_frac, train):
            raise MemoryError(
                f"segment {plan.segments[lo].name} alone exceeds the device "
                f"budget ({budget_bytes/1e9:.2f} GB) — model unpartitionable")
        while hi < n and fits(cfg, params, plan, lo, hi + 1, batch, seq,
                              budget_bytes, shared_bytes, buffer_frac,
                              train):
            hi += 1
        pbytes = sum(segment_cost(cfg, params, plan.segments[i],
                                  batch, seq)[0] for i in range(lo, hi))
        abytes = max(segment_cost(cfg, params, plan.segments[i],
                                  batch, seq)[1] for i in range(lo, hi))
        shards.append(Shard(len(shards), lo, hi,
                            param_bytes=pbytes, act_bytes=abytes))
        lo = hi

    result = PartitionResult(shards, shared_bytes, budget_bytes, oracle,
                             probes)
    _assign_runtimes(cfg, params, plan, result, cost_model=cost_model,
                     batch=batch, seq=seq)
    return result


def _assign_runtimes(cfg, params, plan, result, *, cost_model=None,
                     batch: int = 2, seq: int = 128):
    """Initial runtime estimates ∝ flops_weight × param bytes.

    The SHARP executor's pilot pass (first mini-batch) overwrites these
    with measured per-shard times.  With a ``profiler.CostModel`` the same
    per-shard weights price against a measured whole-model forward instead
    of the analytic 1e-12 s/weighted-byte prior; the unprofiled CostModel
    reproduces the analytic numbers byte-identically (and records either
    way in its provenance)."""
    weights = [
        sum(plan.segments[i].flops_weight
            * max(1, sg_param_bytes(params, plan.segments[i]))
            for i in range(shard.seg_lo, shard.seg_hi))
        for shard in result.shards]
    if cost_model is not None:
        runtimes = cost_model.shard_runtimes(cfg, weights,
                                             batch=batch, seq=seq)
    else:
        runtimes = [(w * 1e-12, 2 * (w * 1e-12)) for w in weights]
    for shard, (fwd, bwd) in zip(result.shards, runtimes):
        shard.fwd_runtime = fwd
        shard.bwd_runtime = bwd
        shard.est_runtime = shard.fwd_runtime + shard.bwd_runtime


def sg_param_bytes(params, seg) -> int:
    own = sg.resolve_ref(params, seg.param_ref)
    return tree_bytes(own) if own is not None else 0
