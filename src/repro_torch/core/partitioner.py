"""Automated model partitioning (paper §4.3, Algorithm 1), port of
``repro.core.partitioner``.

Greedy, dynamic: pack the longest prefix of remaining segments that fits
the device memory budget under the ``analytic`` oracle — a memory cost
model over the segment's actual param trees: params + grads + optimizer
state + boundary activations + recompute workspace.  The figures are
decisions, not measurements: for the same config, params and budget they
are the JAX package's byte for byte.

The JAX package's ``probe`` oracle (compile a shard and read its memory
analysis) and its measured cost model come with the profiler slice of the
port and raise here.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import torch_dtype
from repro_torch.core import shard_graph as sg
from repro_torch.tree import tree_leaves


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
class PartitionResult:
    shards: list[Shard]
    shared_bytes: int
    budget_bytes: int
    oracle: str

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
    return cfg.d_model * torch_dtype(cfg.dtype).itemsize


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
# Algorithm 1 (greedy dynamic partitioning)
# ---------------------------------------------------------------------------

def partition(cfg, params, plan: sg.ShardPlan, *,
              budget_bytes: int,
              batch: int, seq: int,
              oracle: str = "analytic",
              buffer_frac: float = 0.05,
              train: bool = True,
              cost_model=None) -> PartitionResult:
    """Greedy prefix packing of segments into shards under ``budget_bytes``.

    ``buffer_frac`` reserves the double-buffer loading zone (paper §4.6:
    ~5% of device memory suffices since intermediates dominate and are not
    double-buffered).
    """
    if oracle != "analytic":
        raise NotImplementedError(
            f"partition oracle {oracle!r}: the probe oracle (XLA's compiled-"
            "memory analysis of a pilot run per candidate shard) has no "
            "port yet; it comes with a later slice of the port. Use "
            "'analytic'")
    shared_bytes = shared_cost(cfg, params, plan, train=train)
    n = len(plan.segments)
    shards: list[Shard] = []
    lo = 0
    while lo < n:
        hi = lo + 1
        if not analytic_fits(cfg, params, plan, lo, hi, batch, seq,
                             budget_bytes, shared_bytes, buffer_frac, train):
            raise MemoryError(
                f"segment {plan.segments[lo].name} alone exceeds the device "
                f"budget ({budget_bytes/1e9:.2f} GB) — model unpartitionable")
        while hi < n and analytic_fits(cfg, params, plan, lo, hi + 1, batch,
                                       seq, budget_bytes, shared_bytes,
                                       buffer_frac, train):
            hi += 1
        pbytes = sum(segment_cost(cfg, params, plan.segments[i],
                                  batch, seq)[0] for i in range(lo, hi))
        abytes = max(segment_cost(cfg, params, plan.segments[i],
                                  batch, seq)[1] for i in range(lo, hi))
        shards.append(Shard(len(shards), lo, hi,
                            param_bytes=pbytes, act_bytes=abytes))
        lo = hi

    result = PartitionResult(shards, shared_bytes, budget_bytes, oracle)
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
