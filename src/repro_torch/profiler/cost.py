"""``CostModel`` — one query surface for every price the planner needs
(port of ``repro.profiler.cost``, pure Python).

Each query answers exactly the question an analytic call site used to
answer inline, and records *how* it answered in ``self.provenance``:

* ``shard_runtimes``       — the partitioner's initial per-shard runtime
  estimates (``core/partitioner.py``); analytic fallback reproduces
  ``flops_weight × param_bytes × 1e-12`` byte-identically.
* ``tok_seconds``          — the per-token decode prior; analytic fallback
  is ``2e-10 × n_active_params``, measured answers interpolate the probe
  grid.  ``Session`` reads it for a serve job's plan meta and engine
  prior, and the serving engine starts its SLO estimates from it.
* ``prefill_seconds`` / ``decode_step_seconds`` — TTFT-style estimates
  over the measured (batch, seq) grid.
* ``transfer_seconds``     — host↔device movement cost from the measured
  bandwidth rows (latency + bytes/bw fit).
* ``hardware``             — the roofline constants via
  ``facts.hardware_constants``.
* ``draft_plan``           — auto-pick ``draft_model``/``draft_k`` for
  speculative decoding from measured draft-vs-target step times.

Monotonicity: measured grids are clamped to a running max along both
axes before interpolation, so *more tokens are never cheaper* even when
a noisy probe says otherwise; bilinear interpolation preserves that
ordering between grid points and clamps flat beyond the grid.

Everything recorded in ``provenance`` is JSON-primitive (str/int/float/
list/dict), so a Plan carrying it round-trips byte-identically.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.profiler.facts import (ANALYTIC_HARDWARE, MachineFacts,
                                        StaleProfileWarning,
                                        hardware_constants)

# the two analytic priors the CostModel must reproduce byte-identically
# when unprofiled — planning constants, the JAX package's own, so that
# unprofiled plans equal its plans (see core/partitioner.py)
ANALYTIC_SHARD_SECONDS_PER_WEIGHTED_BYTE = 1e-12
ANALYTIC_TOK_SECONDS_PER_PARAM = 2e-10


def _monotone_grid(grid: list[list[float]]) -> list[list[float]]:
    """Running max along both axes: more batch / more seq never cheaper."""
    out = [list(row) for row in grid]
    for i in range(len(out)):
        for j in range(len(out[i])):
            if i > 0:
                out[i][j] = max(out[i][j], out[i - 1][j])
            if j > 0:
                out[i][j] = max(out[i][j], out[i][j - 1])
    return out


def _interp_1d(xs: list[float], x: float) -> tuple[int, int, float]:
    """Clamped segment + fraction for piecewise-linear interpolation."""
    if x <= xs[0]:
        return 0, 0, 0.0
    if x >= xs[-1]:
        return len(xs) - 1, len(xs) - 1, 0.0
    for i in range(len(xs) - 1):
        if xs[i] <= x <= xs[i + 1]:
            span = xs[i + 1] - xs[i]
            return i, i + 1, (x - xs[i]) / span if span else 0.0
    return len(xs) - 1, len(xs) - 1, 0.0


def _bilinear(batches: list[float], seqs: list[float],
              grid: list[list[float]], b: float, s: float) -> float:
    i0, i1, fb = _interp_1d(batches, b)
    j0, j1, fs = _interp_1d(seqs, s)
    top = grid[i0][j0] * (1 - fs) + grid[i0][j1] * fs
    bot = grid[i1][j0] * (1 - fs) + grid[i1][j1] * fs
    return top * (1 - fb) + bot * fb


@dataclass
class DraftChoice:
    """What ``draft_plan`` picked and why (plan-meta friendly)."""
    draft_cfg: Any
    draft_k: int
    record: dict


class CostModel:
    """Measured-when-possible, analytic-otherwise pricing with provenance."""

    def __init__(self, facts: Optional[MachineFacts] = None, *,
                 allow_stale: bool = False):
        """``allow_stale=True`` keeps a fingerprint-mismatched profile —
        the what-if case (pricing against another machine's facts on
        purpose); the default drops it with a warning so nothing silently
        plans with wrong numbers."""
        if facts is not None and not allow_stale and facts.is_stale():
            warnings.warn(
                "CostModel given stale MachineFacts (fingerprint mismatch); "
                "falling back to analytic pricing", StaleProfileWarning,
                stacklevel=2)
            facts = None
        self.facts = facts
        self.provenance: dict[str, dict] = {}
        # monotone-clamped interpolation tables, built once per family
        self._decode_tables: dict[str, dict] = {}

    # -- bookkeeping --------------------------------------------------------
    @property
    def measured(self) -> bool:
        return self.facts is not None

    def _note(self, key: str, source: str, value: float, **detail) -> None:
        rec = {"source": source, "value": value}
        rec.update(detail)
        self.provenance[key] = rec

    def provenance_summary(self) -> dict:
        """The Plan's ``provenance`` block: which facts priced what."""
        srcs = [r.get("source") for r in self.provenance.values()]
        return {
            "profile": None if self.facts is None else {
                "created_unix": self.facts.created_unix,
                "fingerprint": dict(self.facts.fingerprint),
                "decode_families": sorted(self.facts.decode),
            },
            "n_measured": srcs.count("measured"),
            "n_analytic": srcs.count("analytic"),
            "queries": dict(self.provenance),
        }

    # -- decode/prefill grids -----------------------------------------------
    def _family_table(self, cfg) -> Optional[dict]:
        """Monotone interpolation table for the cfg's family, scaled to the
        cfg's active-param count relative to the probed arch."""
        if self.facts is None:
            return None
        rec = self.facts.decode.get(cfg.family)
        if not rec:
            return None
        t = self._decode_tables.get(cfg.family)
        if t is None:
            batches = [float(b) for b in rec["batches"]]
            seqs = [float(s) for s in rec["seqs"]]
            step = _monotone_grid(rec["decode_step_s"])
            # prefill: monotone in TOTAL seconds (per-token cost may
            # legitimately fall with batch; total work may not)
            pre_total = _monotone_grid(
                [[rec["prefill_s_per_token"][i][j] * batches[i] * seqs[j]
                  for j in range(len(seqs))] for i in range(len(batches))])
            t = {"batches": batches, "seqs": seqs, "step": step,
                 "prefill_total": pre_total,
                 "probe_arch": rec.get("arch"),
                 "probe_params": max(1, int(rec.get("n_active_params", 1)))}
            self._decode_tables[cfg.family] = t
        return t

    def has_decode_facts(self, cfg) -> bool:
        return self._family_table(cfg) is not None

    def _scale(self, cfg, table: dict) -> float:
        return max(1, cfg.n_active_params) / table["probe_params"]

    def decode_step_seconds(self, cfg, batch: int, seq: int) -> float:
        """Seconds for one pooled decode step at (batch, seq)."""
        t = self._family_table(cfg)
        key = f"decode_step:{cfg.name}"
        if t is None:
            val = ANALYTIC_TOK_SECONDS_PER_PARAM \
                * max(1, cfg.n_active_params) * batch
            self._note(key, "analytic", val, batch=batch, seq=seq)
            return val
        val = _bilinear(t["batches"], t["seqs"], t["step"],
                        float(batch), float(seq)) * self._scale(cfg, t)
        self._note(key, "measured", val, batch=batch, seq=seq,
                   probe_arch=t["probe_arch"], family=cfg.family)
        return val

    def prefill_seconds(self, cfg, batch: int, seq: int) -> float:
        """Seconds to prefill ``batch`` prompts of ``seq`` tokens."""
        t = self._family_table(cfg)
        key = f"prefill:{cfg.name}"
        if t is None:
            val = ANALYTIC_TOK_SECONDS_PER_PARAM \
                * max(1, cfg.n_active_params) * batch * seq
            self._note(key, "analytic", val, batch=batch, seq=seq)
            return val
        val = _bilinear(t["batches"], t["seqs"], t["prefill_total"],
                        float(batch), float(seq)) * self._scale(cfg, t)
        self._note(key, "measured", val, batch=batch, seq=seq,
                   probe_arch=t["probe_arch"], family=cfg.family)
        return val

    def tok_seconds(self, cfg, max_seq: int = 256) -> float:
        """Per-token decode seconds — the engine's pre-EMA prior and the
        scheduler's TTFT/slack multiplier in the JAX package."""
        t = self._family_table(cfg)
        key = f"tok_seconds:{cfg.name}"
        if t is None:
            val = ANALYTIC_TOK_SECONDS_PER_PARAM * max(1, cfg.n_active_params)
            self._note(key, "analytic", val)
            return val
        val = _bilinear(t["batches"], t["seqs"], t["step"],
                        1.0, float(max_seq)) * self._scale(cfg, t)
        self._note(key, "measured", val, max_seq=max_seq,
                   probe_arch=t["probe_arch"], family=cfg.family)
        return val

    # -- partitioner runtimes -----------------------------------------------
    def shard_runtimes(self, cfg, weights: list[float], *,
                       batch: int, seq: int) -> list[tuple[float, float]]:
        """Per-shard (fwd, bwd) runtime estimates for the partitioner.

        ``weights`` are the shards' ``flops_weight × param_bytes`` sums —
        the exact quantity the historical analytic estimate multiplied by
        1e-12.  Measured facts distribute a probed whole-model forward
        over the shards by the same weights, keeping relative shard order
        (what Sharded-LRTF ranks on) while fixing the absolute scale.
        """
        key = f"partition:{cfg.name}"
        t = self._family_table(cfg)
        if t is None:
            out = [(w * ANALYTIC_SHARD_SECONDS_PER_WEIGHTED_BYTE,
                    2 * (w * ANALYTIC_SHARD_SECONDS_PER_WEIGHTED_BYTE))
                   for w in weights]
            self._note(key, "analytic",
                       sum(f + b for f, b in out),
                       n_shards=len(weights), batch=batch, seq=seq)
            return out
        total_fwd = self.prefill_seconds(cfg, batch, seq)
        wsum = sum(weights) or 1.0
        out = [(total_fwd * w / wsum, 2 * total_fwd * w / wsum)
               for w in weights]
        self._note(key, "measured", sum(f + b for f, b in out),
                   n_shards=len(weights), batch=batch, seq=seq,
                   total_fwd_s=total_fwd, probe_arch=t["probe_arch"])
        return out

    # -- transfers + roofline constants --------------------------------------
    def transfer_seconds(self, nbytes: int, direction: str = "h2d") -> float:
        """Host↔device movement time for ``nbytes`` (latency + bw fit)."""
        key = f"transfer:{direction}"
        rows = (self.facts.transfer.get(direction)
                if self.facts is not None else None)
        if not rows:
            val = nbytes / ANALYTIC_HARDWARE["h2d_bw"]
            self._note(key, "analytic", val, nbytes=nbytes)
            return val
        rows = sorted(rows, key=lambda r: r["bytes"])
        lat = rows[0]["seconds"]
        big = rows[-1]
        if big["bytes"] > rows[0]["bytes"] and big["seconds"] > lat:
            bw = (big["bytes"] - rows[0]["bytes"]) / (big["seconds"] - lat)
        else:
            bw = big["bytes"] / max(big["seconds"], 1e-12)
        val = lat + nbytes / max(bw, 1.0)
        self._note(key, "measured", val, nbytes=nbytes,
                   fitted_bw_bytes_s=bw, latency_s=lat)
        return val

    def hardware(self) -> dict:
        """Roofline constants (+ source tag) through the facts schema."""
        hw = hardware_constants(self.facts)
        self._note("hardware", hw["source"],
                   hw["peak_flops_bf16"], **{
                       k: v for k, v in hw.items() if k != "source"})
        return hw

    # -- speculative-decode auto-pick -----------------------------------------
    def draft_plan(self, target_cfg, draft_cfg=None,
                   draft_k: Optional[int] = None,
                   accept_prior: float = 0.8,
                   max_k: int = 8) -> DraftChoice:
        """Pick ``draft_model``/``draft_k`` from draft-vs-target step times.

        With acceptance probability α per drafted token (greedy-exact
        acceptance), a round of k drafts yields E = (1-α^(k+1))/(1-α)
        tokens and costs k draft steps plus one batched target verify, so
        expected throughput is E / (k·t_draft + t_target) — maximized
        over candidates × k.  α prefers the machine profile's MEASURED
        per-family acceptance rate (``probe_accept_rates``); the fixed
        ``accept_prior`` is the provenance-tagged fallback for hosts that
        never probed (or probed before the probe existed).
        """
        t_target = self.tok_seconds(target_cfg)
        src = "measured" if self.has_decode_facts(target_cfg) else "analytic"
        accept_src, accept_meta = "prior", None
        if self.facts is not None:
            rec = (self.facts.accept_rates or {}).get(target_cfg.family)
            if rec and rec.get("accept_rate") is not None:
                accept_prior = float(rec["accept_rate"])
                accept_src = "measured"
                accept_meta = {k: rec.get(k)
                               for k in ("target", "draft", "draft_k",
                                         "rounds")}

        if draft_cfg is not None and draft_cfg != "auto":
            candidates = [draft_cfg]
        else:
            candidates = self._draft_candidates(target_cfg)
        ks = [draft_k] if isinstance(draft_k, int) else \
            list(range(1, max_k + 1))

        def expected_tokens(k: int) -> float:
            a = accept_prior
            return (1 - a ** (k + 1)) / (1 - a) if a < 1 else k + 1

        best = None
        considered = []
        for cand in candidates:
            t_draft = self.tok_seconds(cand)
            for k in ks:
                tput = expected_tokens(k) / (k * t_draft + t_target)
                considered.append({"draft": cand.name, "k": k,
                                   "tok_per_s": tput})
                if best is None or tput > best[0]:
                    best = (tput, cand, k, t_draft)
        assert best is not None
        _, cand, k, t_draft = best
        rec = {"source": src, "draft_model": cand.name, "draft_k": k,
               "t_target_s": t_target, "t_draft_s": t_draft,
               "accept_prior": accept_prior,
               "accept_source": accept_src,
               "accept_probe": accept_meta,
               "expected_tok_per_s": best[0],
               "n_candidates": len(candidates)}
        self.provenance[f"draft:{target_cfg.name}"] = rec
        return DraftChoice(draft_cfg=cand, draft_k=k, record=rec)

    def _draft_candidates(self, target_cfg) -> list:
        """Spec-draftable, vocab-compatible, no-bigger-than-target configs:
        registered archs first, then a shrunk clone of the target, then the
        target itself (self-draft — always valid)."""
        from repro_torch.configs import ARCH_REGISTRY, SMOKE_REGISTRY
        from repro_torch.models.registry import spec as family_spec
        out = []
        seen = set()
        for reg in (ARCH_REGISTRY, SMOKE_REGISTRY):
            for cfg in reg.values():
                if cfg.name in seen or cfg.name == target_cfg.name:
                    continue
                seen.add(cfg.name)
                if cfg.vocab_size != target_cfg.vocab_size:
                    continue
                if cfg.n_active_params > target_cfg.n_active_params:
                    continue
                if not family_spec(cfg).spec_draftable:
                    continue
                out.append(cfg)
        if family_spec(target_cfg).spec_draftable:
            if target_cfg.n_layers > 1:
                out.append(target_cfg.replace(
                    name=f"{target_cfg.name}-draft",
                    n_layers=max(1, target_cfg.n_layers // 4)))
            out.append(target_cfg)     # self-draft: the always-valid floor
        if not out:
            raise ValueError(
                f"no spec-draftable draft candidate shares "
                f"{target_cfg.name}'s vocab ({target_cfg.vocab_size}); pass "
                "draft_model=<ArchConfig> explicitly")
        return out
