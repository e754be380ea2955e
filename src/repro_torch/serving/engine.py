"""Continuous-batching inference engine over a pluggable decode backend
(port of ``repro.serving.engine``).

One engine serves one loaded model on one device.  Per tick (``step()``):

  1. retire finished requests (the backend releases lanes + KV bytes),
  2. apply overload pressure (``serving/slo.py``: degrade spec drafts at
     soft, shed the lowest waiting tier at hard) and, when the queue head
     strictly outranks a running request, preempt one victim,
  3. admit queued requests in POLICY order (EDF + priority tiers +
     starvation aging by default; strict FIFO with ``policy="fifo"``)
     while the backend's byte budget allows — each group of same-length
     prompts is prefilled in ONE batched call
     (``make_prefill_into_cache``), or, with ``bucket_sizes``, each group
     of prompts padded to the same length bucket
     (``make_padded_prefill_into_cache``), and handed to the backend
     (``write_prefill``); preempted requests resume with prefill skipped,
  4. run ONE pooled decode step so every active request advances a token.

Outputs are token-identical to running each request alone.  ``submit``
and ``cancel`` behave as in the JAX package (streams, SLO fields, cancel
of queued / running / preempted requests).

Where decode state lives is the backend's concern
(``serving/backends.py``): ``SlotBackend`` (the default), ``PagedBackend``
(block-granular admission, copy-on-write prefix sharing, fp or int8
pages) or ``SpecDecodeBackend`` (speculative decoding with a draft model
over either inner).  The engine picks the backend once, from the family's
declared capabilities, as the JAX engine does: a backend the family
cannot support falls back (spec -> its inner -> slot) with a
``CapabilityFallbackWarning``, and ``summary()`` records both the
requested and the effective backend.

Tiered memory: ``tiered_kv=True`` (paged backend) demotes parked
requests' pages to host DRAM and prefetches them back before resume
(``prefetch_ticks`` ticks after the fetch starts); ``param_source`` (a
``serving.residency.ShardResidentParams``) replaces ``params``: the
weights reach the device shard by shard, ``begin_tick`` / ``end_tick``
around every step.
"""

from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models.registry import CapabilityFallbackWarning
from repro_torch.models.registry import spec as family_spec
from repro_torch.serving.backends import DecodeBackend, make_backend
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.request import Request, Status
from repro_torch.serving.slo import SLO, OverloadedError, make_policy
from repro_torch.training.train_loop import (make_padded_prefill_into_cache,
                                             make_prefill_into_cache)


def pow2_buckets(max_seq: int) -> tuple[int, ...]:
    """Power-of-two length buckets covering [1, max_seq]."""
    out, b = [], 1
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


class InferenceEngine:
    def __init__(self, cfg, params, *, capacity: int = 8,
                 max_seq: int = 256, kv_budget_bytes: Optional[int] = None,
                 window: Optional[int] = None,
                 model_name: Optional[str] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 backend: Union[str, DecodeBackend, None] = None,
                 paged: bool = False,
                 block_size: int = 16,
                 n_blocks: Optional[int] = None, ledger=None,
                 paged_impl: Optional[str] = None,
                 prefix_share: bool = True, kv_dtype: Optional[str] = None,
                 draft_cfg=None, draft_params=None, draft_k: int = 4,
                 spec_inner: Optional[str] = None,
                 verify_impl: Optional[str] = None,
                 completed_cap: Optional[int] = None,
                 policy: Union[str, object] = "slo",
                 default_slo: Optional[SLO] = None,
                 tiered_kv: bool = False, prefetch_ticks: int = 1,
                 param_source=None,
                 tok_seconds_prior: Optional[float] = None,
                 clock=time.perf_counter, device="cuda"):
        """``params``: the model's parameter tree (JAX layout, any device);
        it is moved to ``device`` and its >= 2-D layer weights are held in
        ``cfg.dtype`` (``api.prepare_params``).  ``device`` defaults to
        CUDA and raises where there is none; pass ``device="cpu"`` to
        serve on the CPU through the plain attention.  Pass
        ``param_source`` instead of ``params`` for shard-resident weights
        (it must live on ``device``).

        ``backend``: 'slot' (None, the default), 'paged' (``paged=True``
        is the legacy spelling) or 'spec', which wraps ``spec_inner``
        ('slot' by default, or 'paged') and takes ``draft_cfg`` /
        ``draft_params`` / ``draft_k`` (and ``verify_impl`` for a paged
        inner) — or a ``DecodeBackend`` instance built by the caller, used
        as is (its capacity, max_seq and device must be the engine's).

        ``bucket_sizes``: length buckets for prefill admission groups —
        prompts are right-padded to the smallest bucket that holds them,
        so prefill runs one shape per (group size, bucket).  A family
        without ``padded_prefill`` falls back to exact-length groups with
        a ``CapabilityFallbackWarning``; buckets past ``max_seq`` are
        dropped, and a prompt longer than every bucket keeps its exact
        length."""
        spec = family_spec(cfg)
        if not spec.servable:
            raise ValueError(
                f"{cfg.name} ({cfg.family}): not servable through "
                f"InferenceEngine — {spec.why_not('servable')}")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        # shard-granular residency (serving/residency.py): the source
        # assembles the device tree every tick — hot shards stay on the
        # device, cold ones stream — and `self.params` is refreshed at the
        # top of every step
        self._param_source = param_source
        if param_source is not None and params is not None:
            raise ValueError("pass params or param_source, not both")
        src_dev = getattr(param_source, "device", self.device)
        if torch.device(src_dev) != self.device:
            raise ValueError(f"param_source holds its weights for {src_dev} "
                             f"but the engine serves on {self.device}")
        self.params = (None if params is None
                       else api.prepare_params(cfg, params, self.device))
        self.model_name = model_name or cfg.name
        self.clock = clock
        self.capacity = capacity
        self.max_seq = max_seq
        self.queue = RequestQueue(clock=clock)
        self.slot_bytes = spec.decode_state_bytes(cfg, 1, max_seq)
        self._prefill = make_prefill_into_cache(cfg, window=window)
        if backend is None or isinstance(backend, str):
            self.requested_backend, effective, spec_inner = \
                self._resolve_backend(spec, backend, paged, spec_inner)
            self.backend = make_backend(
                effective, cfg, capacity, max_seq, window=window,
                kv_budget_bytes=kv_budget_bytes, ledger=ledger,
                block_size=block_size, n_blocks=n_blocks,
                paged_impl=paged_impl, prefix_share=prefix_share,
                kv_dtype=kv_dtype, verify_impl=verify_impl,
                draft_cfg=draft_cfg, draft_params=draft_params,
                draft_k=draft_k, inner=spec_inner,
                tiered=tiered_kv, prefetch_ticks=prefetch_ticks,
                device=self.device)
        else:
            self.backend = self._injected_backend(backend, paged)
            self.requested_backend = backend.name
        if bucket_sizes is not None and not spec.padded_prefill:
            warnings.warn(
                f"{cfg.name} ({cfg.family}): bucket_sizes requested but "
                f"the family does not declare padded_prefill "
                f"({spec.why_not('padded_prefill')}); falling back to "
                "exact-length admission groups", CapabilityFallbackWarning,
                stacklevel=2)
            bucket_sizes = None
        if bucket_sizes is not None:
            bucket_sizes = [b for b in bucket_sizes if 0 < b <= max_seq]
        self.bucket_sizes = (tuple(sorted(set(bucket_sizes)))
                             if bucket_sizes else None)
        self._padded_prefill = (make_padded_prefill_into_cache(
            cfg, window=window) if self.bucket_sizes else None)
        self._active: dict[int, Request] = {}       # lane -> request
        self._tokens = np.zeros((capacity, 1, 1), np.int32)
        self.completed: deque[Request] = deque(maxlen=completed_cap)
        self.completed_cap = completed_cap
        self.retired_total = 0
        self._recent_metrics: deque[dict] = deque(maxlen=32)
        self.decode_steps = 0
        self.decode_tokens = 0       # tokens from decode steps (not prefill)
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.decode_s = 0.0
        self.prefill_s = 0.0
        self.peak_concurrency = 0
        self._tok_s_ema: Optional[float] = None     # per-token decode seconds
        self._tok_s_prior = tok_seconds_prior
        # "slo" with no SLOs declared degrades EXACTLY to FIFO
        self.policy = (make_policy(policy) if isinstance(policy, str)
                       else policy)
        self.default_slo = default_slo.validate() if default_slo else None
        self.n_preempted = 0
        self.n_resumed = 0
        self.n_shed = 0
        # tiered KV (host-DRAM page demotion, serving/backends.py)
        self._tiered = bool(getattr(self.backend, "tiered", False))
        self._demote_on_preempt = self._tiered and bool(
            getattr(self.policy, "demote_on_preempt", True))
        # active lanes + parked snapshot holders: the live-request
        # concurrency one byte budget sustains
        self.peak_live_requests = 0

    def _resolve_backend(self, spec, backend, paged, spec_inner):
        """(requested, effective backend, spec inner) from the arguments
        and the family's declared capabilities, as the JAX engine resolves
        them: None means 'slot' ('paged' with the legacy ``paged=True``); a
        capability the family lacks falls back with a warning."""
        cfg = self.cfg
        if paged and backend is not None and backend != "paged":
            raise ValueError(
                f"conflicting arguments: paged=True but backend="
                f"{backend!r}; drop one of them")
        requested = backend if backend is not None else \
            ("paged" if paged else "slot")
        effective = requested
        spec_inner = spec_inner or "slot"
        if spec_inner not in ("slot", "paged"):
            raise ValueError(f"spec_inner={spec_inner!r}: the spec "
                             "backend wraps 'slot' or 'paged'")
        if requested == "spec" and not spec.spec_draftable:
            warnings.warn(
                f"{cfg.name} ({cfg.family}): speculative decode requested "
                f"but the family does not declare spec_draftable "
                f"({spec.why_not('spec_draftable')}); falling back to the "
                f"{spec_inner!r} backend", CapabilityFallbackWarning,
                stacklevel=3)
            effective = spec_inner
        if (effective == "paged"
                or (effective == "spec" and spec_inner == "paged")) \
                and not spec.paging:
            warnings.warn(
                f"{cfg.name} ({cfg.family}): paged backend requested but "
                f"the family does not declare paging "
                f"({spec.why_not('paging')}); falling back to the slot "
                "backend", CapabilityFallbackWarning, stacklevel=3)
            effective = "slot" if effective == "paged" else effective
            spec_inner = "slot"
        return requested, effective, spec_inner

    def _injected_backend(self, backend, paged: bool):
        """A ``DecodeBackend`` instance passed as ``backend=``: used as is,
        once its lanes, rows and device agree with the engine's."""
        if not isinstance(backend, DecodeBackend):
            raise TypeError(
                f"backend={backend!r}: pass a backend name ('slot', "
                "'paged', 'spec') or a DecodeBackend instance")
        if paged and backend.name != "paged":
            raise ValueError(
                "conflicting arguments: paged=True but the injected "
                f"backend is {backend.name!r}; drop one of them")
        for attr in ("capacity", "max_seq"):
            if getattr(backend, attr, None) != getattr(self, attr):
                raise ValueError(
                    f"injected {backend.name!r} backend has "
                    f"{attr}={getattr(backend, attr, None)} but the "
                    f"engine was built with {attr}={getattr(self, attr)}; "
                    "they must match — the engine sizes its token buffer "
                    "and admission checks from its own values")
        dev = getattr(backend, "device", self.device)
        if torch.device(dev) != self.device:
            raise ValueError(
                f"injected {backend.name!r} backend lives on {dev} but "
                f"the engine serves on {self.device}")
        return backend

    # -- backend introspection ------------------------------------------------
    @property
    def paged(self) -> bool:
        return self.backend.name == "paged"

    @property
    def pool(self):
        return self.backend.pool

    @property
    def budget(self):
        return self.backend.budget

    @property
    def ledger(self):
        return getattr(self.backend, "ledger", None)

    @property
    def block_size(self):
        return getattr(self.backend, "block_size", None)

    @property
    def paged_impl(self):
        return getattr(self.backend, "paged_impl", None)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               request_id: str = "", eos_id: Optional[int] = None,
               arrival_time: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[str] = None,
               max_ttft_ms: Optional[float] = None,
               stream: bool = False) -> Request:
        slo = SLO(deadline_ms=deadline_ms,
                  priority=priority if priority is not None else "normal",
                  max_ttft_ms=max_ttft_ms).merged(self.default_slo)
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      request_id=request_id, eos_id=eos_id,
                      model=self.model_name, arrival_time=arrival_time,
                      slo=slo)
        # rows written: plen at prefill + one per decode step; the final
        # generated token is sampled but never fed back into the cache
        if req.prompt_len + req.max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"prompt+generation exceeds engine max_seq={self.max_seq}")
        self.backend.admission_check(req, self._bucket(req.prompt_len))
        if self.policy.pressure(self.queued_seconds()) >= 2 \
                and hasattr(self.policy, "shed_tier"):
            waiting = [r for r in self.queue if not r.done]
            shed = self.policy.shed_tier(waiting + [req])
            if shed is not None and req.slo.tier >= shed:
                req.status = Status.REJECTED
                req.shed_reason = (
                    "hard overload: queued work exceeds "
                    f"{self.policy.hard_overload_s:.4g}s; "
                    f"{req.slo.priority!r} is the lowest waiting tier")
                self.n_shed += 1
                self._finish(req)
                raise OverloadedError(
                    f"{req.request_id}: {req.shed_reason}",
                    payload={"request_id": req.request_id,
                             "model": self.model_name,
                             "priority": req.slo.priority,
                             "queued_seconds":
                                 round(self.queued_seconds(), 3),
                             "reason": req.shed_reason})
        if stream:
            from repro_torch.serving.stream import TokenStream
            req.stream = TokenStream(req.request_id)
        return self.queue.push(req)

    # -- cancellation -------------------------------------------------------
    def cancel(self, request_id: str) -> bool:
        """Withdraw a request by id, wherever it lives (queued, preempted
        or running); lane and KV bytes release within one tick.  False
        when no live request has that id."""
        req = self.queue.find(request_id)
        if req is not None and req.status in (Status.QUEUED,
                                              Status.PREEMPTED):
            req.status = Status.CANCELLED
            return True
        for req in self._active.values():
            if req.request_id == request_id \
                    and req.status is Status.RUNNING:
                req.status = Status.CANCELLED
                return True
        return False

    def cancel_all_queued(self) -> int:
        n = 0
        for req in self.queue:
            if req.status in (Status.QUEUED, Status.PREEMPTED):
                req.status = Status.CANCELLED
                n += 1
        return n

    # -- introspection ------------------------------------------------------
    def active_requests(self) -> Sequence[Request]:
        return list(self._active.values())

    def queued_requests(self) -> Sequence[Request]:
        return list(self.queue)

    def has_work(self) -> bool:
        return bool(self._active or self.queue)

    @property
    def n_free_lanes(self) -> int:
        return self.backend.free_lanes

    def tok_seconds_estimate(self) -> float:
        """Measured per-token decode seconds (EMA); the prior (or the
        analytic 2e-10·params constant) until the first step."""
        if self._tok_s_ema is not None:
            return self._tok_s_ema
        if self._tok_s_prior is not None:
            return self._tok_s_prior
        return 2e-10 * max(self.cfg.n_active_params, 1)

    def remaining_seconds(self) -> float:
        rem = sum(r.remaining_tokens() for r in self._active.values())
        rem += sum(r.remaining_tokens()
                   + (0 if r.status is Status.PREEMPTED else r.prompt_len)
                   for r in self.queue if not r.done)
        return rem * self.tok_seconds_estimate()

    def queued_seconds(self) -> float:
        rem = sum(r.remaining_tokens()
                  + (0 if r.status is Status.PREEMPTED else r.prompt_len)
                  for r in self.queue if not r.done)
        return rem * self.tok_seconds_estimate()

    def resume_cost_seconds(self, req: Request) -> float:
        """Extra latency a preempted request pays before its next token:
        pages demoted to the host pool must prefetch back —
        ``prefetch_ticks`` engine ticks plus the resume tick, each roughly
        one pooled decode step at current occupancy.  Zero for
        device-resident snapshots (resume is a table re-attach)."""
        if not self._tiered or self.backend.demoted_blocks(req) == 0:
            return 0.0
        per_tick = self.tok_seconds_estimate() * max(1, len(self._active))
        return (self.backend.prefetch_ticks + 1) * per_tick

    def min_slack_seconds(self, now: Optional[float] = None
                          ) -> Optional[float]:
        """Tightest deadline slack across live requests, or None when
        nothing declares a deadline.  Preempted-and-demoted requests owe
        their prefetch and resume latency on top of remaining decode."""
        now = self.clock() if now is None else now
        tok_s = self.tok_seconds_estimate()
        best: Optional[float] = None
        for r in list(self._active.values()) + list(self.queue):
            if r.done:
                continue
            arrival = r.arrival_time if r.arrival_time is not None else now
            dl = (r.slo.deadline_abs(arrival)
                  if r.status is Status.RUNNING
                  else r.slo.admission_deadline(arrival))
            if not math.isfinite(dl):
                continue
            est = r.remaining_tokens() * tok_s
            if r.status is Status.QUEUED:
                est += r.prompt_len * tok_s
            elif r.status is Status.PREEMPTED:
                est += self.resume_cost_seconds(r)
            slack = dl - now - est
            best = slack if best is None else min(best, slack)
        return best

    # -- engine tick --------------------------------------------------------
    def _finish(self, req: Request) -> None:
        req.finish_time = self.clock()
        self.completed.append(req)
        self.retired_total += 1
        self._recent_metrics.append(req.metrics())
        if req.stream is not None:
            req.stream.close(req.status)

    def _retire_finished(self) -> None:
        for lane, req in list(self._active.items()):
            if req.done:
                if req.status is not Status.CANCELLED:
                    req.status = Status.FINISHED
                self.backend.release(req)
                req.slot = None
                del self._active[lane]
                self._finish(req)

    def _bucket(self, plen: int) -> int:
        """Admission group key: the smallest bucket >= plen (the exact
        length when bucketing is off or the prompt outgrows every
        bucket)."""
        if self.bucket_sizes:
            for b in self.bucket_sizes:
                if b >= plen:
                    return b
        return plen

    def _sweep_terminal_queued(self) -> None:
        """Retire queued entries that went terminal in place (cancelled or
        shed); a cancelled PREEMPTED request's snapshot is discarded."""
        for req in [r for r in self.queue
                    if r.status in (Status.CANCELLED, Status.REJECTED)]:
            self.queue.remove(req)
            if self.backend.preemptible:
                self.backend.discard_preempted(req)
            self._finish(req)

    def _admit(self) -> list[Request]:
        self._sweep_terminal_queued()
        admitted: list[Request] = []
        now = self.clock()
        # policy-ordered walk; stop at the first request that cannot take
        # a lane — skipping past a blocked head would starve it
        for req in self.policy.order(list(self.queue), now):
            if not self.backend.free_lanes:
                break
            if req.status is Status.PREEMPTED:
                if self._tiered:
                    # resume barrier: demoted pages must be back on the
                    # device before the lane re-attaches
                    state = self.backend.parked_state(req)
                    if state == "demoted":
                        # start the fetch; a failed byte reservation blocks
                        # admission AT THE HEAD (the bytes were part of
                        # this request's original reservation, so the wait
                        # is bounded by running work retiring)
                        if not self.backend.start_prefetch(req):
                            break
                        continue    # in flight; revisit next tick
                    if state == "inflight":
                        # still prefetching: others admit past it
                        self.backend.note_prefetch_wait(req)
                        continue
                # resume: the KV snapshot re-attaches, prefill is skipped,
                # decode restarts from the last generated token (its KV row
                # was never written)
                if not self.backend.resume(req):
                    break
                self.queue.remove(req)
                req.status = Status.RUNNING
                req.resume_generated = len(req.generated)
                self.n_resumed += 1
                self._tokens[req.slot, 0, 0] = req.generated[-1]
                self._active[req.slot] = req
                continue
            if not self.backend.reserve(req, self._bucket(req.prompt_len)):
                break
            self.queue.remove(req)
            req.admit_time = self.clock()
            req.status = Status.RUNNING
            admitted.append(req)
        if not admitted:
            return admitted
        # one batched prefill per same-length group — or per same-bucket
        # group when length bucketing is on (mixed plens share one padded
        # call)
        by_len: dict[int, list[Request]] = {}
        for req in admitted:
            by_len.setdefault(self._bucket(req.prompt_len), []).append(req)
        for plen, group in sorted(by_len.items()):
            states = self.backend.fresh_states(len(group), plen)
            t0 = self.clock()
            tokens = torch.from_numpy(np.stack(
                [np.pad(r.prompt, (0, plen - r.prompt_len)) for r in group]
            ).astype(np.int64)).to(self.device)
            if self.bucket_sizes:
                lengths = torch.tensor([r.prompt_len for r in group],
                                       dtype=torch.int64, device=self.device)
                logits, states = self._padded_prefill(self.params, states,
                                                      tokens, lengths)
            else:
                logits, states = self._prefill(self.params, states, tokens)
            first = torch.argmax(logits, dim=-1).cpu().numpy()  # syncs
            self.prefill_s += self.clock() - t0
            self.prefill_calls += 1
            # true prompt tokens, not the padded bucket width — keeps
            # prefill_tok_per_s comparable between bucketed and exact modes
            self.prefill_tokens += sum(r.prompt_len for r in group)
            self.backend.write_prefill(group, states)
            now = self.clock()
            for i, req in enumerate(group):
                tok = int(first[i])
                req.generated.append(tok)
                req.first_token_time = now
                if req.stream is not None:
                    req.stream.put(tok)
                self._tokens[req.slot, 0, 0] = tok
                self._active[req.slot] = req
        return admitted

    def _maybe_preempt(self) -> None:
        """Deschedule one running victim when the queue head strictly
        outranks it and is blocked on a lane, not on bytes."""
        if self.backend.free_lanes or not self.queue:
            return
        if not self.backend.preemptible \
                or not getattr(self.policy, "preempt", False):
            return
        now = self.clock()
        waiting = [r for r in self.queue if not r.done]
        if not waiting:
            return
        head = self.policy.order(waiting, now)[0]
        # bytes guard: evicting is useless when the head is blocked on
        # BYTES rather than a lane — unless eager demotion is on, which
        # frees exactly the victim's parked bytes
        if head.status is not Status.PREEMPTED \
                and not self._demote_on_preempt \
                and not self.backend.can_admit_bytes(
                    head, self._bucket(head.prompt_len)):
            return
        running = [r for r in self._active.values()
                   if r.status is Status.RUNNING and not r.done]
        victim = self.policy.pick_victim(head, running, now)
        if victim is None:
            return
        lane = victim.slot
        self.backend.preempt(victim)
        if self._demote_on_preempt:
            # a parked request stops pinning device bytes
            self.backend.demote_parked(victim)
        del self._active[lane]
        victim.slot = None
        victim.status = Status.PREEMPTED
        victim.preemptions += 1
        self.n_preempted += 1
        # rejoins the queue with its ORIGINAL arrival time/seq
        self.queue.push(victim)

    def _apply_pressure(self) -> None:
        """Overload response, in declared shed order: soft -> degrade the
        spec backend's draft model (compute only, still token-identical);
        hard -> reject the lowest-priority WAITING tier (worst ranked
        first, stopping as soon as pressure clears)."""
        press = self.policy.pressure(self.queued_seconds())
        if hasattr(self.backend, "set_degraded"):
            self.backend.set_degraded(press >= 1)
        if press < 2 or not hasattr(self.policy, "shed_tier"):
            return
        waiting = [r for r in self.queue if r.status is Status.QUEUED]
        shed = self.policy.shed_tier(waiting)
        if shed is None:
            return
        now = self.clock()
        for req in reversed(self.policy.order(waiting, now)):
            if req.slo.tier != shed:
                continue
            if self.policy.pressure(self.queued_seconds()) < 2:
                break
            req.status = Status.REJECTED
            req.shed_reason = (
                "hard overload: queued work exceeds "
                f"{self.policy.hard_overload_s:.4g}s; shed lowest waiting "
                f"tier ({req.slo.priority!r})")
            self.n_shed += 1

    def step(self) -> bool:
        """One engine tick; returns True while there is work left."""
        if self._param_source is not None and self.has_work():
            # the shard-resident param tree for this tick (hot shards are
            # already on the device; cold shards stream in)
            self.params = self._param_source.begin_tick()
        try:
            return self._step_inner()
        finally:
            if self._param_source is not None:
                self._param_source.end_tick()
                self.params = None      # streamed shards leave the device

    def _step_inner(self) -> bool:
        if self._tiered:
            self.backend.poll_prefetches()   # copies landing this tick
        self._retire_finished()
        self._apply_pressure()
        self._maybe_preempt()        # a freed lane is re-used this tick
        self._admit()
        self._retire_finished()      # single-token requests finish at prefill
        self.peak_concurrency = max(self.peak_concurrency, len(self._active))
        parked = sum(1 for r in self.queue if r.status is Status.PREEMPTED)
        self.peak_live_requests = max(self.peak_live_requests,
                                      len(self._active) + parked)
        if self._active:
            t0 = self.clock()
            ntoks = self.backend.decode(self.params, self._tokens,
                                        self._active)      # syncs
            dt = self.clock() - t0
            self.decode_s += dt
            self.decode_steps += 1
            self.decode_tokens += len(self._active)
            per_tok = dt / max(len(self._active), 1)
            self._tok_s_ema = (per_tok if self._tok_s_ema is None
                               else 0.8 * self._tok_s_ema + 0.2 * per_tok)
            self._tokens = ntoks
            for lane, req in self._active.items():
                tok = int(ntoks[lane, 0, 0])
                req.generated.append(tok)
                if req.stream is not None:
                    req.stream.put(tok)
                self.backend.advance(lane)
        return self.has_work()

    def run(self, max_steps: Optional[int] = None) -> list[Request]:
        """Drive to completion; returns requests completed during the call."""
        done_before = self.retired_total
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._retire_finished()
        return self.completed_since(done_before)

    def completed_since(self, retired_before: int) -> list[Request]:
        n = self.retired_total - retired_before
        if n <= 0:
            return []
        n = min(n, len(self.completed))
        return list(self.completed)[len(self.completed) - n:]

    def drain_completed(self) -> list[Request]:
        out = list(self.completed)
        self.completed.clear()
        return out

    def recent_metrics(self) -> list[dict]:
        return list(self._recent_metrics)

    # -- metrics ------------------------------------------------------------
    def summary(self) -> dict:
        out = {
            "model": self.model_name,
            "device": str(self.device),
            "capacity": self.capacity,
            "max_seq": self.max_seq,
            "backend": self.backend.name,
            "requested_backend": self.requested_backend,
            "paged": self.paged,
            "policy": self.policy.name,
            "preemptible": self.backend.preemptible,
            "n_preempted": self.n_preempted,
            "n_resumed": self.n_resumed,
            "n_shed": self.n_shed,
            "bucket_sizes": list(self.bucket_sizes)
                if self.bucket_sizes else None,
            "slot_bytes": self.slot_bytes,
            "kv_budget_bytes": self.backend.budget.budget_bytes,
            "kv_reserved_bytes": self.backend.budget.reserved_bytes,
            "kv_peak_bytes": self.backend.budget.peak_bytes,
            "free_lanes": self.backend.free_lanes,
            "peak_concurrency": self.peak_concurrency,
            "peak_live_requests": self.peak_live_requests,
            "n_completed": self.retired_total,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "prefill_tok_per_s": round(
                self.prefill_tokens / self.prefill_s, 1)
                if self.prefill_s else None,
            "decode_tok_per_s": round(self.decode_tokens / self.decode_s, 1)
                if self.decode_s else None,
        }
        out.update(self.backend.summary())
        if self._param_source is not None:
            out.update(self._param_source.summary())
        return out
