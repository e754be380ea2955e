"""``Session`` — one resource-managed plan/execute entrypoint for
training, serving and eval (port of ``repro.api.session``):

    session = Session(HydraConfig(n_devices=2, device_budget_bytes=6e6))
    t0 = session.submit(TrainJob(cfg, loader_0, lr=1e-3))
    s0 = session.submit(ServeJob(cfg, params=weights, cold=True))
    plan = session.plan()            # partitions + spill placement +
    text = plan.to_json()            #   schedule estimate, JSON round-trips
    report = session.run(Plan.from_json(text))   # the planned placement

``session.run`` drives SHARP training with real compute on the session's
device, ticking serve engines between train shard units (one device
budget, train and serve interleaved), then runs eval jobs forward-only
through the shard queue (serve ticks between their shard units too), then
drains serving.  Paged serve jobs charge their KV pages to the same
``DeviceMemory`` ledger SHARP promotions charge, and the plan carves
their worst case out of the budget before partitioning.  Cold serve jobs
keep their params spilled in the host store until the first request
promotes them — the whole tree (``residency="model"``), or shard by shard
under one cross-model LRU (``residency="shard"``).  Plans are priced by a
``profiler.CostModel``: against the measured facts of ``python -m
repro_torch.profiler`` when a fresh profile is given or found
(``profile="auto"``), else by the analytic priors.  ``run_async`` runs
the same thing on a background thread (``AsyncRun``); ``poll`` and
``submit_request`` stay live while it runs.  ``SpmdTrainJob``s train one
model over a device mesh (``_run_spmd``), after SHARP training and before
eval.

Threads and CUDA: a session's tensors name its device explicitly, and
every stream a run uses is the calling thread's current stream, read at
use (the kernels read ``torch.cuda.current_stream`` at launch); the one
side stream (``serving.paging.HostBlockPool``) is ordered against the
current stream by events recorded and waited on at use, never captured
from the thread that built it.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.api.jobs import (EvalJob, JobSpec, ServeJob, SpmdTrainJob,
                                  TrainJob)
from repro_torch.api.plan import JobPlan, Plan, cfg_to_dict, partition_to_dict
from repro_torch.core import partitioner as pt
from repro_torch.core import scheduler as sched
from repro_torch.core import shard_graph as sg
from repro_torch.core.sharp import (HydraConfig, ModelExec, RunReport,
                                    ShardFunctions, SharpExecutor, UnitEvent)
from repro_torch.core.spilling import DeviceMemory, HostModelStore, to_device
from repro_torch.profiler import CostModel, MachineFacts, load_facts
from repro_torch.profiler import DEFAULT_PATH as _PROFILE_PATH


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"


@dataclass
class SessionReport:
    """What ``Session.run`` hands back: one record per workload kind."""
    train: Optional[RunReport] = None
    serve: dict[str, dict] = field(default_factory=dict)
    evals: dict[str, dict] = field(default_factory=dict)
    spmd: dict[str, dict] = field(default_factory=dict)
    unit_trace: list[tuple] = field(default_factory=list)
    serve_trace: list[str] = field(default_factory=list)
    wall_time: float = 0.0


@dataclass
class _EvalExec:
    """Forward-only execution state for one EvalJob."""
    cfg: Any
    plan: sg.ShardPlan
    partition: pt.PartitionResult
    store: HostModelStore
    fns: ShardFunctions
    losses: list = field(default_factory=list)
    batches_done: int = 0
    bytes_moved: int = 0
    exhausted: bool = False      # dataloader ran dry before n_batches


class Session:
    """One resource manager for train, serve and eval jobs on one torch
    device (``device``, CUDA unless the caller asks for the CPU)."""

    def __init__(self, hydra_cfg: Optional[HydraConfig] = None, *,
                 device="cuda", profile: Any = "auto"):
        self.hc = (hydra_cfg or HydraConfig()).validate()
        self.device = resolve_device(device)
        # measured-cost planning (repro_torch.profiler): ``profile`` is
        # "auto" (load results/profile_latest_torch.json when present and
        # fresh), None (force analytic pricing), a path, or a MachineFacts.
        # The CostModel prices partitions, the schedule estimate, serve
        # per-token priors and the spec-draft auto-pick; with no facts it
        # reproduces the analytic constants byte-identically and tags
        # every answer source="analytic" in plan provenance.  Facts change
        # estimates, never execution.
        allow_stale = False
        if profile is None:
            facts = None
        elif isinstance(profile, MachineFacts):
            # an explicit facts object is a deliberate choice — the what-if
            # case prices against another machine's profile on purpose
            facts, allow_stale = profile, True
        elif profile == "auto":
            facts = load_facts(_PROFILE_PATH, missing_ok=True)
        elif isinstance(profile, str):
            facts = load_facts(profile)
        else:
            raise TypeError(
                f"profile={profile!r}: pass 'auto', None, a profile JSON "
                "path, or a MachineFacts")
        self.cost = CostModel(facts, allow_stale=allow_stale)
        # session-owned device ledgers: SHARP promotions, double-buffers
        # and paged serving KV reservations all charge these same objects,
        # so one byte budget arbitrates mixed train + serve residency
        self.devices = [DeviceMemory(d, self.hc.device_budget_bytes,
                                     self.hc.buffer_frac)
                        for d in range(self.hc.n_devices)]
        self._jobs: dict[str, JobSpec] = {}
        self._state: dict[str, JobState] = {}
        self._counters: dict[str, Any] = {}
        self._model_ids = itertools.count()     # SHARP model ids, never reused
        self._pick = sched.get_scheduler(self.hc.scheduler, seed=self.hc.seed)
        self._train_execs: dict[str, ModelExec] = {}
        self._engines: dict[str, Any] = {}      # job_id -> InferenceEngine
        self._eval_execs: dict[str, _EvalExec] = {}
        self._cold: dict[str, dict] = {}        # job_id -> spilled state
        self._serve_names: dict[str, str] = {}  # routing name -> job_id
        self._materialized: set[str] = set()
        self._results: dict[str, dict] = {}     # finished spmd/eval jobs
        self._async_run: Optional["AsyncRun"] = None
        # serializes engine construction / promotion against the run
        # thread: run_async advertises live submit_request, which may
        # lazily build an engine while serve_tick walks the engine dict
        self._engine_lock = threading.Lock()
        # capped ring: a session serving forever must not grow its tick
        # trace without bound
        self.serve_trace: deque[str] = deque(maxlen=4096)
        self.unit_trace: list[tuple] = []
        # cross-model weight-residency LRU (serving/residency.py), built
        # at the first shard-resident serve job: a device-0 ledger
        # pressure handler, so idle models' hot shards leave the device
        # when another charge needs the bytes
        self._residency = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    # -- submit / poll / cancel lifecycle -----------------------------------
    def submit(self, job: JobSpec) -> str:
        """Register a job; returns its id (``train-0``, ``serve-1``, ...)."""
        if not isinstance(job, (TrainJob, ServeJob, EvalJob, SpmdTrainJob)):
            raise TypeError(f"not a TrainJob, ServeJob, EvalJob or "
                            f"SpmdTrainJob: {type(job).__name__}")
        name = None
        if isinstance(job, ServeJob):       # validate before registering
            if job.backend == "spec" and (job.draft_model == "auto"
                                          or job.draft_k == "auto"):
                # measured-cost backend selection: pick draft_model /
                # draft_k from draft-vs-target step times BEFORE draft
                # validation; the choice record lands in plan meta
                choice = self.cost.draft_plan(
                    job.cfg,
                    draft_cfg=(None if job.draft_model == "auto"
                               else job.draft_model),
                    draft_k=(None if job.draft_k == "auto"
                             else job.draft_k))
                job.draft_model = choice.draft_cfg
                job.draft_k = choice.draft_k
                job._draft_auto = choice.record     # read by _serve_meta
            job.resolved_buckets()          # fail fast on a bad bucket spec
            job.requested_backend()         # ... and on a bad backend name
            job.resolved_policy()           # ... and on a bad policy/knobs
            job.default_slo()               # ... and on nonsensical SLOs
            job.validate_tiering()          # ... and on tiering misuse
            if job.params_from is not None:
                src = self._jobs.get(job.params_from)
                if not isinstance(src, TrainJob):
                    have = sorted(j for j, s in self._jobs.items()
                                  if isinstance(s, TrainJob))
                    raise ValueError(
                        f"params_from={job.params_from!r}: not a TrainJob "
                        f"in this session (have {have}); submit the train "
                        "job first, then the serve job that inherits its "
                        "weights")
            name = job.name or job.cfg.name
            if name in self._serve_names:
                raise ValueError(
                    f"serve routing name {name!r} already taken by "
                    f"{self._serve_names[name]}; give replicas distinct "
                    "ServeJob.name values")
        kind = job.kind
        n = self._counters.setdefault(kind, itertools.count())
        job_id = f"{kind}-{next(n)}"
        self._jobs[job_id] = job
        self._state[job_id] = JobState.PENDING
        if name is not None:
            self._serve_names[name] = job_id
        return job_id

    def jobs(self) -> dict[str, JobSpec]:
        return dict(self._jobs)

    def poll(self, job_id: str) -> dict:
        """Status + per-kind progress for one job."""
        job = self._require(job_id)
        out: dict[str, Any] = {"job_id": job_id, "kind": job.kind,
                               "status": self._state[job_id].value}
        if job_id in self._train_execs:
            m = self._train_execs[job_id]
            out.update(losses_seen=len(m.losses), epoch=m.epoch,
                       minibatch=m.minibatch, done=m.done,
                       stopped_early=m.stopped_early)
        if isinstance(job, ServeJob):
            # effective backend/capabilities — a capability fallback must
            # be visible to pollers, not just a one-time warning
            from repro_torch.models.registry import spec as family_spec
            spec = family_spec(job.cfg)
            out.update(backend=job.effective_backend(),
                       requested_backend=job.requested_backend(),
                       capabilities=spec.capabilities())
        if job_id in self._engines:
            eng = self._engines[job_id]
            # retired_total, not len(completed): a completed cap evicts
            # old entries, the counter survives
            out.update(backend=eng.backend.name,
                       n_completed=eng.retired_total,
                       n_active=len(eng.active_requests()),
                       n_queued=len(eng.queued_requests()),
                       policy=eng.policy.name,
                       n_preempted=eng.n_preempted,
                       n_resumed=eng.n_resumed,
                       n_shed=eng.n_shed,
                       recent_requests=eng.recent_metrics())
            # tiered-memory gauges, only where the engine reports them
            s = eng.summary()
            out.update({k: s[k] for k in
                        ("residency", "n_hot_shards", "hot_resident_bytes",
                         "stream_promoted_bytes", "kv_demoted_bytes",
                         "kv_prefetched_bytes", "prefetch_hit_rate",
                         "peak_live_requests") if k in s})
        if job_id in self._cold:
            out.update(cold=True, promoted="engine" in self._cold[job_id])
        if job_id in self._eval_execs:
            out.update(batches_done=self._eval_execs[job_id].batches_done)
        return out

    def cancel(self, job_id: str) -> None:
        """Withdraw a job: pending jobs never run; a running train job stops
        at its next shard-unit boundary; a serve job drops its queue (active
        requests finish their in-flight tokens); eval stops between
        batches."""
        self._require(job_id)
        if self._state[job_id] in (JobState.DONE, JobState.CANCELLED):
            return
        self._state[job_id] = JobState.CANCELLED
        # free the routing name so a replacement ServeJob can claim it
        self._serve_names = {n: j for n, j in self._serve_names.items()
                             if j != job_id}
        if job_id in self._train_execs:
            self._train_execs[job_id].done = True
        if job_id in self._engines:
            # queued entries retire at the next admission pass without
            # being reserved or prefilled; active requests finish
            self._engines[job_id].cancel_all_queued()

    def _settle(self, job_id: str, *, done: bool) -> None:
        """Post-run state transition that never overwrites a cancel: done
        jobs finish, truncated ones return to pending (run() resumes them)."""
        if self._state[job_id] is JobState.CANCELLED:
            return
        self._state[job_id] = JobState.DONE if done else JobState.PENDING

    def _require(self, job_id: str) -> JobSpec:
        if job_id not in self._jobs:
            raise KeyError(f"no job {job_id!r} (have {sorted(self._jobs)})")
        return self._jobs[job_id]

    def _active(self, cls) -> list[str]:
        return [jid for jid, j in self._jobs.items()
                if isinstance(j, cls)
                and self._state[jid] is not JobState.CANCELLED]

    # -- planning ------------------------------------------------------------
    def plan(self, jobs: Optional[Sequence[JobSpec]] = None) -> Plan:
        """Partition + place every submitted job; returns the serializable
        Plan that ``run`` executes.  ``jobs`` is a convenience to submit and
        plan in one call."""
        for job in jobs or ():
            self.submit(job)
        self._materialize()
        plan = Plan(hydra=dataclasses.asdict(self.hc))
        for jid, job in self._jobs.items():
            if self._state[jid] is JobState.CANCELLED:
                continue
            plan.jobs.append(self._plan_job(jid, job))
        plan.schedule = self._schedule_estimate()
        # the *why*: which measured facts (or analytic constants) priced
        # the partitions and the schedule estimate
        plan.provenance = self.cost.provenance_summary()
        return plan

    def _plan_job(self, jid: str, job: JobSpec) -> JobPlan:
        jp = JobPlan(job_id=jid, kind=job.kind, arch=cfg_to_dict(job.cfg))
        partition = None
        if jid in self._train_execs:
            m = self._train_execs[jid]
            partition = m.partition
            jp.host_bytes = pt.tree_bytes(m.store.params)
            jp.meta = {"epochs": m.epochs,
                       "steps_per_epoch": m.steps_per_epoch,
                       "minibatch_time_est": m.minibatch_time()}
        elif jid in self._eval_execs:
            ev = self._eval_execs[jid]
            partition = ev.partition
            jp.host_bytes = pt.tree_bytes(ev.store.params)
            jp.meta = {"n_batches": self._jobs[jid].n_batches}
        elif jid in self._cold:
            partition = self._cold[jid]["partition"]
            jp.host_bytes = pt.tree_bytes(self._cold[jid]["store"].params)
            jp.meta = self._serve_meta(job, cold=True)
        elif isinstance(job, ServeJob):
            # warm: meta derives from the spec alone — no engine needed
            jp.meta = self._serve_meta(job, cold=False)
        elif isinstance(job, SpmdTrainJob):
            jp.meta = {"steps": job.steps, "batch": job.batch,
                       "seq": job.seq, "accum": job.accum,
                       "mesh": str(job.mesh), "optimizer": job.optimizer}
        if partition is not None:
            jp.partition = partition_to_dict(partition)
            jp.max_shard_bytes = max(
                (s.param_bytes for s in partition.shards), default=0)
        return jp

    def _serve_meta(self, job: ServeJob, *, cold: bool) -> dict:
        from repro_torch.models.registry import spec as family_spec
        spec = family_spec(job.cfg)
        # mirror the engine's capability fallbacks: the plan records the
        # EFFECTIVE backend, never a capability the family's spec does not
        # declare, plus why each fallback happened
        buckets = job.resolved_buckets() if spec.padded_prefill else None
        backend = job.effective_backend()
        fallbacks = {}
        if job.requested_backend() != backend:
            cap = ("spec_draftable" if job.requested_backend() == "spec"
                   else "paging")
            fallbacks["backend"] = spec.why_not(cap)
        if job.bucket_sizes is not None and not spec.padded_prefill:
            fallbacks["bucket_sizes"] = spec.why_not("padded_prefill")
        meta = {"capacity": job.capacity, "max_seq": job.max_seq,
                "kv_budget_bytes": job.kv_budget_bytes,
                "slot_bytes": spec.decode_state_bytes(job.cfg, 1,
                                                      job.max_seq),
                "bucket_sizes": list(buckets) if buckets else None,
                "cold": cold,
                "stream": job.stream,
                "endpoint": job.endpoint,
                "backend": backend,
                "requested_backend": job.requested_backend(),
                "capabilities": spec.capabilities(),
                "capability_fallbacks": fallbacks,
                "policy": job.resolved_policy().name,
                "slo_defaults": (None if job.default_slo() is None else {
                    "deadline_ms": job.deadline_ms,
                    "priority": job.priority,
                    "max_ttft_ms": job.max_ttft_ms}),
                "residency": job.residency,
                "params_from": job.params_from,
                # the per-token seconds the engine's SLO slack / TTFT math
                # starts from, and where the number came from
                "cost": {
                    "tok_seconds_est": self.cost.tok_seconds(
                        job.cfg, job.max_seq),
                    "source": ("measured"
                               if self.cost.has_decode_facts(job.cfg)
                               else "analytic")}}
        if job.residency == "shard":
            meta["hot_bytes"] = job.hot_bytes
        meta["paged"] = backend == "paged"
        if backend == "paged":
            from repro_torch.serving.paging import blocks_for_rows
            block_bytes = spec.kv_block_bytes(job.cfg, job.block_size,
                                              job.kv_dtype)
            per_req = blocks_for_rows(job.max_seq, job.block_size)
            meta.update(
                block_size=job.block_size,
                kv_dtype=job.kv_dtype or "fp",
                block_bytes=block_bytes,
                max_blocks_per_request=per_req,
                # worst case every lane pinned at max_seq — the cap the
                # plan's memory split charges against the device budget
                kv_page_cap_bytes=job.capacity * per_req * block_bytes,
                prefix_share=job.prefix_share,
                shared_ledger=job.kv_budget_bytes is None,
                tiered_kv=job.tiered_kv,
                prefetch_ticks=job.prefetch_ticks)
        if backend == "spec":
            draft_spec = family_spec(job.draft_model)
            meta.update(
                spec_inner=job.effective_spec_inner(),
                draft_model=job.draft_model.name,
                draft_k=job.draft_k,
                # non-None iff the session auto-picked the draft spec
                draft_auto=getattr(job, "_draft_auto", None),
                # draft state rides the same ledger as the target's KV
                # (sized for max_seq + the k-row verify headroom)
                draft_state_bytes=draft_spec.decode_state_bytes(
                    job.draft_model, 1, job.max_seq + job.draft_k),
                shared_ledger=job.kv_budget_bytes is None)
        return meta

    def _schedule_estimate(self) -> dict:
        """Compute-only makespan estimate from the same greedy list scheduler
        the executor uses (transfers excluded — the dry-run's lower bound)."""
        unit_times = []
        for jid in self._active(TrainJob):
            if jid not in self._train_execs:
                continue
            m = self._train_execs[jid]
            chain = [s.fwd_runtime for s in m.partition.shards] + \
                [s.bwd_runtime for s in reversed(m.partition.shards)]
            unit_times.append(chain * (m.epochs * m.steps_per_epoch))
        est = None
        if unit_times:
            est = sched.greedy_list_makespan(
                unit_times, self.hc.n_devices,
                scheduler=sched.get_scheduler(self.hc.scheduler,
                                              seed=self.hc.seed))
        return {"scheduler": self.hc.scheduler,
                "n_devices": self.hc.n_devices,
                "est_makespan_s": est,
                "n_train_units": sum(len(u) for u in unit_times),
                "memory": self._memory_split()}

    def _serve_kv_cap(self) -> int:
        """Worst-case bytes the session's shared-ledger serve jobs can
        reserve — paged KV pages (every lane pinned at max_seq) plus, for
        speculative jobs, the draft model's decode state and the k-row
        verify headroom — the slice of the device budget the partitioner
        must leave for decode state."""
        from repro_torch.models.registry import spec as family_spec
        from repro_torch.serving.paging import blocks_for_rows
        cap = 0
        for jid in self._active(ServeJob):
            job = self._jobs[jid]
            if job.kv_budget_bytes is not None:
                continue                 # private ledger, not this budget
            backend = job.effective_backend()
            if backend == "paged":
                cap += (job.capacity
                        * blocks_for_rows(job.max_seq, job.block_size)
                        * family_spec(job.cfg).kv_block_bytes(
                            job.cfg, job.block_size))
            elif backend == "spec":
                rows = job.max_seq + job.draft_k
                if job.effective_spec_inner() == "paged":
                    target = (job.capacity
                              * blocks_for_rows(rows, job.block_size)
                              * family_spec(job.cfg).kv_block_bytes(
                                  job.cfg, job.block_size))
                else:
                    target = job.capacity * family_spec(
                        job.cfg).decode_state_bytes(job.cfg, 1, rows)
                draft = job.capacity * family_spec(
                    job.draft_model).decode_state_bytes(
                        job.draft_model, 1, rows)
                cap += target + draft
        return cap

    def _memory_split(self) -> dict:
        """One device byte budget, split: train double-buffer reservation,
        the worst-case serve KV-page cap (shared-ledger paged jobs), and
        what is left for promoted shards.  Mirrors execution exactly:
        ``_spill_setup`` partitions against ``budget - kv_cap`` and the
        partitioner carves ``buffer_frac`` of THAT, so the buffer term
        here is computed on the reduced budget too."""
        budget = self.hc.device_budget_bytes
        kv_cap = self._serve_kv_cap()
        buffer_bytes = int((budget - kv_cap) * self.hc.buffer_frac)
        return {"device_budget_bytes": budget,
                "train_buffer_bytes": buffer_bytes,
                "serve_kv_page_cap_bytes": kv_cap,
                "shard_headroom_bytes": budget - buffer_bytes - kv_cap}

    # -- materialization ------------------------------------------------------
    def _materialize(self, plan: Optional[Plan] = None,
                     only: Optional[str] = None) -> None:
        """Build execution state (params, partitions, stores, engines) for
        every submitted job — or just ``only``.  With ``plan`` given,
        partitions come from the plan instead of being recomputed — the
        dry-run and the real run consume the same object."""
        for jid, job in self._jobs.items():
            if only is not None and jid != only:
                continue
            if jid in self._materialized or \
                    self._state[jid] is JobState.CANCELLED:
                continue
            planned = self._planned_partition(plan, jid)
            if isinstance(job, TrainJob):
                self._train_execs[jid] = self._build_train(job, planned)
            elif isinstance(job, EvalJob):
                self._eval_execs[jid] = self._build_eval(job, planned)
            elif isinstance(job, ServeJob):
                if not job.cold and job.params_from is None and only is None:
                    # a warm engine (params + device-resident decode state)
                    # is execution state a plan does not need — engine()
                    # builds it lazily at the first request or at run()
                    continue
                self._build_serve(jid, job, planned)
            # SpmdTrainJob materializes nothing up front (the run lays its
            # params out over the mesh)
            self._materialized.add(jid)

    def _verify_plan_config(self, plan: Plan) -> None:
        """Cheap checks that must run BEFORE materializing from the plan —
        rejecting a foreign plan must not leave its partitions behind as
        session state."""
        # normalize both sides through JSON so a disk-reloaded plan (str
        # dict keys, lists for tuples) compares equal to a live one
        mine = json.loads(json.dumps(dataclasses.asdict(self.hc)))
        theirs = json.loads(json.dumps(plan.hydra))
        if theirs != mine:
            diff = sorted(k for k in set(mine) | set(theirs)
                          if mine.get(k) != theirs.get(k))
            raise ValueError(
                f"plan/session divergence: HydraConfig differs on {diff} — "
                "the plan's schedule estimate would not describe this "
                "session's execution; replan under the session's config")
        planned_ids = {jp.job_id for jp in plan.jobs}
        missing = [jid for jid, st in self._state.items()
                   if st is not JobState.CANCELLED
                   and jid not in planned_ids]
        if missing:
            raise ValueError(
                f"plan/session divergence: session jobs {missing} are not "
                "in the plan — replan so every job's placement is planned, "
                "not silently recomputed")

    def _verify_plan_partitions(self, plan: Plan) -> None:
        """Post-materialization check: every planned partition must match
        the materialized one shard-for-shard (structurally: a pilot pass
        overwrites measured runtimes in place)."""
        def skeleton(p):
            return [(s.index, s.seg_lo, s.seg_hi) for s in p.shards]

        for jp in plan.jobs:
            if jp.partition is None or jp.job_id not in self._jobs:
                continue
            live = None
            if jp.job_id in self._train_execs:
                live = self._train_execs[jp.job_id].partition
            elif jp.job_id in self._eval_execs:
                live = self._eval_execs[jp.job_id].partition
            elif jp.job_id in self._cold:
                live = self._cold[jp.job_id]["partition"]
            if live is not None and skeleton(jp.shards()) != skeleton(live):
                raise ValueError(
                    f"plan/session divergence for {jp.job_id}: the plan's "
                    "partition does not match the materialized one — replan "
                    "or rebuild the session from this plan")

    def _planned_partition(self, plan: Optional[Plan],
                           jid: str) -> Optional[pt.PartitionResult]:
        if plan is None:
            return None
        try:
            jp = plan.job(jid)
        except KeyError:
            return None
        if jp.arch["name"] != self._jobs[jid].cfg.name:
            raise ValueError(
                f"plan/job mismatch for {jid}: plan is for "
                f"{jp.arch['name']!r}, session has "
                f"{self._jobs[jid].cfg.name!r}")
        return jp.shards() if jp.partition is not None else None

    def _init_params(self, job) -> Any:
        from repro_torch.models import api as mapi
        if job.params is not None:
            return job.params
        return mapi.init_params(
            job.cfg, torch.Generator(self.device).manual_seed(job.seed),
            self.device)

    def _spill_setup(self, cfg, params, *, batch: int, seq: int,
                     train: bool, planned=None):
        """Shared partition + store + shard-fns construction."""
        shard_plan = sg.build_plan(cfg)
        # shards are sized against the budget MINUS the serve KV-page cap:
        # pages charge the same ledger promotions do, so a shard planned
        # for the full budget would overrun the ledger mid-run whenever
        # serve admission is active between its units
        kv_cap = self._serve_kv_cap()
        budget = self.hc.device_budget_bytes - kv_cap
        if budget <= 0:
            raise ValueError(
                f"paged serve jobs reserve {kv_cap} B of KV "
                f"pages, leaving no shard headroom in the "
                f"{self.hc.device_budget_bytes} B device budget — shrink "
                "ServeJob capacity/max_seq or give them kv_budget_bytes")
        if planned is not None:
            return shard_plan, planned
        with tracing.span("hydra.partition", model=cfg.name):
            partition = pt.partition(
                cfg, sg.prepare_host_params(cfg, params), shard_plan,
                budget_bytes=budget,
                batch=batch, seq=seq, oracle=self.hc.partition_oracle,
                buffer_frac=self.hc.buffer_frac, train=train,
                cost_model=self.cost, device=self.device)
        return shard_plan, partition

    def _build_train(self, job: TrainJob, planned) -> ModelExec:
        cfg = job.cfg
        params = self._init_params(job)
        shard_plan, partition = self._spill_setup(
            cfg, params, batch=job.batch, seq=job.seq, train=True,
            planned=planned)
        ocfg = job.opt_config()
        store = HostModelStore(cfg, shard_plan, params, ocfg, partition,
                               device=self.device)
        fns = ShardFunctions(cfg, shard_plan, partition, ocfg)
        # monotonic, never reused: a cancel between materializations must
        # not make a later job collide with an existing exec's id (RunReport
        # keys losses by model_id)
        return ModelExec(
            model_id=next(self._model_ids), cfg=cfg, plan=shard_plan,
            partition=partition, store=store, fns=fns,
            data_iter=iter(job.dataloader), epochs=job.epochs,
            steps_per_epoch=job.steps_per_epoch, early_stop=job.early_stop)

    def _build_eval(self, job: EvalJob, planned) -> _EvalExec:
        from repro_torch.optim import optimizers as opt
        cfg = job.cfg
        params = self._init_params(job)
        shard_plan, partition = self._spill_setup(
            cfg, params, batch=job.batch, seq=job.seq, train=False,
            planned=planned)
        ocfg = opt.OptimizerConfig(grad_clip=0.0)
        store = HostModelStore(cfg, shard_plan, params, ocfg, partition,
                               device=self.device, train=False)
        fns = ShardFunctions(cfg, shard_plan, partition, ocfg)
        return _EvalExec(cfg=cfg, plan=shard_plan, partition=partition,
                         store=store, fns=fns)

    def _build_serve(self, jid: str, job: ServeJob, planned) -> None:
        from repro_torch.optim import optimizers as opt
        if job.params_from is not None:
            # train-then-serve: this job serves straight out of the TRAIN
            # job's host store.  Promotion waits (cold) until the weights
            # exist; _promote_cold enforces the ordering.
            tjid = job.params_from
            if tjid not in self._train_execs:
                self._materialize(only=tjid)
            m = self._train_execs[tjid]
            self._cold[jid] = {"store": m.store, "partition": m.partition,
                               "params_from": tjid,
                               "promote_bytes": 0, "promote_s": 0.0}
            return
        params = self._init_params(job)
        if not job.cold:
            self._engines[jid] = self._make_engine(job, params)
            return
        # cold: params stay spilled in the host store; the partition
        # records the promotion plan, the first request executes it
        shard_plan, partition = self._spill_setup(
            job.cfg, params, batch=1, seq=job.max_seq, train=False,
            planned=planned)
        store = HostModelStore(job.cfg, shard_plan, params,
                               opt.OptimizerConfig(grad_clip=0.0), partition,
                               device=self.device, train=False)
        self._cold[jid] = {"store": store, "partition": partition,
                           "promote_bytes": 0, "promote_s": 0.0}

    def _make_engine(self, job: ServeJob, params, *, param_source=None):
        """Backend selection happens ONCE here: the engine resolves the
        job's requested backend through the FamilySpec registry, and the
        session hands it one ledger choice — no capability branches at
        call sites."""
        from repro_torch.serving.engine import InferenceEngine
        kw: dict[str, Any] = {}
        if param_source is not None:
            kw.update(param_source=param_source)
        if self.cost.has_decode_facts(job.cfg):
            # measured per-token prior: slack / TTFT estimates start from
            # this host's probed decode rate instead of the analytic
            # constant (the EMA takes over after the first real step)
            kw.update(tok_seconds_prior=self.cost.tok_seconds(
                job.cfg, job.max_seq))
        effective = job.effective_backend()
        if effective == "spec":
            from repro_torch.models import api as mapi
            draft_params = job.draft_params
            if draft_params is None:
                draft_params = mapi.init_params(
                    job.draft_model,
                    torch.Generator(self.device).manual_seed(job.draft_seed),
                    self.device)
            kw.update(draft_cfg=job.draft_model, draft_params=draft_params,
                      draft_k=job.draft_k,
                      spec_inner=job.resolved_spec_inner(),
                      block_size=job.block_size,
                      prefix_share=job.prefix_share,
                      kv_dtype=job.kv_dtype,
                      verify_impl=job.resolved_verify_impl())
            if job.kv_budget_bytes is None:
                # target KV (verify headroom included) AND draft state
                # charge the session's device-0 ledger — the budget SHARP
                # promotions charge
                kw.update(ledger=self.devices[0])
            else:
                kw.update(kv_budget_bytes=job.kv_budget_bytes)
        elif effective == "paged":
            kw.update(block_size=job.block_size,
                      prefix_share=job.prefix_share,
                      kv_dtype=job.kv_dtype,
                      tiered_kv=job.tiered_kv,
                      prefetch_ticks=job.prefetch_ticks)
            if job.kv_budget_bytes is None:
                # pages charge the session's device-0 ledger — the budget
                # SHARP promotions charge — unless the job pins a private
                # cap
                kw.update(ledger=self.devices[0])
            else:
                kw.update(kv_budget_bytes=job.kv_budget_bytes)
        else:
            kw.update(kv_budget_bytes=job.kv_budget_bytes)
        return InferenceEngine(
            job.cfg, params, capacity=job.capacity, max_seq=job.max_seq,
            window=job.window, model_name=job.name or job.cfg.name,
            backend=job.requested_backend(),
            bucket_sizes=job.resolved_buckets(),
            policy=job.resolved_policy(), default_slo=job.default_slo(),
            device=self.device, **kw)

    def _promote_cold(self, jid: str) -> None:
        """First request for a cold model: promote its shards out of the
        host store (core/spilling byte accounting) and build the engine.
        The copy is asynchronous on a card: it is timed after a
        synchronize.  ``residency='shard'`` skips the whole-tree move: the
        engine gets a ``ShardResidentParams`` source instead, and
        residency is decided tick by tick (hot + streamed shards)."""
        cold = self._cold[jid]
        job: ServeJob = self._jobs[jid]          # type: ignore[assignment]
        store, partition = cold["store"], cold["partition"]
        tjid = cold.get("params_from")
        if tjid is not None and not self._train_execs[tjid].done:
            raise RuntimeError(
                f"{jid}: params_from={tjid!r} has not finished training — "
                "its weights do not exist to serve yet; run() trains "
                "before draining serve requests")
        if job.residency == "shard":
            from repro_torch.serving.residency import (ResidencyCoordinator,
                                                       ShardResidentParams)
            if self._residency is None:
                self._residency = ResidencyCoordinator(self.devices[0])
            src = ShardResidentParams(
                job.cfg, store, partition, self.devices[0],
                hot_bytes=job.hot_bytes, name=job.name or job.cfg.name)
            self._residency.register(src)
            cold["residency"] = src
            cold["engine"] = self._engines[jid] = self._make_engine(
                job, None, param_source=src)
            return
        t0 = time.perf_counter()
        # the transfer itself is the single to_device below; the spilling
        # store's per-shard accounting prices it shard by shard
        moved = sum(store.shard_transfer_bytes(s, train=False)
                    for s in partition.shards)
        params = to_device(store.model_params(), self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        cold["promote_bytes"] = moved
        cold["promote_s"] = time.perf_counter() - t0
        cold["engine"] = self._engines[jid] = self._make_engine(job, params)

    # -- serving surface ------------------------------------------------------
    def engine(self, target: str):
        """The live engine for a serve job id or routing name (promotes a
        cold model if needed)."""
        jid = self._serve_names.get(target, target)
        job = self._require(jid)
        if not isinstance(job, ServeJob):
            raise TypeError(f"{jid} is a {job.kind} job, not serve")
        with self._engine_lock:      # one engine constructor at a time
            if jid not in self._materialized:
                # just this job: answering a serve request must not force
                # param init / partitioning for every pending train job
                self._materialize(only=jid)
            if jid not in self._engines:
                self._promote_cold(jid)
            return self._engines[jid]

    def submit_request(self, target: str, prompt, max_new_tokens: int, **kw):
        """Enqueue one generation request on a serve job (by id or name)."""
        jid = self._serve_names.get(target, target)
        self._require(jid)
        if self._state[jid] is JobState.CANCELLED:
            raise ValueError(f"{jid} is cancelled")
        return self.engine(jid).submit(prompt, max_new_tokens, **kw)

    def cancel_request(self, request_id: str,
                       target: Optional[str] = None) -> bool:
        """Withdraw ONE generation request (vs. ``cancel``, which withdraws
        a whole job).  Queued requests retire unreserved at the next
        admission pass; a running one frees its lane and KV reservation at
        the next tick.  ``target`` narrows the search to one serve job (id
        or routing name); otherwise every live engine is asked."""
        if target is not None:
            return self.engine(target).cancel(request_id)
        with self._engine_lock:
            engines = list(self._engines.values())
        return any(eng.cancel(request_id) for eng in engines)

    def serve_has_work(self) -> bool:
        with self._engine_lock:
            engines = list(self._engines.values())
        return any(e.has_work() for e in engines)

    def serve_tick(self) -> Optional[str]:
        """One serving tick: the session's scheduling policy picks which
        model's engine steps (LRTF keeps the model with the most outstanding
        tokens moving).  Returns the model name stepped, or None if idle.

        Not delegated to ``MultiModelServer``: that wrapper snapshots its
        engine dict at construction, while a session's engine set grows
        mid-run as cold models promote."""
        with self._engine_lock:      # snapshot: an engine may be added now
            engines = list(self._engines.items())
        eligible = [(jid, eng) for jid, eng in engines if eng.has_work()]
        if not eligible:
            return None
        progress = [sched.ModelProgress.from_remaining(
            i, eng.remaining_seconds())
            for i, (_, eng) in enumerate(eligible)]
        _, eng = eligible[self._pick(progress)]
        eng.step()
        self.serve_trace.append(eng.model_name)
        return eng.model_name

    def drain_serving(self, max_ticks: Optional[int] = None) -> int:
        ticks = 0
        while self.serve_tick() is not None:
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return ticks

    # -- execution ------------------------------------------------------------
    def run_async(self, plan: Optional[Plan] = None, *,
                  max_units: Optional[int] = None) -> "AsyncRun":
        """``run`` on a background executor thread, returning immediately.

        ``poll(job_id)`` stays live while the run is in flight (execution
        state is mutated in place), so callers can watch training epochs
        advance or serve queues drain and keep submitting requests against
        running serve jobs.  One run at a time: a second ``run_async``
        before the first finishes raises.
        """
        self._guard_single_run()
        self._async_run = AsyncRun(self, plan, max_units)
        return self._async_run

    def _guard_single_run(self) -> None:
        """Two executors over the same stores/ledgers/data iterators would
        silently corrupt each other — refuse, whether the other run is the
        async handle's or another thread's plain run()."""
        if self._async_run is not None and not self._async_run.done():
            raise RuntimeError(
                "a session run is already in flight; wait on its handle "
                "(AsyncRun.result) before starting another")

    def run(self, plan: Optional[Plan] = None, *,
            max_units: Optional[int] = None) -> SessionReport:
        """Execute a Plan: SHARP training with serve ticks between shard
        units, then eval jobs (serve ticks between their shard units),
        then the serving drain."""
        self._guard_single_run()
        return self._run_impl(plan, max_units)

    def _run_impl(self, plan: Optional[Plan],
                  max_units: Optional[int]) -> SessionReport:
        wall0 = time.perf_counter()
        # under the engine lock: a concurrent submit_request during an
        # async run materializes lazily via engine(), and two builders for
        # one job would double-init params and clobber cold-serve state
        with self._engine_lock:
            if plan is None:
                self._materialize()
            else:
                self._verify_plan_config(plan)   # before any state is built
                self._materialize(plan)
                self._verify_plan_partitions(plan)
        report = SessionReport()

        train_ids = [jid for jid in self._active(TrainJob)
                     if jid in self._train_execs]
        execs = sorted((self._train_execs[j] for j in train_ids),
                       key=lambda m: m.model_id)
        for jid in train_ids:
            self._state[jid] = JobState.RUNNING

        def on_unit(ev: UnitEvent):
            self.unit_trace.append(ev.key())
            self.serve_tick()        # serve jobs tick between shard units

        if execs:
            # train residency is rebuilt from the host stores each run;
            # live KV-page reservations (in-flight serve requests) persist
            for dm in self.devices:
                dm.resident_bytes = 0
                dm.buffered_bytes = 0
            executor = SharpExecutor(self.hc, execs, devices=self.devices)
            report.train = executor.run(max_units=max_units, on_unit=on_unit)
        for jid in train_ids:
            # don't stomp a mid-run cancel; a max_units-truncated job goes
            # back to pending (its exec state persists; run() resumes)
            self._settle(jid, done=self._train_execs[jid].done)

        for jid in self._active(SpmdTrainJob):
            if self._state[jid] is JobState.DONE:    # resumed run(): done
                report.spmd[jid] = self._results[jid]   # jobs don't re-run
                continue
            self._state[jid] = JobState.RUNNING
            report.spmd[jid] = self._results[jid] = _run_spmd(
                self._jobs[jid], self.device)
            self._settle(jid, done=True)

        for jid in self._active(EvalJob):
            if jid not in self._eval_execs:
                continue
            if self._state[jid] is JobState.DONE:
                report.evals[jid] = self._results[jid]
                continue
            self._state[jid] = JobState.RUNNING
            report.evals[jid] = self._results[jid] = self._run_eval(jid)
            ev = self._eval_execs[jid]
            self._settle(jid, done=ev.exhausted or ev.batches_done
                         >= self._jobs[jid].n_batches)

        self.drain_serving()
        for jid in self._active(ServeJob):
            if jid not in self._engines and jid not in self._cold:
                self.engine(jid)     # run() brings warm engines live
            eng = self._engines.get(jid)
            rec: dict[str, Any] = {}
            if eng is not None:
                rec = dict(eng.summary())
                rec["requests"] = [r.metrics() for r in eng.completed]
            if jid in self._cold:
                rec.update(cold=True,
                           promote_bytes=self._cold[jid]["promote_bytes"],
                           promote_s=round(self._cold[jid]["promote_s"], 4))
                if eng is None:
                    rec.update(promoted=False)   # never received a request
            report.serve[jid] = rec
            self._settle(jid, done=True)

        report.unit_trace = list(self.unit_trace)
        report.serve_trace = list(self.serve_trace)
        report.wall_time = time.perf_counter() - wall0
        return report

    def _run_eval(self, jid: str) -> dict:
        """Forward-only shard-queue loop: promote, apply, drop — loss per
        batch, serve ticks between shard units."""
        from repro_torch.core.orchestrator import spilled_forward
        from repro_torch.data.pipeline import as_tensors
        from repro_torch.training.losses import softmax_xent
        job: EvalJob = self._jobs[jid]           # type: ignore[assignment]
        ev = self._eval_execs[jid]
        it = iter(job.dataloader)
        for _ in range(job.n_batches):
            if self._state[jid] is JobState.CANCELLED:
                break
            with tracing.span("hydra.eval_batch", batch=ev.batches_done):
                try:
                    with tracing.span("hydra.data"):
                        batch = as_tensors(next(it), self.device)
                except StopIteration:
                    # a short dataloader ends the job with partial results
                    ev.exhausted = True
                    break
                logits, moved = spilled_forward(
                    ev.store, ev.fns, ev.partition, batch,
                    on_shard=lambda _s: self.serve_tick())
                ev.bytes_moved += moved
                with tracing.span("hydra.loss"):
                    ev.losses.append(
                        float(softmax_xent(logits, batch["labels"])))
                ev.batches_done += 1
        mean = float(np.mean(ev.losses)) if ev.losses else None
        return {"losses": ev.losses,
                "mean_loss": mean,
                "perplexity": float(np.exp(mean)) if mean is not None
                else None,
                "n_shards": len(ev.partition.shards),
                "bytes_moved": ev.bytes_moved}

    # -- introspection for thin wrappers -------------------------------------
    @property
    def train_execs(self) -> list[ModelExec]:
        """ModelExecs ordered by model_id (ModelOrchestrator compat)."""
        self._materialize()
        return sorted(self._train_execs.values(), key=lambda m: m.model_id)


class AsyncRun:
    """Handle for a background ``Session.run`` (``Session.run_async``).

    ``done()`` is non-blocking; ``result(timeout)`` joins the executor
    thread and either returns the ``SessionReport`` or re-raises whatever
    the run raised — a failed background run never disappears silently.
    """

    def __init__(self, session: Session, plan: Optional[Plan],
                 max_units: Optional[int]):
        self._report: Optional[SessionReport] = None
        self._exc: Optional[BaseException] = None

        def _main():
            try:
                # _run_impl, not run(): the single-run guard would see THIS
                # handle as the in-flight run and refuse its own execution
                self._report = session._run_impl(plan, max_units)
            except BaseException as e:          # re-raised in result()
                self._exc = e

        self._thread = threading.Thread(
            target=_main, name="hydra-session-run", daemon=True)
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> SessionReport:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"session run still executing after {timeout} s")
        if self._exc is not None:
            raise self._exc
        assert self._report is not None
        return self._report


# ---------------------------------------------------------------------------
# SPMD execution (the mesh substrate; launch/train.py is a shell over this)
# ---------------------------------------------------------------------------

def _make_mesh(job: SpmdTrainJob, device):
    """The job's mesh over the process group ``launch.mesh`` starts for
    ``device`` (NCCL on the card, gloo on the CPU)."""
    from repro_torch.launch.mesh import (ensure_process_group, make_mesh,
                                         make_production_mesh, world_size)
    if not isinstance(job.mesh, str):
        return job.mesh
    if job.mesh == "production":
        return make_production_mesh(multi_pod=job.multi_pod, device=device)
    ensure_process_group(device)
    n = world_size()
    if n == 1:
        return make_mesh((1, 1), ("data", "model"), device)
    nd = max(1, n // 2)
    return make_mesh((nd, n // nd), ("data", "model"), device)


def _run_spmd(job: SpmdTrainJob, device) -> dict:
    """Single-model training over a mesh: params and optimizer state laid
    out by ``sharding.specs``, every rank drawing the same batches (the
    step keeps each rank's rows).  Rank 0 alone prints the log lines and
    saves the checkpoints — in the JAX package's format, from the full
    tensors, so either package restores them."""
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           make_dataset)
    from repro_torch.models import api
    from repro_torch.models.registry import spec as family_spec
    from repro_torch.optim.optimizers import OptimizerConfig, init_state
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.context import activation_axes
    from repro_torch.training import make_train_step

    cfg = job.cfg
    mesh = _make_mesh(job, device)
    if device.type == "cuda" and device.index is None:
        # this rank's GPU by index: the prefetch thread's current device
        # is its own
        device = torch.device("cuda", torch.cuda.current_device())
    lead = dist.get_rank() == 0
    ocfg = OptimizerConfig(kind=job.optimizer, lr=job.lr,
                           schedule="linear_warmup_cosine",
                           warmup_steps=max(job.steps // 20, 1),
                           total_steps=job.steps)

    params = api.init_params(
        cfg, torch.Generator(device).manual_seed(job.seed), device)
    params = sh.distribute(mesh, params, sh.param_specs(cfg, params, mesh))
    opt_state = init_state(ocfg, params)      # zeros in the params' layout

    data_cfg = DataConfig(batch_size=job.batch, seq_len=job.seq,
                          vocab_size=cfg.vocab_size, seed=job.seed,
                          path=job.data)
    if not family_spec(cfg).token_stream_data:
        # audio/vlm batches carry embeddings the token pipeline can't make
        def synth():
            i = 0
            while True:
                yield api.make_dummy_batch(
                    cfg, job.batch, job.seq,
                    generator=torch.Generator(device).manual_seed(i),
                    device=device)
                i += 1
        it = synth()
    else:
        it = iter(Prefetcher(iter(make_dataset(data_cfg)), depth=2,
                             device=device))

    step_fn = make_train_step(cfg, ocfg, accum_steps=job.accum, mesh=mesh)

    def save(step):
        full = sh.full_tensors(params)        # every rank gathers
        if lead:
            ckpt.save(f"{job.ckpt_dir}/step_{step}", full, step=step)
        dist.barrier()

    history = []
    t0 = time.perf_counter()
    with activation_axes(mesh, moe_shardmap=False):
        for step in range(job.steps):
            batch = next(it)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % job.log_every == 0 or step == job.steps - 1:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                tok_s = job.batch * job.seq * (step + 1) / dt
                if lead:
                    print(f"step {step:5d}  loss {loss:8.4f}  "
                          f"gnorm {float(metrics['grad_norm']):7.3f}  "
                          f"{tok_s:9.0f} tok/s")
                history.append({"step": step, "loss": loss})
            if job.ckpt_dir and step and step % job.ckpt_every == 0:
                save(step)
    if job.ckpt_dir:
        save(job.steps)
    return {"history": history,
            "final_loss": history[-1]["loss"] if history else None,
            "params": api.param_count(params)}
