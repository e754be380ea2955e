"""``Session`` — one resource-managed plan/execute entrypoint for
training and eval (port of ``repro.api.session``, the train and eval
half):

    session = Session(HydraConfig(n_devices=2, device_budget_bytes=6e6))
    t0 = session.submit(TrainJob(cfg, loader_0, lr=1e-3))
    plan = session.plan()            # partitions + spill placement +
    text = plan.to_json()            #   schedule estimate, JSON round-trips
    report = session.run(Plan.from_json(text))   # the planned placement

``session.run`` drives SHARP training with real compute on the session's
device, then runs eval jobs forward-only through the shard queue.  The
serving half (``ServeJob``, serve ticks between shard units), SPMD jobs,
``run_async`` and measured-cost planning (``profile``) come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import json
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.jobs import EvalJob, JobSpec, TrainJob
from repro_torch.api.plan import JobPlan, Plan, cfg_to_dict, partition_to_dict
from repro_torch.core import partitioner as pt
from repro_torch.core import scheduler as sched
from repro_torch.core import shard_graph as sg
from repro_torch.core.sharp import (HydraConfig, ModelExec, RunReport,
                                    ShardFunctions, SharpExecutor, UnitEvent)
from repro_torch.core.spilling import DeviceMemory, HostModelStore


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"


@dataclass
class SessionReport:
    """What ``Session.run`` hands back: one record per workload kind."""
    train: Optional[RunReport] = None
    evals: dict[str, dict] = field(default_factory=dict)
    unit_trace: list[tuple] = field(default_factory=list)
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
    """One resource manager for train and eval jobs on one torch device
    (``device``, CUDA unless the caller asks for the CPU)."""

    def __init__(self, hydra_cfg: Optional[HydraConfig] = None, *,
                 device="cuda", profile=None):
        if profile is not None:
            raise NotImplementedError(
                "Session(profile=...): measured-cost planning comes with "
                "the profiler slice of the port; plans are priced by the "
                "analytic cost model (profile=None)")
        self.hc = (hydra_cfg or HydraConfig()).validate()
        self.device = resolve_device(device)
        # session-owned device ledgers: SHARP promotions and
        # double-buffers charge these same objects
        self.devices = [DeviceMemory(d, self.hc.device_budget_bytes,
                                     self.hc.buffer_frac)
                        for d in range(self.hc.n_devices)]
        self._jobs: dict[str, JobSpec] = {}
        self._state: dict[str, JobState] = {}
        self._counters: dict[str, Any] = {}
        self._model_ids = itertools.count()     # SHARP model ids, never reused
        self._train_execs: dict[str, ModelExec] = {}
        self._eval_execs: dict[str, _EvalExec] = {}
        self._materialized: set[str] = set()
        self._results: dict[str, dict] = {}     # finished eval jobs
        self.unit_trace: list[tuple] = []

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    # -- submit / poll / cancel lifecycle -----------------------------------
    def submit(self, job: JobSpec) -> str:
        """Register a job; returns its id (``train-0``, ``eval-0``, ...)."""
        if not isinstance(job, (TrainJob, EvalJob)):
            raise TypeError(f"not a TrainJob or EvalJob: "
                            f"{type(job).__name__}")
        kind = job.kind
        n = self._counters.setdefault(kind, itertools.count())
        job_id = f"{kind}-{next(n)}"
        self._jobs[job_id] = job
        self._state[job_id] = JobState.PENDING
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
        if job_id in self._eval_execs:
            out.update(batches_done=self._eval_execs[job_id].batches_done)
        return out

    def cancel(self, job_id: str) -> None:
        """Withdraw a job: pending jobs never run; a running train job stops
        at its next shard-unit boundary; eval stops between batches."""
        self._require(job_id)
        if self._state[job_id] in (JobState.DONE, JobState.CANCELLED):
            return
        self._state[job_id] = JobState.CANCELLED
        if job_id in self._train_execs:
            self._train_execs[job_id].done = True

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
        return plan

    def _plan_job(self, jid: str, job: JobSpec) -> JobPlan:
        jp = JobPlan(job_id=jid, kind=job.kind, arch=cfg_to_dict(job.cfg))
        if jid in self._train_execs:
            m = self._train_execs[jid]
            partition = m.partition
            jp.host_bytes = pt.tree_bytes(m.store.params)
            jp.meta = {"epochs": m.epochs,
                       "steps_per_epoch": m.steps_per_epoch,
                       "minibatch_time_est": m.minibatch_time()}
        else:
            ev = self._eval_execs[jid]
            partition = ev.partition
            jp.host_bytes = pt.tree_bytes(ev.store.params)
            jp.meta = {"n_batches": self._jobs[jid].n_batches}
        jp.partition = partition_to_dict(partition)
        jp.max_shard_bytes = max(
            (s.param_bytes for s in partition.shards), default=0)
        return jp

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

    def _memory_split(self) -> dict:
        """One device byte budget, split: the train double-buffer
        reservation and what is left for promoted shards.  (The JAX
        package also carves out its serve jobs' KV-page cap, zero here:
        the port's session runs no serve job yet.)"""
        budget = self.hc.device_budget_bytes
        buffer_bytes = int(budget * self.hc.buffer_frac)
        return {"device_budget_bytes": budget,
                "train_buffer_bytes": buffer_bytes,
                "serve_kv_page_cap_bytes": 0,
                "shard_headroom_bytes": budget - buffer_bytes}

    # -- materialization ------------------------------------------------------
    def _materialize(self, plan: Optional[Plan] = None) -> None:
        """Build execution state (params, partitions, stores) for every
        submitted job.  With ``plan`` given, partitions come from the plan
        instead of being recomputed — the dry-run and the real run consume
        the same object."""
        for jid, job in self._jobs.items():
            if jid in self._materialized or \
                    self._state[jid] is JobState.CANCELLED:
                continue
            planned = self._planned_partition(plan, jid)
            if isinstance(job, TrainJob):
                self._train_execs[jid] = self._build_train(job, planned)
            else:
                self._eval_execs[jid] = self._build_eval(job, planned)
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
        partition = planned if planned is not None else pt.partition(
            cfg, sg.prepare_host_params(cfg, params), shard_plan,
            budget_bytes=self.hc.device_budget_bytes,
            batch=batch, seq=seq, oracle=self.hc.partition_oracle,
            buffer_frac=self.hc.buffer_frac, train=train)
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
                               device=self.device)
        fns = ShardFunctions(cfg, shard_plan, partition, ocfg)
        return _EvalExec(cfg=cfg, plan=shard_plan, partition=partition,
                         store=store, fns=fns)

    # -- execution ------------------------------------------------------------
    def run(self, plan: Optional[Plan] = None, *,
            max_units: Optional[int] = None) -> SessionReport:
        """Execute a Plan: SHARP training, then eval jobs."""
        wall0 = time.perf_counter()
        if plan is None:
            self._materialize()
        else:
            self._verify_plan_config(plan)       # before any state is built
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

        if execs:
            # train residency is rebuilt from the host stores each run
            for dm in self.devices:
                dm.resident_bytes = 0
                dm.buffered_bytes = 0
            executor = SharpExecutor(self.hc, execs, devices=self.devices)
            report.train = executor.run(max_units=max_units, on_unit=on_unit)
        for jid in train_ids:
            # don't stomp a mid-run cancel; a max_units-truncated job goes
            # back to pending (its exec state persists; run() resumes)
            self._settle(jid, done=self._train_execs[jid].done)

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

        report.unit_trace = list(self.unit_trace)
        report.wall_time = time.perf_counter() - wall0
        return report

    def _run_eval(self, jid: str) -> dict:
        """Forward-only shard-queue loop: promote, apply, drop — loss per
        batch."""
        from repro_torch.core.orchestrator import spilled_forward
        from repro_torch.data.pipeline import as_tensors
        from repro_torch.training.losses import softmax_xent
        job: EvalJob = self._jobs[jid]           # type: ignore[assignment]
        ev = self._eval_execs[jid]
        it = iter(job.dataloader)
        for _ in range(job.n_batches):
            if self._state[jid] is JobState.CANCELLED:
                break
            try:
                raw = next(it)
            except StopIteration:
                # a short dataloader ends the job with partial results
                ev.exhausted = True
                break
            batch = as_tensors(raw, self.device)
            logits, moved = spilled_forward(ev.store, ev.fns, ev.partition,
                                            batch)
            ev.bytes_moved += moved
            ev.losses.append(float(softmax_xent(logits, batch["labels"])))
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
