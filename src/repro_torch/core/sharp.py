"""SHARP — Shard Alternator Parallelism (paper §4.4–4.6), port of
``repro.core.sharp``.

The executor interleaves *shard units* (forward or backward of one shard of
one model on one mini-batch) from many models across devices, subject to
each model's sequential dependency.  Real compute runs for every unit, on
one torch device; device parallelism is *virtualized*: each device owns a
clock, and unit/transfer durations (measured compute + modeled host-link
transfers) advance it.

A forward unit runs under ``torch.no_grad``; its output is the exit
activation, kept as the next shard's entry.  A backward unit recomputes
its shard's chain from the saved entry activation with gradients on the
promoted own and shared leaves and on the activation, and calls
``torch.autograd.grad`` with the incoming cotangent (ones for the last
shard's loss) — the recompute ``jax.vjp`` per shard does in the JAX
package.  No autograd graph outlives a unit, so the ledger's byte terms
describe what is live.

Double buffering (§4.6): when a device *starts* a unit, the scheduler
immediately picks that device's next unit and begins promoting its shard
into the reserved buffer region — the transfer overlaps compute and is
hidden iff transfer_time <= compute_time.  If the next unit is the same
model's successor on the same device, the boundary activation never moves.

Unit runtimes are measured by the pilot pass on the wall clock, around a
``torch.cuda.synchronize()`` on a CUDA device; schedules are reproducible
across runs (and across the two packages) only with
``HydraConfig.fixed_unit_runtime`` set.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import scheduler as sched
from repro_torch.core import shard_graph as sg
from repro_torch.core.partitioner import PartitionResult, Shard
from repro_torch.core.spilling import DeviceMemory, HostModelStore
from repro_torch.data.pipeline import as_tensors
from repro_torch.optim import optimizers as opt
from repro_torch.tree import tree_leaves, tree_unflatten_like


@dataclass
class HydraConfig:
    n_devices: int = 8
    device_budget_bytes: int = 11 * 10**9      # paper's RTX 2080 Ti
    buffer_frac: float = 0.05                  # double-buffer loading zone
    link_bw: float = 16e9                      # host<->device B/s (PCIe3 x16)
    enable_sharp: bool = True                  # False -> one model at a time
    enable_double_buffer: bool = True
    scheduler: str = "lrtf"
    seed: int = 0
    partition_oracle: str = "analytic"
    pilot: bool = True                         # measured pilot pass
    # deterministic simulation: pin every unit's fwd/bwd runtime to this
    # value after the pilot (real compute still runs); schedules then
    # depend only on the scheduling/transfer model
    fixed_unit_runtime: Optional[float] = None
    # elasticity (paper §4.7): device_id -> (available_from,
    # available_until) in virtual seconds; None = always available
    device_windows: Optional[dict] = None

    def validate(self) -> "HydraConfig":
        """Fail fast on configs that would otherwise die deep inside the
        partitioner or event loop.  ``Session`` calls this on entry."""
        if self.n_devices < 1:
            raise ValueError(
                f"n_devices={self.n_devices}: need at least one device")
        if self.device_budget_bytes <= 0:
            raise ValueError(
                f"device_budget_bytes={self.device_budget_bytes}: must be a "
                "positive byte count (e.g. 11*10**9 for an RTX 2080 Ti)")
        if not 0.0 < self.buffer_frac <= 0.5:
            raise ValueError(
                f"buffer_frac={self.buffer_frac}: the double-buffer loading "
                "zone must be in (0, 0.5] — the paper finds ~0.05 suffices; "
                "above 0.5 the buffer would outsize the active region")
        if self.link_bw <= 0:
            raise ValueError(
                f"link_bw={self.link_bw}: host<->device bandwidth must be "
                "positive B/s (e.g. 16e9 for PCIe3 x16)")
        if self.scheduler not in sched.SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}: choose one of "
                f"{sorted(sched.SCHEDULERS)}")
        if self.partition_oracle == "probe":
            raise NotImplementedError(
                "partition_oracle='probe' (XLA's compiled-memory analysis of "
                "a pilot run per candidate shard) has no port yet; it comes "
                "with a later slice of the port. Use 'analytic'")
        if self.partition_oracle != "analytic":
            raise ValueError(
                f"unknown partition_oracle {self.partition_oracle!r}: "
                "choose 'analytic' or 'probe'")
        return self


@dataclass
class Unit:
    model_id: int
    shard: Shard
    direction: str        # "fwd" | "bwd"
    minibatch: int
    epoch: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _requiring_grad(tree):
    """Detached copies-by-reference of ``tree``'s leaves with gradients on
    the floating ones; returns ``(tree, leaves)``."""
    leaves = [t.detach().requires_grad_(t.is_floating_point())
              for t in tree_leaves(tree)]
    return tree_unflatten_like(tree, leaves), leaves


class ShardFunctions:
    """Forward / backward / step programs per shard of one model."""

    def __init__(self, cfg, plan: sg.ShardPlan, partition: PartitionResult,
                 opt_cfg: opt.OptimizerConfig):
        self.cfg = cfg
        self.plan = plan
        self.partition = partition
        self.opt_cfg = opt_cfg

    def _chain(self, shard: Shard, own, shared, act, batch):
        for k, i in enumerate(range(shard.seg_lo, shard.seg_hi)):
            seg = self.plan.segments[i]
            seg_shared = {n: shared[n] for n in seg.shared}
            act = seg.apply(self.cfg, own[k], seg_shared, act, batch)
        return act

    def _last(self, shard: Shard) -> bool:
        return shard.index == len(self.partition.shards) - 1

    def fwd(self, shard: Shard):
        """``fwd(own, shared, act, batch) -> (exit act, loss or None)``."""
        def run(own, shared, act, batch):
            with torch.no_grad():
                out = self._chain(shard, own, shared, act, batch)
                if self._last(shard):
                    return out, self.plan.loss(self.cfg, out, batch)
                return out, None
        return run

    def bwd(self, shard: Shard):
        """The last shard: ``bwd(own, shared, act_in, batch) -> (loss,
        g_own, g_shared, g_act)``; the others: ``bwd(own, shared, act_in,
        cot_out, batch) -> (g_own, g_shared, g_act)``.  Recomputes the
        chain from ``act_in``; an input the chain does not read gets a
        zero gradient, as ``jax.vjp`` gives."""
        last = self._last(shard)

        def run(own, shared, act_in, *rest):
            cot_out, batch = (None, rest[0]) if last else rest
            (own_t, own_l), (sh_t, sh_l), (act_t, act_l) = (
                _requiring_grad(own), _requiring_grad(shared),
                _requiring_grad(act_in))
            inputs = [t for t in own_l + sh_l + act_l if t.requires_grad]
            with torch.enable_grad():
                out = self._chain(shard, own_t, sh_t, act_t, batch)
                if last:
                    loss = self.plan.loss(self.cfg, out, batch)
                    grads = torch.autograd.grad(
                        loss, inputs, torch.ones_like(loss),
                        allow_unused=True)
                else:
                    outs = tree_leaves(out)
                    grads = torch.autograd.grad(
                        outs, inputs, tree_leaves(cot_out),
                        allow_unused=True)
            grads = iter(grads)
            full = []
            for t in own_l + sh_l + act_l:
                g = next(grads) if t.requires_grad else None
                full.append(torch.zeros_like(t)
                            if g is None and t.requires_grad else g)
            n_own, n_sh = len(own_l), len(sh_l)
            g_own = tree_unflatten_like(own, full[:n_own])
            g_shared = tree_unflatten_like(shared, full[n_own:n_own + n_sh])
            g_act = tree_unflatten_like(act_in, full[n_own + n_sh:])
            if last:
                return loss.detach(), g_own, g_shared, g_act
            return g_own, g_shared, g_act

        return run

    def _step(self, own, g_own, opt_state):
        return opt.update(self.opt_cfg, own, g_own, opt_state)


@dataclass
class ModelExec:
    """Execution state of one model inside the SHARP loop."""
    model_id: int
    cfg: Any
    plan: sg.ShardPlan
    partition: PartitionResult
    store: HostModelStore
    fns: ShardFunctions
    data_iter: Any
    epochs: int
    steps_per_epoch: int
    early_stop: Optional[Callable[[list], bool]] = None
    stopped_early: bool = False
    # dynamic state
    queue: list[Unit] = field(default_factory=list)
    cursor: int = 0
    epoch: int = 0
    minibatch: int = 0
    ready_at: float = 0.0
    reserved: bool = False
    act_location: Optional[int] = None     # device holding current activation
    current_batch: Any = None
    pilot_batch: Any = None
    saved_acts: dict = field(default_factory=dict)   # shard_idx -> entry act
    saved_cot: Any = None                  # cotangent flowing backward
    losses: list = field(default_factory=list)
    done: bool = False

    def build_minibatch_queue(self):
        shards = self.partition.shards
        units = [Unit(self.model_id, s, "fwd", self.minibatch, self.epoch)
                 for s in shards]
        units += [Unit(self.model_id, s, "bwd", self.minibatch, self.epoch)
                  for s in reversed(shards)]
        self.queue = units
        self.cursor = 0
        self.current_batch = as_tensors(next(self.data_iter),
                                        self.store.device)

    def next_unit(self) -> Optional[Unit]:
        if self.done:
            return None
        if self.cursor >= len(self.queue):
            return None
        return self.queue[self.cursor]

    def minibatch_time(self) -> float:
        return sum(s.fwd_runtime + s.bwd_runtime for s in self.partition.shards)

    def progress(self) -> sched.ModelProgress:
        rem_units = self.queue[self.cursor:]
        rem_t = sum(u.shard.fwd_runtime if u.direction == "fwd"
                    else u.shard.bwd_runtime for u in rem_units)
        return sched.ModelProgress(
            model_id=self.model_id,
            remaining_epochs=self.epochs - self.epoch,
            minibatches_per_epoch=self.steps_per_epoch,
            remaining_in_epoch=self.steps_per_epoch - self.minibatch,
            minibatch_time=self.minibatch_time(),
            remaining_in_minibatch=rem_t)


@dataclass(frozen=True)
class UnitEvent:
    """One executed shard unit, reported through ``SharpExecutor.run``'s
    ``on_unit`` hook."""
    model_id: int
    shard_index: int
    direction: str
    minibatch: int
    epoch: int
    device: int
    start: float
    end: float

    def key(self) -> tuple:
        """Schedule identity (virtual timestamps excluded: they shift with
        measured runtimes, the discrete assignment is the schedule)."""
        return (self.model_id, self.shard_index, self.direction,
                self.minibatch, self.epoch, self.device)


@dataclass
class RunReport:
    makespan: float
    utilization: dict[int, float]
    avg_utilization: float
    losses: dict[int, list]
    transfer: dict[int, Any]
    exposed_transfer_time: float
    hidden_transfer_time: float
    units_executed: int
    wall_time: float


class SharpExecutor:
    """Event-driven SHARP loop over virtual devices with real compute."""

    def __init__(self, hydra_cfg: HydraConfig, models: list[ModelExec],
                 devices: Optional[list[DeviceMemory]] = None):
        self.hc = hydra_cfg
        self.models = models
        # caller-owned ledgers (Session) charge one byte budget per device;
        # standalone use keeps private per-device ledgers
        self.devices = devices if devices is not None else [
            DeviceMemory(d, hydra_cfg.device_budget_bytes,
                         hydra_cfg.buffer_frac)
            for d in range(hydra_cfg.n_devices)]
        if len(self.devices) != hydra_cfg.n_devices:
            raise ValueError(
                f"{len(self.devices)} DeviceMemory ledgers for "
                f"{hydra_cfg.n_devices} devices")
        self.pick = sched.get_scheduler(hydra_cfg.scheduler,
                                        seed=hydra_cfg.seed)
        self.exposed_transfer = 0.0
        self.hidden_transfer = 0.0
        self.units_executed = 0
        # without SHARP, models run one-at-a-time (spilling-only mode)
        self.active_model: Optional[int] = None

    # -- pilot measurement --------------------------------------------------
    def pilot_pass(self):
        """Run one mini-batch per model twice (a warm-up, then a timed run)
        and record measured unit runtimes.  The shards are promoted copies
        and nothing is stepped or demoted, so training state is untouched.
        """
        for m in self.models:
            dev = m.store.device
            batch = m.pilot_batch
            acts = {}
            act = {}
            cot = None

            def timed(fn, *args):
                fn(*args)
                _sync(dev)
                t0 = time.perf_counter()
                res = fn(*args)
                _sync(dev)
                return res, max(time.perf_counter() - t0, 1e-7)

            for shard in m.partition.shards:
                own, shared = m.store.promote_shard_params(shard)
                acts[shard.index] = act
                (act, _), shard.fwd_runtime = timed(
                    m.fns.fwd(shard), own, shared, act, batch)
            for shard in reversed(m.partition.shards):
                own, shared = m.store.promote_shard_params(shard)
                args = (own, shared, acts[shard.index])
                if shard.index != len(m.partition.shards) - 1:
                    args += (cot,)
                res, shard.bwd_runtime = timed(m.fns.bwd(shard), *args,
                                               batch)
                cot = res[-1]
            for shard in m.partition.shards:
                shard.est_runtime = shard.fwd_runtime + shard.bwd_runtime

    # -- real unit execution -------------------------------------------------
    def _execute_unit(self, m: ModelExec, unit: Unit) -> None:
        shard = unit.shard
        batch = m.current_batch
        if unit.direction == "fwd":
            # the ledger charges the whole shard (opt state included) to
            # every unit, as the JAX package does; a forward unit copies
            # only the weights it reads
            own, shared = m.store.promote_shard_params(shard)
            act_in = {} if shard.index == 0 \
                else m.saved_acts[("exit", shard.index - 1)]
            # entry activation is the checkpoint this shard's backward reuses
            m.saved_acts[("entry", shard.index)] = act_in
            out, loss = m.fns.fwd(shard)(own, shared, act_in, batch)
            if shard.index == len(m.partition.shards) - 1:
                m.losses.append(float(loss))
            m.saved_acts[("exit", shard.index)] = out
        else:
            own, shared, opt_state = m.store.promote_shard(shard)
            act_in = m.saved_acts[("entry", shard.index)]
            last = shard.index == len(m.partition.shards) - 1
            if last:
                loss, g_own, g_shared, g_act = m.fns.bwd(shard)(
                    own, shared, act_in, batch)
            else:
                g_own, g_shared, g_act = m.fns.bwd(shard)(
                    own, shared, act_in, m.saved_cot, batch)
            m.saved_cot = g_act
            shared_names = m.store.shard_shared_names(shard)
            if shared_names:
                m.store.accumulate_shared_grads(
                    {n: g_shared.get(n) for n in shared_names})
            new_own, new_opt = m.fns._step(own, g_own, opt_state)
            m.store.demote_shard(shard, new_own, new_opt)
            # free this shard's saved activations
            m.saved_acts.pop(("entry", shard.index), None)
            m.saved_acts.pop(("exit", shard.index), None)

    # -- event loop -----------------------------------------------------------
    def run(self, *, max_units: Optional[int] = None,
            on_unit: Optional[Callable[[UnitEvent], None]] = None
            ) -> RunReport:
        wall0 = time.perf_counter()
        for m in self.models:
            m.build_minibatch_queue()
        if self.hc.pilot:
            for m in self.models:
                m.pilot_batch = m.current_batch
            self.pilot_pass()
        if self.hc.fixed_unit_runtime is not None:
            # applied independently of the pilot so the pin also holds with
            # pilot=False (analytic runtime estimates)
            rt = self.hc.fixed_unit_runtime
            for m in self.models:
                for shard in m.partition.shards:
                    shard.fwd_runtime = shard.bwd_runtime = rt
                    shard.est_runtime = 2 * rt

        windows = self.hc.device_windows or {}
        dev_heap = [(max(0.0, windows.get(d, (0.0, None))[0]), d)
                    for d in range(self.hc.n_devices)]
        heapq.heapify(dev_heap)
        dev_busy = {d: 0.0 for d in range(self.hc.n_devices)}
        dev_prev_start = {d: 0.0 for d in range(self.hc.n_devices)}
        makespan = 0.0

        while True:
            live = [m for m in self.models if not m.done]
            if not live:
                break
            if not dev_heap:
                raise RuntimeError(
                    "all devices retired with models unfinished "
                    f"({len(live)} remaining) — widen device_windows")
            t, d = heapq.heappop(dev_heap)
            until = windows.get(d, (0.0, None))[1]
            if until is not None and t >= until:
                continue    # device retired (fault / elasticity shrink)
            eligible = self._eligible()
            if not eligible:
                future = [m.ready_at for m in live if m.next_unit() is not None]
                if not future:
                    break
                heapq.heappush(dev_heap, (max(min(future), t + 1e-9), d))
                continue
            progress = [m.progress() for m in eligible]
            m = eligible[self.pick(progress)]
            unit = m.next_unit()
            m.reserved = True

            # ---- timing model -------------------------------------------
            shard_bytes = m.store.shard_transfer_bytes(unit.shard)
            act_bytes = unit.shard.act_bytes // 4   # boundary act only
            move_act = m.act_location is not None and m.act_location != d
            tx_bytes = shard_bytes + (act_bytes if move_act else 0)
            tx_time = tx_bytes / self.hc.link_bw
            if self.hc.enable_double_buffer:
                # transfer began when this device started its previous unit
                tx_start = max(dev_prev_start[d], m.ready_at)
                tx_end = tx_start + tx_time
                start = max(t, m.ready_at, tx_end)
                self.hidden_transfer += min(tx_time, max(0.0, t - tx_start))
                self.exposed_transfer += max(0.0, tx_end - max(t, m.ready_at))
            else:
                tx_start = max(t, m.ready_at)
                tx_end = tx_start + tx_time
                start = tx_end
                self.exposed_transfer += tx_time
            duration = unit.shard.fwd_runtime if unit.direction == "fwd" \
                else unit.shard.bwd_runtime
            end = start + duration

            # ---- memory accounting --------------------------------------
            dev = self.devices[d]
            dev.promote_through_buffer(
                shard_bytes, double_buffer=self.hc.enable_double_buffer)
            if move_act:
                dev.charge_act(act_bytes)

            # ---- real compute --------------------------------------------
            self._execute_unit(m, unit)
            self.units_executed += 1
            dev.charge_demotion(shard_bytes)
            if on_unit is not None:
                on_unit(UnitEvent(
                    model_id=m.model_id, shard_index=unit.shard.index,
                    direction=unit.direction, minibatch=unit.minibatch,
                    epoch=unit.epoch, device=d, start=start, end=end))

            # ---- advance model state -------------------------------------
            m.cursor += 1
            m.ready_at = end
            m.reserved = False
            m.act_location = d
            if m.cursor >= len(m.queue):
                self._finish_minibatch(m)
            if not self.hc.enable_sharp and m.done and \
                    self.active_model == m.model_id:
                self.active_model = None

            dev_busy[d] += duration
            dev_prev_start[d] = start
            makespan = max(makespan, end)
            heapq.heappush(dev_heap, (end, d))
            if max_units is not None and self.units_executed >= max_units:
                break

        util = {d: (dev_busy[d] / makespan if makespan > 0 else 0.0)
                for d in dev_busy}
        return RunReport(
            makespan=makespan,
            utilization=util,
            avg_utilization=float(np.mean(list(util.values()))),
            losses={m.model_id: m.losses for m in self.models},
            transfer={dv.device_id: dv.stats for dv in self.devices},
            exposed_transfer_time=self.exposed_transfer,
            hidden_transfer_time=self.hidden_transfer,
            units_executed=self.units_executed,
            wall_time=time.perf_counter() - wall0)

    def _eligible(self) -> list[ModelExec]:
        live = [m for m in self.models
                if not m.done and not m.reserved and m.next_unit() is not None]
        if self.hc.enable_sharp:
            return live
        # spilling-only: one model at a time (paper Table 3 top row)
        if self.active_model is None and live:
            self.active_model = min(m.model_id for m in live)
        return [m for m in live if m.model_id == self.active_model]

    def _finish_minibatch(self, m: ModelExec):
        m.store.step_shared()
        m.saved_acts.clear()
        m.saved_cot = None
        m.act_location = None
        m.minibatch += 1
        if m.minibatch >= m.steps_per_epoch:
            m.minibatch = 0
            m.epoch += 1
        # AutoML early stopping (Hyperband-class): underperformers leave the
        # workload — the case-1 -> case-2 degradation Sharded-LRTF handles
        # (paper §4.7.2)
        if m.early_stop is not None and m.early_stop(m.losses):
            m.stopped_early = True
            m.done = True
        if m.epoch >= m.epochs:
            m.done = True
        if m.done:
            if not self.hc.enable_sharp and self.active_model == m.model_id:
                self.active_model = None
            return
        m.build_minibatch_queue()
