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
The virtual clock charges that; the real loop does it too.  At the start
of each unit it asks the loop's own selection (``_pick_next``) which unit
the next iteration runs if this one completes as timed, and starts
promoting that unit's shard (``HostModelStore.prefetch_shard``): on a
CUDA device on a copy stream, overlapping this unit's kernels; on the
CPU at once.  The next unit takes the copy only if it is the unit
predicted and the host store took no write to what was copied since;
else the copy is dropped and the shard promoted in place.  The loop
prefetches only where the pick is a pure function of the progress list
(LRTF, SRTF, FIFO: asking it changes no later pick), where this unit's
shard and activations and the next shard fit the device's budget, and
with ``enable_double_buffer``.  Nothing is prefetched across a model's
minibatch end, where the user's hook runs first.  Demotion stays a
blocking copy on the compute stream.

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

from repro_torch import tracing
from repro_torch.core import scheduler as sched
from repro_torch.core import shard_graph as sg
from repro_torch.core.partitioner import PartitionResult, Shard
from repro_torch.core.spilling import (DeviceMemory, HostModelStore,
                                       Prefetch)
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
        if self.partition_oracle not in ("analytic", "probe"):
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
        # in place on the promoted copies: the unit's peak holds one
        # leaf's temporaries, not a second copy of params and moments
        return opt.update_(self.opt_cfg, own, g_own, opt_state)


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
        with tracing.span("hydra.data"):
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
        # a pick that reads nothing but the progress list can be asked
        # ahead (a random pick would consume its RNG)
        self._pure_pick = self.pick in (sched.sharded_lrtf,
                                        sched.sharded_srtf, sched.fifo)
        self._ahead: Optional[tuple[Unit, Prefetch]] = None
        self._copy_streams: dict = {}
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
            with tracing.span("hydra.pilot", model=m.model_id):
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

                # each loop drops a shard's promoted copies and gradients
                # before promoting the next, as the units do
                for shard in m.partition.shards:
                    acts[shard.index] = act
                    (act, _), shard.fwd_runtime = timed(
                        m.fns.fwd(shard), *m.store.promote_shard_params(shard),
                        act, batch)
                del act                  # the logits: no backward reads them
                for shard in reversed(m.partition.shards):
                    args = (*m.store.promote_shard_params(shard),
                            acts[shard.index])
                    if shard.index != len(m.partition.shards) - 1:
                        args += (cot,)
                    res, shard.bwd_runtime = timed(m.fns.bwd(shard), *args,
                                                   batch)
                    cot = res[-1]
                    del args, res
                for shard in m.partition.shards:
                    shard.est_runtime = shard.fwd_runtime + shard.bwd_runtime

    # -- real unit execution -------------------------------------------------
    def _promote(self, m: ModelExec, unit: Unit) -> tuple[tuple, bool]:
        """The unit's shard on the device, ``(own, shared, opt_state)``
        (no optimizer state for a forward), and whether it came from the
        prefetch made for it.  A prefetch for another unit, or one the
        host store took a write to since, is dropped, and the shard is
        promoted in place, on the current stream."""
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead[0] is unit:
            got = m.store.claim(ahead[1], unit.shard)
            if got is not None:
                return got, True
        # the ledger charges the whole shard (opt state included) to every
        # unit, as the JAX package does; a forward unit copies only the
        # weights it reads
        return m.store.promote_shard(
            unit.shard, opt_state=unit.direction == "bwd"), False

    def _prefetch_next(self, m: ModelExec, unit: Unit, d: int, end: float,
                       dev_heap: list, windows: dict,
                       shard_bytes: int) -> None:
        """Start promoting the shard of the unit the next iteration picks
        if ``unit`` (on device ``d``, to end at virtual ``end``, its shard
        ``shard_bytes``) completes as timed, where this unit's shard and
        activations and that shard fit the device's budget."""
        if not (self.hc.enable_double_buffer and self._pure_pick):
            return
        nxt = self._speculate(m, d, end, dev_heap, windows)
        if nxt is None:
            return
        nm, nu = nxt
        if (shard_bytes + unit.shard.act_bytes
                + nm.store.shard_transfer_bytes(nu.shard)) \
                > self.devices[d].budget:
            return
        where = nm.store.device
        stream = None
        if where.type == "cuda":
            stream = self._copy_streams.get(where)
            if stream is None:
                stream = self._copy_streams[where] = torch.cuda.Stream(where)
        self._ahead = (nu, nm.store.prefetch_shard(
            nu.shard, opt_state=nu.direction == "bwd", stream=stream))

    def _speculate(self, m: ModelExec, d: int, end: float, dev_heap: list,
                   windows: dict) -> Optional[tuple[ModelExec, Unit]]:
        """The model and unit that ``_pick_next`` gives the next iteration
        if ``m``'s running unit completes as timed, asked on the state that
        unit leaves: ``m`` one unit on, not reserved, ready at ``end``, and
        device ``d`` back on the heap at ``end``.  None where it picks
        nothing, which includes a unit that ends ``m``'s minibatch (the
        hook that runs there may stop the model)."""
        saved = m.cursor, m.reserved, m.ready_at, self.active_model
        m.cursor, m.reserved, m.ready_at = m.cursor + 1, False, end
        heap = dev_heap + [(end, d)]
        heapq.heapify(heap)
        try:
            picked = self._pick_next(heap, windows)
            if picked is None or picked[2] is None:
                return None
            return picked[2], picked[2].next_unit()
        finally:
            m.cursor, m.reserved, m.ready_at, self.active_model = saved

    def _execute_unit(self, m: ModelExec, unit: Unit, own, shared,
                      opt_state) -> None:
        """Run ``unit`` on its promoted shard (``opt_state`` None for a
        forward)."""
        shard = unit.shard
        batch = m.current_batch
        last = shard.index == len(m.partition.shards) - 1
        if unit.direction == "fwd":
            act_in = {} if shard.index == 0 \
                else m.saved_acts[("exit", shard.index - 1)]
            # entry activation is the checkpoint this shard's backward reuses
            m.saved_acts[("entry", shard.index)] = act_in
            with tracing.span("hydra.fwd", shard=shard.index):
                out, loss = m.fns.fwd(shard)(own, shared, act_in, batch)
                if last:
                    # the last exit (the logits) is no shard's entry, and
                    # its backward recomputes it: keeping it would hold a
                    # logits-sized tensor through that backward unit
                    m.losses.append(float(loss))
            if not last:
                m.saved_acts[("exit", shard.index)] = out
        else:
            act_in = m.saved_acts[("entry", shard.index)]
            with tracing.span("hydra.bwd", shard=shard.index):
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
            with tracing.span("hydra.schedule"):
                picked = self._pick_next(dev_heap, windows)
                if picked is None:
                    raise RuntimeError(
                        "all devices retired with models unfinished "
                        f"({len(live)} remaining) — widen device_windows")
                t, d, m = picked
                if m is None:
                    future = [m.ready_at for m in live
                              if m.next_unit() is not None]
                    if not future:
                        break
                    heapq.heappush(dev_heap, (max(min(future), t + 1e-9), d))
                    continue
                unit = m.next_unit()
                m.reserved = True

                # ---- timing model ---------------------------------------
                shard_bytes = m.store.shard_transfer_bytes(unit.shard)
                act_bytes = unit.shard.act_bytes // 4   # boundary act only
                move_act = m.act_location is not None and m.act_location != d
                tx_bytes = shard_bytes + (act_bytes if move_act else 0)
                tx_time = tx_bytes / self.hc.link_bw
                if self.hc.enable_double_buffer:
                    # transfer began when this device started its previous
                    # unit
                    tx_start = max(dev_prev_start[d], m.ready_at)
                    tx_end = tx_start + tx_time
                    start = max(t, m.ready_at, tx_end)
                    self.hidden_transfer += min(tx_time,
                                                max(0.0, t - tx_start))
                    self.exposed_transfer += max(
                        0.0, tx_end - max(t, m.ready_at))
                else:
                    tx_start = max(t, m.ready_at)
                    tx_end = tx_start + tx_time
                    start = tx_end
                    self.exposed_transfer += tx_time
                duration = unit.shard.fwd_runtime if unit.direction == "fwd" \
                    else unit.shard.bwd_runtime
                end = start + duration

                # ---- memory accounting ----------------------------------
                dev = self.devices[d]
                dev.promote_through_buffer(
                    shard_bytes, double_buffer=self.hc.enable_double_buffer)
                if move_act:
                    dev.charge_act(act_bytes)

            # ---- real compute --------------------------------------------
            with tracing.span("hydra.unit", model=m.model_id,
                              shard=unit.shard.index,
                              direction=unit.direction,
                              minibatch=unit.minibatch) as sp:
                promoted, prefetched = self._promote(m, unit)
                if sp:
                    sp.set(prefetched=prefetched)
                self._prefetch_next(m, unit, d, end, dev_heap, windows,
                                    shard_bytes)
                self._execute_unit(m, unit, *promoted)
                del promoted        # not held through the hooks below
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

        self._ahead = None          # a prefetch no unit of this run takes
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

    def _pick_next(self, dev_heap: list, windows: dict
                   ) -> Optional[tuple[float, int, Optional[ModelExec]]]:
        """Pop the next device that has not retired off ``dev_heap``, and
        pick the model whose next unit it runs: ``(t, d, model)``, the
        model None where none is eligible, or None where every device
        retired.  The loop's selection, and its speculation's."""
        while dev_heap:
            t, d = heapq.heappop(dev_heap)
            until = windows.get(d, (0.0, None))[1]
            if until is not None and t >= until:
                continue    # device retired (fault / elasticity shrink)
            eligible = self._eligible()
            if not eligible:
                return t, d, None
            return t, d, eligible[self.pick([m.progress()
                                             for m in eligible])]
        return None

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
        with tracing.span("hydra.minibatch_end", model=m.model_id,
                          minibatch=m.minibatch):
            m.store.step_shared()
            m.saved_acts.clear()
            m.saved_cot = None
            m.act_location = None
            m.minibatch += 1
            if m.minibatch >= m.steps_per_epoch:
                m.minibatch = 0
                m.epoch += 1
            # AutoML early stopping (Hyperband-class): underperformers leave
            # the workload — the case-1 -> case-2 degradation Sharded-LRTF
            # handles (paper §4.7.2)
            if m.early_stop is not None:
                with tracing.span("hydra.early_stop", model=m.model_id):
                    stop = m.early_stop(m.losses)
                if stop:
                    m.stopped_early = True
                    m.done = True
            if m.epoch >= m.epochs:
                m.done = True
            if m.done:
                if not self.hc.enable_sharp \
                        and self.active_model == m.model_id:
                    self.active_model = None
                return
            m.build_minibatch_queue()
