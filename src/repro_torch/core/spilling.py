"""Model spilling (paper §4.2): shard-granular promotion/demotion between
device memory and host DRAM, with byte accounting per virtual device
(port of ``repro.core.spilling``).

The host store keeps every model's master copy — params and optimizer
state — as CPU tensors; for a CUDA device they live in pinned memory, and
promotion copies them to the card with ``non_blocking=True`` on the
current stream (compute queued after the copy on that stream waits for
it), while demotion copies back with a blocking copy into the same pinned
tensors.  Promotion always makes new tensors, on the CPU too, where
``.to("cpu")`` alone would return the host tensor itself: nothing a unit
does to its promoted shard can reach the master copy except ``demote``.

A training shard is promoted one copy a merged slice of stacked rows.
A prefetch (``prefetch_shard``) is that promotion made ahead of the unit
that needs it, on a copy stream, while another unit computes (the SHARP
executor's double buffering).  The store counts the writes its host copy
takes (a generation per shard, one for the shared leaves), and ``claim``
hands a prefetch out only if nothing it copied was written since: a
dropped prefetch costs bytes, never a stale shard.

Layout of the host store per model:
    params:      family host tree (prepare_host_params applied)
    opt:         {shard_index: opt-state tree}  (own params; its leaves
                 are views of the state over the shard's stacked rows,
                 which a promotion copies one tensor a stacked leaf)
    shared_opt:  {name: opt-state tree}         (shared params)
A forward-only store (``train=False``: eval, spilled inference, cold
serving) holds params only: no unit of its model steps an optimizer, so
it keeps no optimizer state (the JAX package's holds AdamW moments, two
more copies of the params, that nothing reads).

``DeviceMemory`` is the byte ledger of one virtual device: promoted
shards, the double-buffer loading zone, serving KV pages and serve-weight
residency, all against one budget.  The SHARP executor charges virtual
transfer time = bytes / ``link_bw`` against the device timeline.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import resolve_device, tracing
from repro_torch.core import shard_graph as sg
from repro_torch.core.partitioner import PartitionResult, Shard, tree_bytes
from repro_torch.tree import tree_leaves, tree_map


def to_host(tree, pin: bool = False):
    """A CPU copy of every tensor of ``tree`` (pinned when ``pin``)."""
    def copy(t):
        t = t.detach().to("cpu", copy=True)
        return t.pin_memory() if pin else t
    return tree_map(copy, tree)


def to_device(tree, device):
    """A copy of every tensor of ``tree`` on ``device``: asynchronous on
    the current stream from pinned host memory to a CUDA device, and a
    fresh tensor on the CPU as well."""
    return tree_map(lambda t: t.to(device, non_blocking=True, copy=True),
                    tree)


@dataclass
class Prefetch:
    """One shard copied to the device ahead of its unit
    (``HostModelStore.prefetch_shard``)."""
    shard: int
    generation: tuple           # the store's write generation when copied
    tensors: tuple              # (own, shared, opt_state or None)
    copies: list                # the tensors the copies made (views above)
    done: Optional[Any] = None  # CUDA event after the copies, on their stream


@dataclass
class TransferStats:
    promoted_bytes: int = 0
    demoted_bytes: int = 0
    n_promotions: int = 0
    n_demotions: int = 0
    act_bytes_moved: int = 0
    # tiered KV (serving): pages moved between device pool and host pool
    kv_demoted_bytes: int = 0
    kv_prefetched_bytes: int = 0
    n_kv_demotions: int = 0
    n_kv_prefetches: int = 0

    def total_bytes(self) -> int:
        return (self.promoted_bytes + self.demoted_bytes
                + self.act_bytes_moved
                + self.kv_demoted_bytes + self.kv_prefetched_bytes)


class HostModelStore:
    """DRAM-resident master copy of one model (params + optimizer state),
    promoted to ``device`` shard by shard."""

    def __init__(self, cfg, plan: sg.ShardPlan, params, opt_cfg,
                 partition: PartitionResult, device="cuda", *,
                 train: bool = True):
        from repro_torch.optim import optimizers as opt
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        self.cfg = cfg
        self.plan = plan
        self.partition = partition
        self.opt_cfg = opt_cfg
        self.train = train
        self.opt: dict[int, Any] = {}
        self.shared_opt: dict[str, Any] = {}
        # writes taken by the host copy: a shard's index counts its own
        # leaves and moments, None the shared leaves
        self._writes: Counter = Counter()
        # a shard's own refs with neighbouring stacked rows merged, and its
        # optimizer state over the merged slices (``opt`` holds views)
        self._runs: dict[int, list] = {}
        self._opt_runs: dict[int, Any] = {}
        with tracing.span("hydra.store_build", model=cfg.name) as sp:
            self.params = sg.prepare_host_params(cfg, to_host(params, pin))
            if train:
                for shard in partition.shards:
                    runs = self._runs[shard.index] = sg.merge_stack_slices(
                        [plan.segments[i].param_ref
                         for i in range(shard.seg_lo, shard.seg_hi)])
                    state = self._opt_runs[shard.index] = to_host(
                        opt.init_state(opt_cfg, self._merged(runs)), pin)
                    self.opt[shard.index] = self._unmerge_state(runs, state)
                self.shared_opt = {
                    name: to_host(opt.init_state(
                        opt_cfg, sg.resolve_ref(self.params, ref)), pin)
                    for name, ref in plan.shared_refs.items()}
                # accumulated grads for shared params within the current
                # mini-batch
                self.shared_grad_acc: dict[str, Any] = {}
            if sp:
                sp.set(bytes=tree_bytes((self.params, self.opt,
                                         self.shared_opt)))

    # -- own (spillable) ---------------------------------------------------
    def _own_params(self, shard: Shard):
        return tuple(sg.resolve_ref(self.params,
                                    self.plan.segments[i].param_ref)
                     for i in range(shard.seg_lo, shard.seg_hi))

    def _merged(self, runs: list):
        return tuple(sg.resolve_ref(self.params, ref) for ref, _ in runs)

    @staticmethod
    def _unmerge_state(runs: list, state: dict) -> dict:
        # per-leaf entries are tuples over the merged slices; the step
        # count is one tensor
        return {k: sg.unmerge(runs, v) if isinstance(v, tuple) else v
                for k, v in state.items()}

    def _shared_params(self, shard: Shard) -> dict:
        return {n: to_device(sg.resolve_ref(self.params,
                                            self.plan.shared_refs[n]),
                             self.device)
                for n in self.shard_shared_names(shard)}

    def promote_shard(self, shard: Shard, *, opt_state: bool = True):
        """Host -> device on the current stream: (own_params,
        shared_params, opt_state), the last None without ``opt_state``."""
        with tracing.span("hydra.promote", shard=shard.index) as sp:
            return self._copy_shard(shard, opt_state, sp)[0]

    def promote_shard_params(self, shard: Shard):
        """Host -> device, weights only (no optimizer state)."""
        with tracing.span("hydra.promote", shard=shard.index) as sp:
            own = to_device(self._own_params(shard), self.device)
            shared = self._shared_params(shard)
            if sp:
                sp.set(bytes=tree_bytes((own, shared)))
        return own, shared

    def _generation(self, shard: Shard) -> tuple[int, int]:
        """The writes taken so far by the host copy of ``shard``'s own
        leaves and moments, and of the shared leaves: a device copy made
        from them is current while this is unchanged."""
        return self._writes[shard.index], self._writes[None]

    def _copy_shard(self, shard: Shard, opt_state: bool, sp):
        """A training shard's own and shared leaves, and its optimizer
        state when ``opt_state``, queued to the device on the current
        stream: ``((own, shared, opt_state or None), copies)``, the trees
        views of ``copies``.  One copy a merged slice of stacked rows, not
        one a layer: past about a thousand queued copies CUDA makes the
        host wait for the oldest, and a whole shard's leaves and moments
        are more."""
        if not self.train:
            raise ValueError("a forward-only host store holds no optimizer "
                             "state: promote_shard_params")
        runs = self._runs[shard.index]
        copies = [to_device(self._merged(runs), self.device),
                  self._shared_params(shard)]
        if opt_state:
            copies.append(to_device(self._opt_runs[shard.index], self.device))
        if sp:
            sp.set(bytes=tree_bytes(copies))
        moments = self._unmerge_state(runs, copies[2]) if opt_state else None
        return (sg.unmerge(runs, copies[0]), copies[1], moments), copies

    def prefetch_shard(self, shard: Shard, *, opt_state: bool,
                       stream=None) -> Prefetch:
        """``promote_shard`` ahead of the unit that needs it, handed out by
        ``claim``: with a CUDA ``stream`` the copies are queued on it and
        an event marks their end; without one (the CPU) they are made at
        once."""
        generation = self._generation(shard)
        on = contextlib.nullcontext() if stream is None \
            else torch.cuda.stream(stream)
        with on:
            with tracing.span("hydra.promote", shard=shard.index,
                              prefetch=True) as sp:
                tensors, copies = self._copy_shard(shard, opt_state, sp)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        return Prefetch(shard.index, generation, tensors, copies, done)

    def claim(self, pf: Prefetch, shard: Shard) -> Optional[tuple]:
        """``pf``'s ``(own, shared, opt_state)`` for use on the current
        stream, or None where they may be stale: copied for another shard,
        or the host copy took a write since.  The current stream waits for
        the copies, and the allocator keeps their blocks until its work on
        them is done."""
        if pf.shard != shard.index or pf.generation != self._generation(shard):
            return None
        if pf.done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pf.done)
            for t in tree_leaves(pf.copies):
                t.record_stream(stream)
        return pf.tensors

    def demote_shard(self, shard: Shard, own, opt_state):
        """Device -> host: write back possibly-updated params + opt state."""
        self._writes[shard.index] += 1
        with tracing.span("hydra.demote", shard=shard.index) as sp:
            for k, i in enumerate(range(shard.seg_lo, shard.seg_hi)):
                ref = self.plan.segments[i].param_ref
                if ref is not None and own[k] is not None:
                    sg.update_with_ref(self.params, ref, own[k])
            tree_map(lambda dst, src: dst.copy_(src), self.opt[shard.index],
                     opt_state)
            if sp:
                sp.set(bytes=tree_bytes((own, opt_state)))

    def shard_shared_names(self, shard: Shard) -> list[str]:
        names: list[str] = []
        for i in range(shard.seg_lo, shard.seg_hi):
            for n in self.plan.segments[i].shared:
                if n not in names:
                    names.append(n)
        return names

    # -- shared ------------------------------------------------------------
    def accumulate_shared_grads(self, grads: dict[str, Any]):
        """Sum shared-param grads on the host across the mini-batch's
        backward units."""
        with tracing.span("hydra.shared_grads"):
            for name, g in grads.items():
                if g is None:
                    continue
                if name in self.shared_grad_acc:
                    self.shared_grad_acc[name] = tree_map(
                        lambda a, b: a + b.to("cpu"),
                        self.shared_grad_acc[name], g)
                else:
                    self.shared_grad_acc[name] = to_host(g)

    def step_shared(self):
        """Apply accumulated shared-param grads (mini-batch boundary)."""
        from repro_torch.optim import optimizers as opt
        self._writes[None] += 1
        with tracing.span("hydra.step_shared"):
            for name, g in self.shared_grad_acc.items():
                ref = self.plan.shared_refs[name]
                p = to_device(sg.resolve_ref(self.params, ref), self.device)
                s = to_device(self.shared_opt[name], self.device)
                # in place on the promoted copies (the shared table is the
                # largest tensor a step touches)
                new_p, new_s = opt.update_(self.opt_cfg, p,
                                           to_device(g, self.device), s)
                sg.update_with_ref(self.params, ref, new_p)
                tree_map(lambda dst, src: dst.copy_(src),
                         self.shared_opt[name], new_s)
            self.shared_grad_acc = {}

    # -- sizes --------------------------------------------------------------
    def shard_transfer_bytes(self, shard: Shard, *, train: bool = True) -> int:
        own_b = sum(tree_bytes(p) for p in self._own_params(shard)
                    if p is not None)
        shared_b = sum(
            tree_bytes(sg.resolve_ref(self.params, self.plan.shared_refs[n]))
            for n in self.shard_shared_names(shard))
        opt_b = tree_bytes(self.opt[shard.index]) if train else 0
        return own_b + shared_b + opt_b

    def model_params(self):
        """Reassembled full param tree (reference comparisons/checkpoints)."""
        return sg.restore_model_params(self.cfg, self.params)


class DeviceMemory:
    """Budget + double-buffer + KV-page accounting for one virtual device.

    One ledger, four charges against the same byte budget: promoted shard
    residency (``resident_bytes``), the double-buffer loading zone
    (``buffered_bytes``), serving KV-page reservations
    (``kv_reserved_bytes`` — charged by page-granular admission in
    ``repro_torch.serving``), and persistent serve-side weight residency
    (``weight_resident_bytes`` — hot shards held across serve ticks,
    ``serving/residency.py``).

    The tiered extension treats the device budget as a cache over host
    DRAM: KV pages of parked requests can be demoted into a host pool
    (``host_kv_bytes`` — tracked, not charged against the device budget)
    and prefetched back later, and a failing reservation first consults
    registered *pressure handlers* (LRU demotion of idle models' weight
    shards or parked KV pages) before giving up.
    """

    def __init__(self, device_id: int, budget_bytes: int,
                 buffer_frac: float = 0.05):
        self.device_id = device_id
        self.budget = budget_bytes
        self.buffer_budget = int(budget_bytes * buffer_frac)
        self.resident_bytes = 0
        self.buffered_bytes = 0
        self.kv_reserved_bytes = 0
        self.kv_peak_bytes = 0
        self.weight_resident_bytes = 0
        self.host_kv_bytes = 0
        self.host_kv_peak_bytes = 0
        self.stats = TransferStats()
        self._pressure_handlers: list = []
        self._in_pressure = False

    def used_bytes(self) -> int:
        return (self.resident_bytes + self.buffered_bytes
                + self.kv_reserved_bytes + self.weight_resident_bytes)

    def _check_budget(self) -> None:
        # a real error, not an assert: budget enforcement is a correctness
        # invariant that must survive `python -O`
        if self.used_bytes() > self.budget:
            raise RuntimeError(
                f"device {self.device_id} over budget: "
                f"{self.used_bytes()/1e9:.3f} GB > {self.budget/1e9:.3f} GB "
                f"(resident {self.resident_bytes/1e9:.3f} GB, double-buffer "
                f"{self.buffered_bytes/1e9:.3f} GB, kv pages "
                f"{self.kv_reserved_bytes/1e9:.3f} GB, serve weights "
                f"{self.weight_resident_bytes/1e9:.3f} GB)")

    def charge_promotion(self, nbytes: int, *, into_buffer: bool):
        if into_buffer:
            self.buffered_bytes += nbytes
        else:
            self.resident_bytes += nbytes
        self.stats.promoted_bytes += nbytes
        self.stats.n_promotions += 1
        self._check_budget()

    def promote_through_buffer(self, nbytes: int, *,
                               double_buffer: bool = True) -> None:
        """The SHARP promotion pattern: land the shard in the loading zone,
        then flip it into the active region."""
        self.charge_promotion(nbytes, into_buffer=double_buffer)
        if double_buffer:
            self.activate_buffer()

    # -- pressure (tiered demotion) -----------------------------------------
    def on_pressure(self, handler) -> None:
        """Register ``handler(need_bytes) -> freed_bytes``, consulted when a
        reservation does not fit.  Handlers demote tiered residents (idle
        models' weight shards, parked KV pages) to host DRAM."""
        if handler not in self._pressure_handlers:
            self._pressure_handlers.append(handler)

    def _relieve(self, need_bytes: int) -> None:
        # re-entrancy guard: a handler's own reservations must not recurse
        if self._in_pressure or need_bytes <= 0:
            return
        self._in_pressure = True
        try:
            freed = 0
            for handler in list(self._pressure_handlers):
                if freed >= need_bytes:
                    break
                freed += int(handler(need_bytes - freed))
        finally:
            self._in_pressure = False

    # -- serve weights (shard-granular residency) ---------------------------
    def reserve_weights(self, nbytes: int) -> bool:
        """Charge persistent hot-shard residency for a served model; False
        when it does not fit even after pressure-driven demotion — the
        caller streams the shard per tick instead of pinning it."""
        over = self.used_bytes() + nbytes - self.budget
        if over > 0:
            self._relieve(over)
        if self.used_bytes() + nbytes > self.budget:
            return False
        self.weight_resident_bytes += nbytes
        self.stats.promoted_bytes += nbytes
        self.stats.n_promotions += 1
        return True

    def release_weights(self, nbytes: int) -> None:
        """Demote hot serve shards back to the host store."""
        if nbytes > self.weight_resident_bytes:
            raise RuntimeError(
                f"device {self.device_id}: release_weights({nbytes}) exceeds "
                f"the {self.weight_resident_bytes} B of serve-weight "
                "residency — release without a matching reserve")
        self.weight_resident_bytes -= nbytes
        self.stats.demoted_bytes += nbytes
        self.stats.n_demotions += 1

    # -- serving KV pages ----------------------------------------------------
    def can_reserve_kv(self, nbytes: int) -> bool:
        return self.used_bytes() + nbytes <= self.budget

    def reserve_kv(self, nbytes: int) -> bool:
        """Charge a KV-page reservation; False (not an error) when it does
        not fit — admission control degrades to queueing, not crashing.
        Under pressure, registered handlers may demote tiered residents to
        make the reservation fit."""
        if not self.can_reserve_kv(nbytes):
            self._relieve(self.used_bytes() + nbytes - self.budget)
        if not self.can_reserve_kv(nbytes):
            return False
        self.kv_reserved_bytes += nbytes
        self.kv_peak_bytes = max(self.kv_peak_bytes, self.kv_reserved_bytes)
        return True

    # -- tiered KV: device pool <-> host pool -------------------------------
    def demote_kv(self, nbytes: int) -> None:
        """Move a live KV reservation device -> host pool: the device bytes
        are released (schedulable by others) while the pages stay accounted
        in ``host_kv_bytes`` until prefetched back or dropped."""
        self.release_kv(nbytes)
        self.host_kv_bytes += nbytes
        self.host_kv_peak_bytes = max(self.host_kv_peak_bytes,
                                      self.host_kv_bytes)
        self.stats.kv_demoted_bytes += nbytes
        self.stats.n_kv_demotions += 1

    def prefetch_kv(self, nbytes: int) -> bool:
        """Host pool -> device: re-reserve device bytes for demoted pages.
        False when the device side does not fit yet — the pages stay in the
        host pool and the owner retries once bytes drain."""
        if nbytes > self.host_kv_bytes:
            raise RuntimeError(
                f"device {self.device_id}: prefetch_kv({nbytes}) exceeds the "
                f"{self.host_kv_bytes} B parked in the host pool")
        if not self.reserve_kv(nbytes):
            return False
        self.host_kv_bytes -= nbytes
        self.stats.kv_prefetched_bytes += nbytes
        self.stats.n_kv_prefetches += 1
        return True

    def drop_host_kv(self, nbytes: int) -> None:
        """Discard demoted pages parked in the host pool (cancel / shed of
        a demoted request) without re-reserving device bytes."""
        if nbytes > self.host_kv_bytes:
            raise RuntimeError(
                f"device {self.device_id}: drop_host_kv({nbytes}) exceeds "
                f"the {self.host_kv_bytes} B parked in the host pool")
        self.host_kv_bytes -= nbytes

    def release_kv(self, nbytes: int) -> None:
        if nbytes > self.kv_reserved_bytes:
            raise RuntimeError(
                f"device {self.device_id}: release_kv({nbytes}) exceeds the "
                f"{self.kv_reserved_bytes} B reserved — release without a "
                "matching reserve")
        self.kv_reserved_bytes -= nbytes

    # -- shard residency -----------------------------------------------------
    def activate_buffer(self):
        """Promote the double-buffered shard to the active region."""
        self.resident_bytes += self.buffered_bytes
        self.buffered_bytes = 0

    def charge_demotion(self, nbytes: int):
        self.resident_bytes = max(0, self.resident_bytes - nbytes)
        self.stats.demoted_bytes += nbytes
        self.stats.n_demotions += 1

    def charge_act(self, nbytes: int):
        self.stats.act_bytes_moved += nbytes
