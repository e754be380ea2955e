"""Shard-granular weight residency for serving (port of
``repro.serving.residency``).

A served model's weights live in its ``HostModelStore`` (pinned on a
card) and reach the device **per shard**, charged to the one
``DeviceMemory`` ledger.  Two residency classes per shard:

* **hot** — held on the device across serve ticks
  (``DeviceMemory.reserve_weights``), up to the job's ``hot_bytes``
  target.  Many models' hot sets pack into one budget.
* **streamed** — everything else is promoted *through the double buffer*
  each tick, the ``SharpExecutor`` train pattern
  (``DeviceMemory.promote_through_buffer`` -> compute -> demotion), so the
  ledger peak is hot + one in-flight shard rather than the whole model.

Under ledger pressure a ``ResidencyCoordinator`` demotes hot shards of
the least-recently-served models first (LRU over last-served tick); a
demoted model keeps serving — its shards stream until the budget drains
and ``_ensure_hot`` re-pins them.

Every ledger decision is the JAX package's.  The device tensors follow
them: a hot shard's weights are copied up when it is pinned and dropped
when it is unpinned; a streamed shard's are copied up at ``begin_tick``
and dropped at ``end_tick``, so between ticks a model holds exactly its
hot shards on the device.  Within a tick the decode step reads every
layer, so all streamed shards are on the device at once (hot + every
streamed shard) where the ledger charges hot + one streamed shard — the
JAX package's accounting, kept as it is.  The shards are never
concatenated: the assembled tree's ``layers`` leaves are lists of
per-layer tensors, which is all ``transformer.layer_slices`` indexes.
Weights are read-only, so decode is token-identical to a fully resident
engine.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch

from repro_torch.core.spilling import DeviceMemory, HostModelStore
from repro_torch.models import api


def _place(tree: dict, ref: tuple, value) -> None:
    node = tree
    for k in ref[:-1]:
        node = node.setdefault(k, {})
    node[ref[-1]] = value


def _place_rows(layers: dict, rows: dict, lo: int) -> None:
    """Set per-layer rows ``lo, lo+1, ...`` of the ``layers`` lists from
    one segment's stacked slice."""
    for k, v in rows.items():
        if isinstance(v, dict):
            _place_rows(layers.setdefault(k, {}), v, lo)
        else:
            slots = layers.setdefault(k, [])
            for i in range(v.shape[0]):
                while len(slots) <= lo + i:
                    slots.append(None)
                slots[lo + i] = v[i]


class ShardResidentParams:
    """Param source for one served model: assembles the decode tree each
    engine tick from hot (held) + streamed (per-tick) weight shards.

    The engine calls ``begin_tick()`` before prefill/decode and
    ``end_tick()`` after; between ticks only the hot set is charged and
    held on the device.
    """

    def __init__(self, cfg, store: HostModelStore, partition,
                 ledger: DeviceMemory, *, hot_bytes: Optional[int] = None,
                 double_buffer: bool = True, name: Optional[str] = None,
                 clock=time.monotonic):
        self.cfg = cfg
        self.store = store
        self.device = store.device
        self.partition = partition
        self.ledger = ledger
        self.hot_bytes = hot_bytes      # None -> pin everything that fits
        self.double_buffer = double_buffer
        self.name = name or getattr(cfg, "name", "model")
        self.clock = clock
        self.shards = list(partition.shards)
        self.shard_bytes = {
            s.index: store.shard_transfer_bytes(s, train=False)
            for s in self.shards}
        self.total_bytes = sum(self.shard_bytes.values())
        self.last_used = float("-inf")  # LRU key: last-served tick time
        self._hot: dict[int, int] = {}  # shard index -> charged bytes
        # device copies, as (ref, tree) pieces: hot shards across ticks,
        # streamed shards for the current tick only
        self._held: dict[int, list] = {}
        self._streamed: dict[int, list] = {}
        self._tail_bytes = 0            # last streamed shard, demoted at end
        self._in_tick = False
        # traffic accounting (reported via summary())
        self.stream_promoted_bytes = 0
        self.n_stream_promotions = 0
        self.n_hot_demotions = 0
        self.promote_s = 0.0
        # (host bytes, start, end) CUDA events of each tick's streamed
        # promotions on a card, for transfer_rates(); bounded
        self.transfers: deque = deque(maxlen=4096)

    # -- device copies ------------------------------------------------------
    def _promote(self, shard) -> list:
        """Copy one shard's weights to the device (asynchronously from the
        pinned store on a card), held as the engine holds params
        (``api.prepare_params``: layer matrices in ``cfg.dtype``)."""
        plan = self.store.plan
        own, shared = self.store.promote_shard_params(shard)
        refs = [(plan.segments[i].param_ref, own[k])
                for k, i in enumerate(range(shard.seg_lo, shard.seg_hi))]
        refs += [(plan.shared_refs[n], tree) for n, tree in shared.items()]
        pieces = []
        for ref, tree in refs:
            if ref is None or tree is None:
                continue
            wrapped: dict = {}
            _place(wrapped, ref[1:2] if ref[0] == "stack_slice" else ref,
                   tree)
            pieces.append((ref, api.prepare_params(self.cfg, wrapped,
                                                   self.device)))
        return pieces

    def _assemble(self) -> dict:
        """The decode tree from the held and streamed shards: per-layer
        lists under ``layers``, other leaves at their refs."""
        tree: dict = {}
        for pieces in (*self._held.values(), *self._streamed.values()):
            for ref, piece in pieces:
                if ref[0] == "stack_slice":
                    _place_rows(tree.setdefault(ref[1], {}),
                                piece[ref[1]], ref[2])
                else:
                    node = piece
                    for k in ref:
                        node = node[k]
                    _place(tree, ref, node)
        return tree

    def held_device_bytes(self) -> int:
        """Bytes of the device tensors the hot shards hold."""
        def nbytes(t):
            if isinstance(t, dict):
                return sum(nbytes(v) for v in t.values())
            return t.numel() * t.element_size()
        return sum(nbytes(piece) for pieces in self._held.values()
                   for _, piece in pieces)

    # -- tick protocol (driven by InferenceEngine) --------------------------
    def begin_tick(self):
        """Assemble the device param tree for one prefill/decode tick."""
        self.last_used = self.clock()
        self._in_tick = True
        self._ensure_hot()
        cold = [s for s in self.shards if s.index not in self._hot]
        cuda = self.device.type == "cuda"
        if cuda and cold:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        prev = 0
        for s in cold:
            b = self.shard_bytes[s.index]
            if prev:
                self.ledger.charge_demotion(prev)
            self.ledger.promote_through_buffer(
                b, double_buffer=self.double_buffer)
            t0 = time.perf_counter()
            self._streamed[s.index] = self._promote(s)  # host -> device
            self.promote_s += time.perf_counter() - t0
            self.stream_promoted_bytes += b
            self.n_stream_promotions += 1
            prev = b
        if cuda and cold:
            end.record()
            self.transfers.append((sum(self.shard_bytes[s.index]
                                       for s in cold), start, end))
        # the last streamed shard stays charged through the decode call
        self._tail_bytes = prev
        return self._assemble()

    def end_tick(self) -> None:
        if self._tail_bytes:
            self.ledger.charge_demotion(self._tail_bytes)
            self._tail_bytes = 0
        self._streamed.clear()          # streamed shards leave the device
        self._in_tick = False

    # -- residency ----------------------------------------------------------
    def _pin(self, s, b: int) -> None:
        self._hot[s.index] = b
        self._held[s.index] = self._promote(s)

    def _unpin(self, idx: int) -> int:
        b = self._hot.pop(idx)
        self._held.pop(idx, None)
        self.ledger.release_weights(b)
        self.n_hot_demotions += 1
        return b

    def _ensure_hot(self) -> None:
        """Greedily (re-)pin shards up to the hot-bytes target.  Runs every
        tick, so a model demoted under pressure re-warms once the ledger
        drains.  The pin set must leave enough budget headroom to stream
        the LARGEST remaining cold shard — otherwise the tick itself would
        blow ``_check_budget`` mid-stream; pins yield (own shards last,
        after cross-model pressure relief) until streaming fits."""
        target = self.total_bytes if self.hot_bytes is None else self.hot_bytes
        hot_total = sum(self._hot.values())
        for s in self.shards:
            if s.index in self._hot:
                continue
            b = self.shard_bytes[s.index]
            if hot_total + b > target:
                continue
            if not self.ledger.reserve_weights(b):
                break       # budget full even after pressure demotion
            self._pin(s, b)
            hot_total += b
        cold = [s.index for s in self.shards if s.index not in self._hot]
        if not cold:
            return
        need = max(self.shard_bytes[i] for i in cold)
        headroom = self.ledger.budget - self.ledger.used_bytes()
        if headroom < need:
            # other models' idle pins go first (LRU via the ledger's
            # pressure handlers; our own demote() is a no-op mid-tick)
            self.ledger._relieve(need - headroom)
        while self._hot and \
                self.ledger.budget - self.ledger.used_bytes() < need:
            b = self._unpin(max(self._hot))
            need = max(need, b)     # the unpinned shard now streams too

    def demote(self, need_bytes: int) -> int:
        """Pressure handler: unpin hot shards until ``need_bytes`` are
        freed (or nothing is left).  Never demotes mid-tick — the charges
        are load-bearing while the model is decoding."""
        if self._in_tick:
            return 0
        freed = 0
        for idx in sorted(self._hot, reverse=True):
            if freed >= need_bytes:
                break
            freed += self._unpin(idx)
        return freed

    def demote_all(self) -> int:
        """Teardown: release every pinned shard (drain-to-baseline)."""
        return self.demote(self.total_bytes + 1)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def hot_resident_bytes(self) -> int:
        return sum(self._hot.values())

    @property
    def n_hot_shards(self) -> int:
        return len(self._hot)

    def summary(self) -> dict:
        return {
            "residency": "shard",
            "n_shards": len(self.shards),
            "n_hot_shards": self.n_hot_shards,
            "weight_bytes": self.total_bytes,
            "hot_resident_bytes": self.hot_resident_bytes,
            "stream_promoted_bytes": self.stream_promoted_bytes,
            "n_stream_promotions": self.n_stream_promotions,
            "n_hot_demotions": self.n_hot_demotions,
            "promote_s": round(self.promote_s, 6),
        }

    def transfer_rates(self) -> dict:
        """Host bytes, device ms and GB/s of the streamed promotions kept
        in ``transfers`` (copies and the casts to ``cfg.dtype``).  Waits
        for the device: call it outside a tick."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nbytes = sum(b for b, _, _ in self.transfers)
        ms = sum(s.elapsed_time(e) for _, s, e in self.transfers)
        return {"ticks": len(self.transfers), "bytes": nbytes, "ms": ms,
                "gb_per_s": nbytes / ms / 1e6 if ms else None}


class ResidencyCoordinator:
    """Cross-model LRU demotion: one per session ledger.  Registered as a
    ``DeviceMemory`` pressure handler; under pressure the least-recently-
    served models' hot shards leave the device first."""

    def __init__(self, ledger: DeviceMemory):
        self.ledger = ledger
        self.models: list[ShardResidentParams] = []
        ledger.on_pressure(self.relieve)

    def register(self, src: ShardResidentParams) -> None:
        if src not in self.models:
            self.models.append(src)

    def relieve(self, need_bytes: int) -> int:
        freed = 0
        for src in sorted(self.models, key=lambda s: s.last_used):
            if freed >= need_bytes:
                break
            freed += src.demote(need_bytes - freed)
        return freed
