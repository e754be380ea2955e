"""FIFO request queue (arrival-stamped) + KV-budget admission control.

Two admission granularities share this module (each ``DecodeBackend`` in
``serving/backends.py`` owns one):

* ``KVBudget`` — slot-granular: every running request owns one slot of the
  fixed-capacity pool at a constant ``slot_bytes`` residency (computed via
  the family spec's ``decode_state_bytes`` cost fn — no allocation).
* ``PagedKVBudget`` — ledger-unit-granular: a request reserves only the
  units (KV blocks, or whole slots when ``SlotBackend`` is handed a
  ledger) its actual extent can touch, charged against a shared
  ``core.spilling.DeviceMemory`` ledger — the SAME ledger SHARP shard
  promotions charge, so train double-buffers and serve reservations split
  one device byte budget.  With prefix sharing, a request's reservation
  covers only its UNSHARED blocks; blocks whose owner retired while still
  aliased stay charged by the backend as orphans until the last reference
  drops.  Under speculative decoding the same reservation grows to cover
  draft + target + the k-token verify headroom: the inner backend's
  worst-case sizing folds in ``verify_headroom`` rows, and the spec
  backend reserves the draft model's decode-state bytes on whatever byte
  ledger backs the job (the session's shared one, or the paged inner's
  private ledger; a slot inner with a private ``kv_budget_bytes`` has no
  byte ledger, so that budget bounds target slots only).

Both enforce ``reserved <= budget`` as an invariant: a request is admitted
only if its reservation fits, so concurrency degrades gracefully when the
budget is tighter than the pool (tests/test_serving.py asserts the peak
never exceeds it).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Optional

from repro_torch.serving.request import Request


class RequestQueue:
    """Arrival-ordered queue; stamps ``arrival_time`` + ``arrival_seq``
    on push.  The seq is a per-queue monotonic counter: the deterministic
    tie-break every admission policy (and the LRTF router) falls back to,
    so schedules are reproducible across runs regardless of clock
    resolution.  Admission policies reorder by iterating (``__iter__`` /
    ``remove``) — the deque itself stays arrival-ordered."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._q: deque[Request] = deque()
        self._seq = itertools.count()

    def push(self, req: Request) -> Request:
        if req.arrival_time is None:
            req.arrival_time = self.clock()
        if req.arrival_seq is None:
            req.arrival_seq = next(self._seq)
        self._q.append(req)
        return req

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        """Head of the queue without removing it (page-granular admission
        must size the head's reservation before deciding to admit)."""
        return self._q[0]

    def remove(self, req: Request) -> None:
        """Remove a specific entry (policy-ordered admission pulls
        requests out of arrival order; shed/cancel sweeps retire them)."""
        self._q.remove(req)

    def find(self, request_id: str) -> Optional[Request]:
        """Queued request by id (cancellation targets it in place — the
        entry stays in FIFO order and admission retires it when reached)."""
        for req in self._q:
            if req.request_id == request_id:
                return req
        return None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)


class KVBudget:
    """Byte accounting for decode-state residency (admission control).

    ``budget_bytes=None`` disables the cap but keeps the accounting so
    metrics can report residency either way.
    """

    def __init__(self, budget_bytes: Optional[int], slot_bytes: int):
        if slot_bytes <= 0:
            raise ValueError("slot_bytes must be positive")
        if budget_bytes is not None and budget_bytes < slot_bytes:
            raise ValueError(
                f"KV budget {budget_bytes} B below one slot "
                f"({slot_bytes} B): nothing could ever be admitted")
        self.budget_bytes = budget_bytes
        self.slot_bytes = slot_bytes
        self.reserved_bytes = 0
        self.peak_bytes = 0

    def can_reserve(self) -> bool:
        return (self.budget_bytes is None
                or self.reserved_bytes + self.slot_bytes <= self.budget_bytes)

    def reserve(self) -> bool:
        if not self.can_reserve():
            return False
        self.reserved_bytes += self.slot_bytes
        self.peak_bytes = max(self.peak_bytes, self.reserved_bytes)
        return True

    def release(self) -> None:
        # a real error, not an assert: a double release corrupts admission
        # accounting and must be caught under `python -O` too
        if self.reserved_bytes < self.slot_bytes:
            raise RuntimeError(
                f"KVBudget.release: only {self.reserved_bytes} B reserved, "
                f"below one slot ({self.slot_bytes} B) — release without a "
                "matching reserve")
        self.reserved_bytes -= self.slot_bytes

    def max_concurrent(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes // self.slot_bytes


class PagedKVBudget:
    """Page-granular admission charging a shared ``DeviceMemory`` ledger.

    Reservations are variable-sized (blocks for the request's actual
    prompt + decode budget, not ``max_seq``); the ledger arbitrates the
    device byte budget between these reservations and whatever else lives
    on the device (promoted shards, double buffers).  Local
    ``reserved_bytes``/``peak_bytes`` counters track THIS engine's share
    so multi-engine metrics stay attributable.
    """

    def __init__(self, ledger, block_bytes: int):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        self.ledger = ledger
        self.block_bytes = block_bytes
        self.reserved_bytes = 0
        self.peak_bytes = 0

    @property
    def budget_bytes(self) -> int:
        return self.ledger.budget

    def can_reserve(self, n_blocks: int) -> bool:
        return self.ledger.can_reserve_kv(n_blocks * self.block_bytes)

    def reserve(self, n_blocks: int) -> bool:
        nbytes = n_blocks * self.block_bytes
        if not self.ledger.reserve_kv(nbytes):
            return False
        self.reserved_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.reserved_bytes)
        return True

    def release(self, n_blocks: int) -> None:
        nbytes = n_blocks * self.block_bytes
        if nbytes > self.reserved_bytes:
            raise RuntimeError(
                f"PagedKVBudget.release({n_blocks} blocks = {nbytes} B): "
                f"only {self.reserved_bytes} B reserved — release without "
                "a matching reserve")
        self.reserved_bytes -= nbytes
        self.ledger.release_kv(nbytes)

    # -- tiered KV: device <-> host-pool moves (serving/backends.py) --------
    def demote(self, n_blocks: int) -> None:
        """Park reserved blocks in the host pool: device bytes release,
        ``DeviceMemory.host_kv_bytes`` picks them up."""
        nbytes = n_blocks * self.block_bytes
        if nbytes > self.reserved_bytes:
            raise RuntimeError(
                f"PagedKVBudget.demote({n_blocks} blocks = {nbytes} B): "
                f"only {self.reserved_bytes} B reserved")
        self.reserved_bytes -= nbytes
        self.ledger.demote_kv(nbytes)

    def prefetch(self, n_blocks: int) -> bool:
        """Re-reserve device bytes for demoted blocks; False when the
        device side does not fit yet."""
        nbytes = n_blocks * self.block_bytes
        if not self.ledger.prefetch_kv(nbytes):
            return False
        self.reserved_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.reserved_bytes)
        return True

    def drop_host(self, n_blocks: int) -> None:
        """Discard demoted blocks outright (owner cancelled while parked)."""
        self.ledger.drop_host_kv(n_blocks * self.block_bytes)
