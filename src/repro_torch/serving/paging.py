"""Block-granular KV paging: a free-list of fixed-size physical KV blocks
and the host-DRAM tier demoted blocks park in (port of
``repro.serving.paging``).

``BlockPool`` owns ONE pages dict — ``{"k","v"}`` of ``(L, n_blocks,
block_size, n_kv_heads, head_dim)`` tensors on the serving device, plus
``{"k_scale","v_scale"}`` of ``(L, n_blocks, block_size, n_kv_heads)``
for an int8 pool — and hands out physical blocks request by request.
Physical block 0 is the
reserved *garbage block*: inactive decode lanes and unused table entries
all point at it, so every table entry is a valid physical index and the
lane-batched KV write has a harmless target.  Attention masks rows past
each lane's length, so garbage contents are invisible.  Blocks are
refcounted: several lanes may alias one block (copy-on-write prefix
sharing); a block returns to the free list when its last reference drops.

``HostBlockPool`` holds the rows of blocks demoted to host DRAM (tiered
KV).  On a CUDA device the rows live in pinned slabs and move on a side
stream, ordered against the compute stream by events (see its
docstring); on the CPU the slabs are plain tensors and the copies are
immediate.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import torch

from repro_torch.models import api


class BlockPool:
    """Free-list of refcounted physical KV blocks + the pages dict."""

    GARBAGE = 0          # reserved physical block; never allocated

    def __init__(self, cfg, n_blocks: int, block_size: int, device="cuda",
                 kv_dtype=None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks={n_blocks}: need at least one allocatable block "
                "on top of the reserved garbage block 0")
        self.block_size = block_size
        self.n_blocks = n_blocks
        # kv_dtype='int8' allocates int8 pages + per-row f32 scale planes;
        # block_bytes prices the whole dict either way, so ledger charges
        # stay exact
        self.kv_dtype = "fp" if kv_dtype is None else kv_dtype
        self.block_bytes = api.kv_block_bytes(cfg, block_size, kv_dtype)
        self.pages = api.init_kv_pages(cfg, n_blocks, block_size, device,
                                       kv_dtype=kv_dtype)
        # low ids handed out first (stable layouts in tests); 0 is reserved
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}          # allocated block -> refcount
        self.total_allocs = 0
        self.peak_used = 0

    @property
    def n_allocatable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._ref)

    def used_bytes(self) -> int:
        return self.n_used * self.block_bytes

    def peak_bytes(self) -> int:
        return self.peak_used * self.block_bytes

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"BlockPool exhausted: need {n} block(s), "
                f"{len(self._free)} free of {self.n_allocatable} "
                f"allocatable ({self.block_size} rows * "
                f"{self.block_bytes} B each) — raise n_blocks or lower "
                "concurrency")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        self.total_allocs += n
        self.peak_used = max(self.peak_used, self.n_used)
        return ids

    def ref(self, bid: int) -> int:
        """Current refcount (0 when not allocated)."""
        return self._ref.get(bid, 0)

    def refcounts(self) -> dict[int, int]:
        """Snapshot of every live block's refcount (leak audits)."""
        return dict(self._ref)

    def incref(self, bid: int) -> int:
        """Alias an allocated block (prefix sharing); returns the id."""
        if bid not in self._ref:
            raise RuntimeError(
                f"BlockPool.incref({bid}): block is not allocated "
                "(cannot alias a free or garbage block)")
        self._ref[bid] += 1
        return bid

    def decref(self, bid: int) -> int:
        """Drop one reference; frees the block when the last one goes.
        Returns the remaining refcount."""
        if bid not in self._ref:
            raise RuntimeError(
                f"BlockPool.decref({bid}): block is not allocated "
                "(double free, or the reserved garbage block)")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            self._free.append(bid)
            return 0
        return self._ref[bid]

    def free(self, ids) -> None:
        """Drop one reference per id (the sole-owner fast path)."""
        for b in ids:
            self.decref(b)


class _Fetch:
    """An issued host -> device block copy: the slab rows it reads (held
    until it lands), the device staging tensor, and its event (None on
    the CPU, where the copy has already happened)."""

    def __init__(self, slots, staging, event):
        self.slots = slots
        self.staging = staging
        self.event = event


def _index_copy(dst: torch.Tensor, dim: int, ids: torch.Tensor,
                src: torch.Tensor) -> None:
    """``dst.index_copy_(dim, ids, src)``, with fp8 planes moved as their
    bytes (``uint8`` views, exact): PyTorch's CPU build has no
    ``index_copy_`` for ``float8_e4m3fn``."""
    if dst.dtype == torch.float8_e4m3fn:
        dst, src = dst.view(torch.uint8), src.view(torch.uint8)
    dst.index_copy_(dim, ids, src)


class HostBlockPool:
    """Host-DRAM side of the tiered KV cache.

    Holds the *contents* of demoted KV blocks — per block, the rows of
    every pages plane (``k``/``v`` of ``(L, block_size, n_kv_heads,
    head_dim)``, plus the scale planes of an int8 pool) — keyed by an
    opaque handle.  Byte accounting mirrors the device pool's
    ``block_bytes``, so ``DeviceMemory.host_kv_bytes`` reconciles exactly
    with ``used_bytes()`` here.  There is no budget: host DRAM is the
    backing tier, bounded by what was demoted out of the device budget.

    Storage is a list of slabs, one tensor per plane each, of whole-block
    rows with a free list over them; a slab is added (never copied) when
    the free rows run out, sized to double the pool.  On a CUDA device the
    slabs are pinned — pinning runs near 1 GB/s, far slower than the copy
    itself, so it is paid once per slab, never per block — and both
    directions run on one side stream:

    * ``demote`` gathers the blocks on the compute stream (one
      ``index_select`` per plane, so every earlier write to them lands
      first and every later write — the blocks are free as soon as this
      returns — comes after the read), then the side stream waits on an
      event recorded after the gather and copies the staging rows into
      the slab rows (``record_stream`` keeps the staging alive for it).
    * ``prefetch`` makes the side stream wait on the compute stream (the
      new blocks' earlier users), copies the slab rows up and writes them
      into the new blocks with one ``index_copy_`` per plane, then records
      an event.  The slab rows stay taken until ``land``, which makes the
      compute stream wait on that event; a later ``demote`` reusing them
      is ordered after the copy on the same side stream as well.

    Nothing here synchronizes the device or the host.
    """

    MIN_SLAB_BLOCKS = 16

    def __init__(self, pages: dict, block_bytes: int):
        self.block_bytes = block_bytes
        leaf = next(iter(pages.values()))
        self.device = leaf.device
        # per-plane row shape (the block dim dropped) and dtype
        self._rows = {name: (p.shape[:1] + p.shape[2:], p.dtype)
                      for name, p in pages.items()}
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        if self._cuda:
            # the pages are written on the side stream (prefetch landing):
            # their memory must outlive its work
            for p in pages.values():
                p.record_stream(self._stream)
        self._slabs: list[dict] = []
        self._free: list[tuple[int, int]] = []  # (slab, row), popped last
        self._data: dict[int, tuple[int, int]] = {}    # key -> slab row
        self._next = 0
        self.total_demotions = 0     # lifetime blocks parked here
        self.total_prefetches = 0    # lifetime blocks pulled back out
        self.peak_blocks = 0
        # (direction, bytes, start event, end event) of the side-stream
        # copies on a card, for transfer_rates(); bounded
        self.transfers: deque = deque(maxlen=4096)

    @property
    def n_blocks(self) -> int:
        return len(self._data)

    def used_bytes(self) -> int:
        return self.n_blocks * self.block_bytes

    @property
    def slab_blocks(self) -> int:
        """Block rows allocated in the slabs (taken or free)."""
        return sum(next(iter(s.values())).shape[0] for s in self._slabs)

    def slab_bytes(self) -> int:
        return self.slab_blocks * self.block_bytes

    def _take(self, n: int) -> list[tuple[int, int]]:
        if n > len(self._free):
            rows = max(n - len(self._free), self.slab_blocks,
                       self.MIN_SLAB_BLOCKS)
            k = len(self._slabs)
            self._slabs.append({
                name: torch.empty((rows,) + tuple(shape), dtype=dtype,
                                  pin_memory=self._cuda)
                for name, (shape, dtype) in self._rows.items()})
            self._free.extend((k, r) for r in range(rows - 1, -1, -1))
        return [self._free.pop() for _ in range(n)]

    def _ids(self, bids) -> torch.Tensor:
        return torch.tensor(list(bids), dtype=torch.int64,
                            device=self.device)

    def _events(self):
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def demote(self, pages: dict, bids) -> list[int]:
        """Copy the rows of physical blocks ``bids`` into the host pool;
        returns one handle per block, in order.  The caller may free the
        blocks as soon as this returns."""
        slots = self._take(len(bids))
        ids = self._ids(bids)
        staging = {name: p.transpose(0, 1).index_select(0, ids)
                   for name, p in pages.items()}   # (n, L, bs, ...) each
        if self._cuda:
            gathered = torch.cuda.Event()
            gathered.record()
            self._stream.wait_event(gathered)
            start, end = self._events()
            with torch.cuda.stream(self._stream):
                start.record()
                for name, rows in staging.items():
                    rows.record_stream(self._stream)
                    for i, (k, r) in enumerate(slots):
                        self._slabs[k][name][r].copy_(rows[i],
                                                      non_blocking=True)
                end.record()
            self.transfers.append(("d2h", len(bids) * self.block_bytes,
                                   start, end))
        else:
            for name, rows in staging.items():
                for i, (k, r) in enumerate(slots):
                    self._slabs[k][name][r].copy_(rows[i])
        keys = []
        for slot in slots:
            self._data[self._next] = slot
            keys.append(self._next)
            self._next += 1
        self.total_demotions += len(keys)
        self.peak_blocks = max(self.peak_blocks, self.n_blocks)
        return keys

    def _pop(self, key: int) -> tuple[int, int]:
        if key not in self._data:
            raise RuntimeError(f"HostBlockPool.pop({key}): no such block")
        self.total_prefetches += 1
        return self._data.pop(key)

    def prefetch(self, pages: dict, keys, bids) -> _Fetch:
        """Issue the copy of parked blocks ``keys`` into physical blocks
        ``bids`` (both in order); the rows are in the pages once ``land``
        returns for the result."""
        slots = [self._pop(k) for k in keys]
        if not self._cuda:
            ids = self._ids(bids)
            for name, p in pages.items():
                rows = torch.stack([self._slabs[k][name][r]
                                    for k, r in slots])
                _index_copy(p, 1, ids, rows.transpose(0, 1))
            return _Fetch(slots, None, None)
        users = torch.cuda.Event()
        users.record()
        self._stream.wait_event(users)
        start, end = self._events()
        with torch.cuda.stream(self._stream):
            ids = self._ids(bids)
            staging = {name: torch.empty((len(slots),) + tuple(shape),
                                         dtype=dtype, device=self.device)
                       for name, (shape, dtype) in self._rows.items()}
            start.record()
            for name, p in pages.items():
                rows = staging[name]
                for i, (k, r) in enumerate(slots):
                    rows[i].copy_(self._slabs[k][name][r], non_blocking=True)
                _index_copy(p, 1, ids, rows.transpose(0, 1))
            end.record()
        self.transfers.append(("h2d", len(slots) * self.block_bytes,
                               start, end))
        return _Fetch(slots, staging, end)

    def land(self, fetch: _Fetch) -> Optional[bool]:
        """Order the compute stream after an issued prefetch and give its
        slab rows back.  Returns whether the copy had already completed
        when the compute stream asked for it (None on the CPU)."""
        done = None
        if fetch.event is not None:
            done = fetch.event.query()
            torch.cuda.current_stream(self.device).wait_event(fetch.event)
        self._free.extend(reversed(fetch.slots))
        fetch.slots = []
        return done

    def drop(self, key: int) -> None:
        """Discard a parked block (owner cancelled/shed while demoted)."""
        if key not in self._data:
            raise RuntimeError(f"HostBlockPool.drop({key}): no such block")
        self._free.append(self._data.pop(key))

    def transfer_rates(self) -> dict:
        """Bytes, device ms and GB/s of the side-stream copies kept in
        ``transfers``, by direction.  Waits for the side stream: call it
        outside an engine tick (a measurement, not the serving path)."""
        out = {}
        if self._stream is not None:
            self._stream.synchronize()
        for direction in ("d2h", "h2d"):
            rec = [(b, s.elapsed_time(e)) for d, b, s, e in self.transfers
                   if d == direction]
            nbytes = sum(b for b, _ in rec)
            ms = sum(t for _, t in rec)
            out[direction] = {"copies": len(rec), "bytes": nbytes, "ms": ms,
                              "gb_per_s": nbytes / ms / 1e6 if ms else None}
        return out


def blocks_for_rows(rows: int, block_size: int) -> int:
    """Blocks needed to hold ``rows`` KV rows (ceil division)."""
    return -(-rows // block_size)


def default_n_blocks(capacity: int, max_seq: int, block_size: int,
                     n_blocks: Optional[int] = None) -> int:
    """Physical pool size: worst case of every lane at ``max_seq`` rows,
    plus the garbage block."""
    if n_blocks is not None:
        return n_blocks
    return capacity * blocks_for_rows(max_seq, block_size) + 1
