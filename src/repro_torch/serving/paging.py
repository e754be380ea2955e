"""Block-granular KV paging: a free-list of fixed-size physical KV blocks
(port of ``repro.serving.paging``; the host-DRAM ``HostBlockPool`` comes
with the tiering slice).

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
"""

from __future__ import annotations

from typing import Optional

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
