"""Decode backends (port of ``repro.serving.backends``; the paged backend).

``InferenceEngine`` owns the request lifecycle; a backend owns where
decode state lives and what a request's residency costs.  The protocol:

    free_lanes                      -> lanes available for admission
    admission_check(req, rows)      -> raise iff the request can NEVER fit
    reserve(req, rows) -> bool      -> admission: lane + byte reservation
    release(req)                    -> retire: free lane, release bytes
    fresh_states(n, rows)           -> transient state for a prefill group
    write_prefill(group, states)    -> move prefilled rows into the backend
    decode(params, tokens, active)  -> one pooled decode step (all lanes)
    advance(lane)                   -> post-token bookkeeping
    summary()                       -> backend-specific metric extras

plus the preemption trio the SLO scheduler drives (``preempt`` /
``resume`` / ``discard_preempted``).

``PagedBackend`` keeps K/V in a refcounted ``BlockPool`` of fixed-size
blocks on the serving device; admission reserves only the blocks a
request's prompt + decode extent can touch, charged against a
``DeviceMemory`` ledger.  Requests with a common block-aligned prompt
prefix alias the same physical blocks (copy-on-write: the first write
past the shared extent copies the boundary block).  The page writes —
prefill scatter, copy-on-write copy, per-step row write — update the
pool's tensors in place, where the JAX package donates them to a jitted
program and gets the updated pool back.

The slot backend, speculative decoding and host-DRAM tiering are later
slices of the port; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spilling import DeviceMemory
from repro_torch.models import api
from repro_torch.models.registry import spec as family_spec
from repro_torch.serving.paging import (BlockPool, blocks_for_rows,
                                        default_n_blocks)
from repro_torch.serving.queue import PagedKVBudget
from repro_torch.serving.request import Request
from repro_torch.training.train_loop import make_paged_decode_step

# backends (and options) of the JAX package that later slices port
LATER = {
    "slot": "the slot backend is ported in a later slice of the PyTorch "
            "port; serve with backend='paged'",
    "spec": "speculative decoding is ported in a later slice of the "
            "PyTorch port; serve with backend='paged'",
}
TIERED_LATER = ("host-DRAM KV tiering is ported in a later slice of the "
                "PyTorch port")


def _page_scatter(pages, k_new, v_new, ids) -> None:
    """Scatter freshly prefilled contiguous KV rows into physical blocks,
    in place.  k/v_new: (L, n, W, nkv, hd) prefill state, W a multiple of
    the block size; ids: (n * W/bs,) physical block per logical block, all
    requests concatenated (aliased blocks are redirected to the garbage
    block — their owner already holds identical rows)."""
    L, n, W, nkv, hd = k_new.shape
    bs = pages["k"].shape[2]
    for name, new in (("k", k_new), ("v", v_new)):
        rows = new.reshape(L, n * (W // bs), bs, nkv, hd)
        pages[name][:, ids] = rows.to(pages[name].dtype)


def _page_copy(pages, src: int, dst: int) -> None:
    """Copy one physical block's rows (all layers) src -> dst in place:
    the copy-on-write primitive."""
    for p in pages.values():
        p[:, dst] = p[:, src]


class PagedBackend:
    """Refcounted block pool; admission charges only unshared blocks."""

    name = "paged"
    preemptible = True
    preempt_reason = None

    def __init__(self, cfg, capacity: int, max_seq: int, *,
                 window: Optional[int] = None, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None, ledger=None,
                 paged_impl: Optional[str] = None,
                 prefix_share: bool = True, kv_dtype: Optional[str] = None,
                 tiered: bool = False, device="cuda"):
        from repro_torch.kernels import ops as kops
        if tiered:
            raise NotImplementedError(TIERED_LATER)
        if ledger is not None and kv_budget_bytes is not None:
            raise ValueError(
                "pass either a shared DeviceMemory ledger or a private "
                "kv_budget_bytes, not both")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.block_size = block_size
        self.prefix_share = bool(prefix_share)
        self.kv_dtype = "fp" if kv_dtype in (None, "fp") else kv_dtype
        self.max_blocks = blocks_for_rows(max_seq, block_size)
        block_bytes = family_spec(cfg).kv_block_bytes(cfg, block_size,
                                                      self.kv_dtype)
        worst = default_n_blocks(capacity, max_seq, block_size, n_blocks)
        if ledger is None:
            budget = (kv_budget_bytes if kv_budget_bytes is not None
                      else (worst - 1) * block_bytes)
            if budget < block_bytes:
                raise ValueError(
                    f"KV budget {budget} B below one block "
                    f"({block_bytes} B): nothing could ever be admitted")
            ledger = DeviceMemory(-1, budget)
        self.ledger = ledger
        if n_blocks is None:
            # never allocate pages the byte budget can't admit anyway
            worst = max(2, min(worst,
                               int(ledger.budget) // block_bytes + 1))
        self.pool = BlockPool(cfg, worst, block_size, self.device)
        self.budget = PagedKVBudget(ledger, self.pool.block_bytes)
        self.paged_impl = paged_impl or kops.default_paged_impl(self.device)
        self._decode = make_paged_decode_step(cfg, window=window,
                                              impl=self.paged_impl)
        self._tables = np.full((capacity, self.max_blocks),
                               BlockPool.GARBAGE, np.int32)
        self._lengths = np.zeros((capacity,), np.int32)
        self._lane_free = list(range(capacity - 1, -1, -1))
        self._lane_blocks: dict[int, list[int]] = {}   # logical -> physical
        self._lane_owned: dict[int, set[int]] = {}     # charge-owned blocks
        self._committed_blocks = 0   # sum of active reservations + orphans
        # prefix index: full-block token chains -> physical block, plus a
        # parent-chain children map for boundary (partial-block) matches
        self._index: dict[bytes, int] = {}
        self._children: dict[bytes, list[int]] = {}
        self._block_tokens: dict[int, np.ndarray] = {}
        self._rev: dict[int, tuple] = {}               # bid -> (key, parent)
        self._orphans: set[int] = set()  # charged blocks whose owner retired
        # preemption parking lot: request_id -> (blocks, owned, length);
        # blocks stay refcounted and bytes stay charged while parked
        self._preempted: dict[str, tuple[list[int], set[int], int]] = {}
        self.shared_block_hits = 0       # blocks aliased instead of allocated
        self.cow_copies = 0              # copy-on-write block copies

    # -- sizing --------------------------------------------------------------
    def _prefill_width(self, prefill_rows: int) -> int:
        """Contiguous rows the prefill writes, rounded up to whole blocks."""
        return blocks_for_rows(prefill_rows,
                               self.block_size) * self.block_size

    def _worst_blocks(self, req: Request, prefill_rows: int) -> int:
        """Blocks for the WORST CASE this request can touch: its prefill
        footprint or its full decode extent, whichever is larger."""
        rows = max(self._prefill_width(prefill_rows),
                   req.prompt_len + req.max_new_tokens - 1)
        return blocks_for_rows(rows, self.block_size)

    @property
    def free_lanes(self) -> int:
        return len(self._lane_free)

    # -- prefix matching -----------------------------------------------------
    def _chain_keys(self, prompt: np.ndarray, n_full: int) -> list[bytes]:
        """Cumulative-content keys for the prompt's full blocks: key[j]
        digests tokens [0, (j+1)*bs)."""
        h = hashlib.sha256()
        keys = []
        bs = self.block_size
        for j in range(n_full):
            h.update(prompt[j * bs:(j + 1) * bs].tobytes())
            keys.append(h.digest())
        return keys

    _ROOT = b"root"          # parent key of block 0's chain

    def _match_prefix(self, prompt: np.ndarray):
        """Physical blocks this prompt can alias: the longest run of fully
        covered prompt blocks whose token chains are indexed, plus (when
        every full block matched) a boundary block whose indexed tokens
        start with the prompt's partial tail."""
        if not self.prefix_share:
            return [], None
        bs = self.block_size
        plen = int(prompt.shape[0])
        n_full = plen // bs
        keys = self._chain_keys(prompt, n_full)
        aliased: list[int] = []
        for j in range(n_full):
            bid = self._index.get(keys[j])
            if bid is None:
                break
            aliased.append(bid)
        boundary = None
        tail = plen - n_full * bs
        if tail and len(aliased) == n_full:
            parent = keys[n_full - 1] if n_full else self._ROOT
            for bid in self._children.get(parent, ()):
                toks = self._block_tokens.get(bid)
                if toks is not None and toks.shape[0] >= tail \
                        and bool((toks[:tail] == prompt[n_full * bs:]).all()):
                    boundary = bid
                    break
        return aliased, boundary

    def _register_prefix(self, req: Request, n_aliased: int,
                         boundary_aliased: bool) -> None:
        """Index this request's OWNED prompt blocks so later arrivals can
        alias them."""
        if not self.prefix_share:
            return
        bs = self.block_size
        prompt = req.prompt
        plen = req.prompt_len
        blocks = self._lane_blocks[req.slot]
        n_full = plen // bs
        keys = self._chain_keys(prompt, n_full)
        for j in range(n_aliased, n_full):
            bid = blocks[j]
            key = keys[j]
            parent = keys[j - 1] if j else self._ROOT
            self._index[key] = bid
            self._children.setdefault(parent, []).append(bid)
            self._block_tokens[bid] = prompt[j * bs:(j + 1) * bs]
            self._rev[bid] = (key, parent)
        tail = plen - n_full * bs
        if tail and not boundary_aliased and n_full < len(blocks):
            bid = blocks[n_full]
            parent = keys[n_full - 1] if n_full else self._ROOT
            self._children.setdefault(parent, []).append(bid)
            self._block_tokens[bid] = prompt[n_full * bs:plen]
            self._rev[bid] = (None, parent)

    def _unindex(self, bid: int) -> None:
        entry = self._rev.pop(bid, None)
        if entry is None:
            return
        key, parent = entry
        if key is not None:
            self._index.pop(key, None)
        kids = self._children.get(parent)
        if kids is not None:
            kids.remove(bid)
            if not kids:
                del self._children[parent]
        self._block_tokens.pop(bid, None)

    # -- admission -----------------------------------------------------------
    def admission_check(self, req: Request, prefill_rows: int) -> None:
        """Reject requests that can NEVER fit even unshared."""
        nb = self._worst_blocks(req, prefill_rows)
        if nb > self.pool.n_allocatable \
                or nb * self.pool.block_bytes > self.ledger.budget:
            raise ValueError(
                f"request needs {nb} KV blocks "
                f"({nb * self.pool.block_bytes} B) but the engine can "
                f"never admit more than {self.pool.n_allocatable} "
                f"blocks / {self.ledger.budget} B — raise the KV "
                "budget or lower max_new_tokens")

    def reserve(self, req: Request, prefill_rows: int) -> bool:
        nb_worst = self._worst_blocks(req, prefill_rows)
        aliased, boundary = self._match_prefix(req.prompt)
        # fully shared blocks are never written by this request, so only
        # unshared blocks are charged; an aliased boundary block still
        # charges one block — its copy-on-write copy
        need = nb_worst - len(aliased)
        if self._committed_blocks + need > self.pool.n_allocatable:
            return False
        if not self.budget.reserve(need):
            return False
        req.reserved_blocks = need
        self._committed_blocks += need
        lane = self._lane_free.pop()
        nb0 = self._prefill_width(prefill_rows) // self.block_size
        owned = self.pool.alloc(nb0 - len(aliased) - bool(boundary))
        blocks = [self.pool.incref(b) for b in aliased]
        if boundary is not None:
            blocks.append(self.pool.incref(boundary))
        self.shared_block_hits += len(blocks)
        req.shared_blocks = len(blocks)
        blocks.extend(owned)
        self._lane_blocks[lane] = blocks
        self._lane_owned[lane] = set(owned)
        self._tables[lane, :] = BlockPool.GARBAGE
        self._tables[lane, :nb0] = blocks
        self._lengths[lane] = 0
        req.peak_blocks = nb0
        req.slot = lane
        self._register_prefix(req, len(aliased), boundary is not None)
        return True

    # -- retirement ----------------------------------------------------------
    def _drop_alias(self, bid: int) -> None:
        """Drop a non-owned reference; if that frees the block, settle the
        orphan charge its dead owner left behind."""
        if self.pool.decref(bid) == 0:
            self._unindex(bid)
            if bid in self._orphans:
                self._orphans.discard(bid)
                self.budget.release(1)
                self._committed_blocks -= 1

    def _release_blocks(self, blocks: list[int], owned: set[int],
                        reserved_blocks: int) -> None:
        """Settle a retiring block set's refcounts + byte charge."""
        orphaned = 0
        for bid in blocks:
            if bid in owned:
                if self.pool.decref(bid) == 0:
                    self._unindex(bid)
                else:
                    # still aliased by a live sharer: the charge stays
                    # alive as an orphan until the last reference drops
                    self._orphans.add(bid)
                    orphaned += 1
            else:
                self._drop_alias(bid)
        self.budget.release(reserved_blocks - orphaned)
        self._committed_blocks -= reserved_blocks - orphaned

    def release(self, req: Request) -> None:
        lane = req.slot
        self._release_blocks(self._lane_blocks.pop(lane),
                             self._lane_owned.pop(lane),
                             req.reserved_blocks)
        self._tables[lane, :] = BlockPool.GARBAGE
        self._lengths[lane] = 0
        self._lane_free.append(lane)

    # -- preemption ----------------------------------------------------------
    def preempt(self, req: Request) -> None:
        """Deschedule a RUNNING request: park (block table, committed
        length) under its request_id and free the lane.  Refcounts and the
        byte reservation are untouched, so resume needs only a lane."""
        lane = req.slot
        self._preempted[req.request_id] = (
            self._lane_blocks.pop(lane), self._lane_owned.pop(lane),
            int(self._lengths[lane]))
        self._tables[lane, :] = BlockPool.GARBAGE
        self._lengths[lane] = 0
        self._lane_free.append(lane)

    def resume(self, req: Request) -> bool:
        """Re-attach a preempted request's snapshot to a free lane; the
        caller skips prefill and resumes decode from the last token."""
        if not self._lane_free:
            return False
        blocks, owned, length = self._preempted.pop(req.request_id)
        lane = self._lane_free.pop()
        self._lane_blocks[lane] = blocks
        self._lane_owned[lane] = owned
        self._tables[lane, :] = BlockPool.GARBAGE
        self._tables[lane, :len(blocks)] = blocks
        self._lengths[lane] = length
        req.slot = lane
        return True

    def discard_preempted(self, req: Request) -> None:
        """Drop a parked snapshot without resuming (cancel / shed while
        preempted); no-op for requests that never held one."""
        parked = self._preempted.pop(req.request_id, None)
        if parked is None:
            return
        blocks, owned, _ = parked
        self._release_blocks(blocks, owned, req.reserved_blocks)

    def can_admit_bytes(self, req: Request, prefill_rows: int) -> bool:
        """Byte-side admissibility if a lane WERE free (preemption guard)."""
        if req.request_id in self._preempted:
            return True      # bytes still charged from first admission
        aliased, _ = self._match_prefix(req.prompt)
        need = self._worst_blocks(req, prefill_rows) - len(aliased)
        return (self._committed_blocks + need <= self.pool.n_allocatable
                and self.budget.can_reserve(need))

    # -- prefill -------------------------------------------------------------
    def fresh_states(self, n: int, prefill_rows: int):
        """One zeroed contiguous state for a prefill group of ``n``: K/V
        planes of (L, n, W, nkv, hd), W the block-aligned prompt width —
        just wide enough for the prompts; the rows are scattered into
        pages and the temporary is dropped."""
        width = self._prefill_width(prefill_rows)
        return api.init_decode_state(self.cfg, n, width, self.device)

    def write_prefill(self, group: Sequence[Request], states) -> None:
        """Scatter a prefilled contiguous group into the block pool pages.
        Aliased blocks are redirected to the garbage block: their owner
        already wrote identical rows (same tokens, same positions)."""
        ids = np.concatenate([
            [bid if bid in self._lane_owned[r.slot] else BlockPool.GARBAGE
             for bid in self._lane_blocks[r.slot]]
            for r in group]).astype(np.int64)
        _page_scatter(self.pool.pages, states["kv"]["k"], states["kv"]["v"],
                      torch.from_numpy(ids).to(self.device))
        for r in group:
            self._lengths[r.slot] = r.prompt_len

    # -- decode --------------------------------------------------------------
    def _prepare_lanes(self, active: dict) -> None:
        """Make every active lane's next write row safe: allocate the block
        it lands in (the admission reservation guarantees this can never
        fail), and copy-on-write an aliased block about to be written."""
        for lane, req in active.items():
            j = int(self._lengths[lane]) // self.block_size
            blocks = self._lane_blocks[lane]
            owned = self._lane_owned[lane]
            while len(blocks) <= j:
                (bid,) = self.pool.alloc(1)
                self._tables[lane, len(blocks)] = bid
                blocks.append(bid)
                owned.add(bid)
            if blocks[j] not in owned:
                (dst,) = self.pool.alloc(1)
                src = blocks[j]
                _page_copy(self.pool.pages, src, dst)
                self._tables[lane, j] = dst
                blocks[j] = dst
                owned.add(dst)
                self.cow_copies += 1
                self._drop_alias(src)
            req.peak_blocks = max(req.peak_blocks or 0, len(blocks))

    def decode(self, params, tokens: np.ndarray, active: dict) -> np.ndarray:
        self._prepare_lanes(active)
        dev = self.device
        ntoks = self._decode(params, self.pool.pages,
                             torch.from_numpy(self._tables).to(dev),
                             torch.from_numpy(self._lengths).to(dev),
                             torch.from_numpy(tokens[:, 0, :]).to(dev))
        return ntoks.cpu().numpy().astype(np.int32)[:, None, :]

    def advance(self, lane: int) -> None:
        self._lengths[lane] += 1

    def summary(self) -> dict:
        return {
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "block_bytes": self.pool.block_bytes,
            "n_blocks": self.pool.n_blocks,
            "kv_page_peak_bytes": self.pool.peak_bytes(),
            "kv_block_allocs": self.pool.total_allocs,
            "paged_impl": self.paged_impl,
            "prefix_share": self.prefix_share,
            "shared_block_hits": self.shared_block_hits,
            "cow_copies": self.cow_copies,
            "preempted_held": len(self._preempted),
        }


BACKENDS = {"paged": PagedBackend}


def make_backend(name: str, cfg, capacity: int, max_seq: int, **kw):
    """Construct a backend by name."""
    if name in LATER:
        raise NotImplementedError(LATER[name])
    if name not in BACKENDS:
        raise ValueError(f"unknown decode backend {name!r} "
                         f"(have {sorted(BACKENDS)})")
    return BACKENDS[name](cfg, capacity, max_seq, **kw)
