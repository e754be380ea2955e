"""Decode backends (port of ``repro.serving.backends``: the slot, paged and
speculative backends).

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

Three implementations:

* ``SlotBackend`` — every request owns a ``max_seq``-sized lane of one
  per-lane contiguous decode state (``serving/slots.py``); admission
  charges a constant ``slot_bytes``.
* ``PagedBackend`` — K/V lives in a refcounted ``BlockPool`` of
  fixed-size blocks on the serving device (fp, or int8 with per-row
  scales); admission reserves only the blocks a request's prompt +
  decode extent can touch, charged against a ``DeviceMemory`` ledger.
  Requests with a common block-aligned prompt prefix alias the same
  physical blocks (copy-on-write: the first write past the shared extent
  copies the boundary block).
* ``SpecDecodeBackend`` — speculative decoding over an inner slot or
  paged backend: a draft model proposes ``draft_k`` greedy tokens per
  round, the target verifies all of them in ONE batched forward, and
  greedy-exact acceptance keeps outputs token-identical to plain decode.

Every state write — prefill scatter, copy-on-write copy, per-step row
write, slot copy — updates the backend's tensors in place, where the JAX
package donates them to a jitted program and gets an updated copy back.
Host-DRAM tiering is a later slice of the port; asking for it raises
``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.spilling import DeviceMemory
from repro_torch.models import api
from repro_torch.models.registry import spec as family_spec
from repro_torch.serving.paging import (BlockPool, blocks_for_rows,
                                        default_n_blocks)
from repro_torch.serving.queue import KVBudget, PagedKVBudget
from repro_torch.serving.request import Request
from repro_torch.serving.slots import SlotPool, stack_trees, write_slots
from repro_torch.training.train_loop import (make_decode_step,
                                             make_paged_decode_step,
                                             make_paged_verify_step,
                                             make_prefill_into_cache,
                                             make_verify_step)

# paged decode impls: the attention kernel, its plain version, and the
# fused decode layer (``models.transformer.paged_decode_step``)
PAGED_IMPLS = ("cuda", "ref", "fused")
TIERED_LATER = ("host-DRAM KV tiering is ported in a later slice of the "
                "PyTorch port")


def _page_scatter(pages, k_new, v_new, ids) -> None:
    """Scatter freshly prefilled contiguous KV rows into physical blocks,
    in place.  k/v_new: (L, n, W, nkv, hd) prefill state, W a multiple of
    the block size; ids: (n * W/bs,) physical block per logical block, all
    requests concatenated (aliased blocks are redirected to the garbage
    block — their owner already holds identical rows).  An int8 pool
    quantizes the rows per row on the way in and lands the scales in the
    scale planes: prefill states stay fp, only the pool is int8."""
    from repro_torch.kernels.ref import quantize_kv
    L, n, W, nkv, hd = k_new.shape
    bs = pages["k"].shape[2]
    for name, new in (("k", k_new), ("v", v_new)):
        rows = new.reshape(L, n * (W // bs), bs, nkv, hd)
        if f"{name}_scale" in pages:
            q8, scale = quantize_kv(rows)
            pages[name][:, ids] = q8
            pages[f"{name}_scale"][:, ids] = scale
        else:
            pages[name][:, ids] = rows.to(pages[name].dtype)


def _page_copy(pages, src: int, dst: int) -> None:
    """Copy one physical block's rows (all layers, every pages plane —
    scale planes included for int8 pools) src -> dst in place: the
    copy-on-write primitive."""
    for p in pages.values():
        p[:, dst] = p[:, src]


# ---------------------------------------------------------------------------
# slot backend
# ---------------------------------------------------------------------------

class SlotBackend:
    """Fixed slot pool: constant ``slot_bytes`` admission."""

    name = "slot"
    preemptible = False
    preempt_reason = ("slot KV is one contiguous per-lane buffer — "
                      "descheduling would copy the whole cache out or "
                      "replay the prompt; use backend='paged'")

    def __init__(self, cfg, capacity: int, max_seq: int, *,
                 window: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None, ledger=None,
                 verify_headroom: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        # verify_headroom: extra rows per slot for a wrapping speculative
        # backend's k-token verify writes (rows past the accept point are
        # rewound, but the buffer must exist); charged honestly
        self.slot_bytes = family_spec(cfg).decode_state_bytes(
            cfg, 1, max_seq + verify_headroom)
        self.pool = SlotPool(cfg, capacity, max_seq + verify_headroom,
                             self.device)
        self.ledger = ledger
        if ledger is not None:
            if kv_budget_bytes is not None:
                raise ValueError(
                    "pass either a shared DeviceMemory ledger or a private "
                    "kv_budget_bytes, not both")
            # slot-granular reservations against the shared device ledger
            self.budget = PagedKVBudget(ledger, self.slot_bytes)
        else:
            self.budget = KVBudget(kv_budget_bytes, self.slot_bytes)
        self._decode = make_decode_step(cfg, window=window)

    @property
    def free_lanes(self) -> int:
        return self.pool.n_free

    def admission_check(self, req: Request, prefill_rows: int) -> None:
        if isinstance(self.budget, PagedKVBudget) \
                and self.slot_bytes > self.ledger.budget:
            raise ValueError(
                f"one decode slot costs {self.slot_bytes} B but the ledger "
                f"budget is {self.ledger.budget} B — the engine can never "
                "admit this request")

    def _reserve_one(self) -> bool:
        if isinstance(self.budget, PagedKVBudget):
            return self.budget.reserve(1)
        return self.budget.reserve()

    def reserve(self, req: Request, prefill_rows: int) -> bool:
        if not self._reserve_one():
            return False
        req.slot = self.pool.alloc(req.request_id)
        return True

    def release(self, req: Request) -> None:
        self.pool.free(req.slot)
        if isinstance(self.budget, PagedKVBudget):
            self.budget.release(1)
        else:
            self.budget.release()

    def fresh_states(self, n: int, prefill_rows: int):
        return self.pool.fresh_states(n)

    def write_prefill(self, group: Sequence[Request], states) -> None:
        write_slots(self.pool.state, states, [r.slot for r in group])

    def decode(self, params, tokens: np.ndarray, active: dict) -> np.ndarray:
        toks = torch.from_numpy(tokens[:, 0, :]).to(self.device)
        ntoks, self.pool.state = self._decode(params, self.pool.state, toks)
        return ntoks.cpu().numpy().astype(np.int32)[:, None, :]

    def advance(self, lane: int) -> None:
        pass

    def summary(self) -> dict:
        return {}


# ---------------------------------------------------------------------------
# paged backend (block-granular admission + copy-on-write prefix sharing)
# ---------------------------------------------------------------------------

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
                 prefix_share: bool = True, verify_headroom: int = 0,
                 kv_dtype: Optional[str] = None,
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
        # kv_dtype='int8' quantizes the pool (per-row scales beside the
        # pages), validated and priced through the kv_quant capability
        self.kv_dtype = "fp" if kv_dtype in (None, "fp") else kv_dtype
        # extra rows per lane a wrapping speculative backend's k-token
        # verify may transiently write past the decode extent; folded into
        # every worst-case reservation so verify allocation can never fail
        self.verify_headroom = verify_headroom
        self.max_blocks = blocks_for_rows(max_seq + verify_headroom,
                                          block_size)
        block_bytes = family_spec(cfg).kv_block_bytes(cfg, block_size,
                                                      self.kv_dtype)
        worst = default_n_blocks(capacity, max_seq + verify_headroom,
                                 block_size, n_blocks)
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
        self.pool = BlockPool(cfg, worst, block_size, self.device,
                              self.kv_dtype)
        self.budget = PagedKVBudget(ledger, self.pool.block_bytes)
        if paged_impl not in (None, *PAGED_IMPLS):
            raise ValueError(f"paged_impl={paged_impl!r}: expected one of "
                             f"{PAGED_IMPLS} ('fused' is the fused decode "
                             "layer: its kernel on a CUDA device, its plain "
                             "version on the CPU)")
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
        footprint or its full decode extent (plus any speculative verify
        headroom), whichever is larger."""
        rows = max(self._prefill_width(prefill_rows),
                   req.prompt_len + req.max_new_tokens - 1
                   + self.verify_headroom)
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
    def _prepare_lanes(self, active: dict, n_rows: int = 1) -> None:
        """Make every active lane's next ``n_rows`` write rows safe:
        allocate the blocks they land in (the admission reservation —
        which includes ``verify_headroom`` — guarantees this can never
        fail), and copy-on-write any aliased block about to be written."""
        for lane, req in active.items():
            lo = int(self._lengths[lane]) // self.block_size
            hi = (int(self._lengths[lane]) + n_rows - 1) // self.block_size
            blocks = self._lane_blocks[lane]
            owned = self._lane_owned[lane]
            for j in range(lo, hi + 1):
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

    def _rewind_lane(self, lane: int) -> int:
        """Free owned tail blocks past the lane's committed rows — the
        speculative-decode rollback: verify wrote up to k rows past the
        accept point, and whole blocks holding only rejected rows go back
        to the pool (rejected rows inside a kept block are masked and
        overwritten as decode resumes).  Returns blocks freed."""
        needed = max(1, blocks_for_rows(int(self._lengths[lane]),
                                        self.block_size))
        blocks = self._lane_blocks[lane]
        owned = self._lane_owned[lane]
        freed = 0
        while len(blocks) > needed:
            bid = blocks[-1]
            if bid not in owned or self.pool.ref(bid) != 1 \
                    or bid in self._rev:
                break       # shared or indexed blocks are never speculative
            blocks.pop()
            self._tables[lane, len(blocks)] = BlockPool.GARBAGE
            owned.discard(bid)
            self.pool.decref(bid)
            freed += 1
        return freed

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


# ---------------------------------------------------------------------------
# speculative-decode backend (draft model + batched target verify)
# ---------------------------------------------------------------------------

class SpecDecodeBackend:
    """Speculative decode over an inner slot or paged backend.

    Per round, a *draft* model proposes ``draft_k`` greedy tokens ahead of
    the target, then the target scores all k positions in ONE batched
    verify forward (``models/api.verify_step``; the paged variant reads
    K/V through block tables, via the ``paged_verify_lanes`` kernel on a
    card).  Acceptance is greedy-exact: the longest prefix where the draft
    matches the target's own argmax is kept, plus the target's correction
    token — so emitted tokens are token-identical to target-only greedy
    decode, and each verify forward yields between 1 and k tokens.

    Rollback past the accept point: the slot inner rewinds per-lane cache
    indices (rejected rows are masked and overwritten); the paged inner
    advances lane lengths by only the accepted rows and frees whole tail
    blocks holding nothing but rejected rows.

    Memory: the inner backend is built with ``verify_headroom=draft_k``,
    and when a byte ledger backs the job (a shared ledger, or the paged
    inner's private one) each admission also reserves the draft model's
    decode-state bytes.

    The engine contract is unchanged (one token per active lane per
    ``decode()`` call): rounds run only for lanes whose emitted-token
    buffer ran dry, and every call pops one buffered token per lane.
    Lanes not in the round ride through the batched draft/verify steps
    with their writes parked in the garbage block / rewound, outputs
    discarded.

    Degraded mode (``set_degraded(True)``, the SLO scheduler's soft-
    overload shed): the draft model stops running and rounds propose the
    last token repeated.  Acceptance still emits only the target's own
    argmax tokens, so outputs stay identical; the accept rate collapses
    toward plain decode.
    """

    name = "spec"
    preemptible = False
    preempt_reason = ("the draft model's decode state advances in "
                      "lockstep with the target — snapshotting both "
                      "mid-round is not supported; use backend='paged'")

    def __init__(self, cfg, capacity: int, max_seq: int, *,
                 draft_cfg=None, draft_params=None, draft_k: int = 4,
                 inner: str = "slot", window: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None, ledger=None,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 paged_impl: Optional[str] = None,
                 prefix_share: bool = True,
                 kv_dtype: Optional[str] = None,
                 verify_impl: Optional[str] = None, device="cuda"):
        if draft_cfg is None or draft_params is None:
            raise ValueError(
                "the spec backend needs a draft member model: pass "
                "draft_cfg and draft_params")
        tspec, dspec = family_spec(cfg), family_spec(draft_cfg)
        if not tspec.spec_draftable:
            raise ValueError(
                f"{cfg.name} ({cfg.family}): "
                f"{tspec.why_not('spec_draftable')}")
        if not dspec.spec_draftable:
            raise ValueError(
                f"draft {draft_cfg.name} ({draft_cfg.family}): "
                f"{dspec.why_not('spec_draftable')} — the draft must run "
                "the same rollback-able batched decode surface")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: greedy-exact acceptance compares "
                "token ids, so the models must share a tokenizer")
        if draft_k < 1:
            raise ValueError("draft_k must be >= 1")
        if inner not in ("slot", "paged"):
            raise ValueError(f"spec inner backend {inner!r}: "
                             "expected 'slot' or 'paged'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.draft_cfg = draft_cfg
        self.draft_params = api.prepare_params(draft_cfg, draft_params,
                                               self.device)
        self.draft_k = draft_k
        inner_kw: dict = dict(window=window, verify_headroom=draft_k,
                              kv_budget_bytes=kv_budget_bytes,
                              ledger=ledger, device=self.device)
        if inner == "paged":
            inner_kw.update(block_size=block_size, n_blocks=n_blocks,
                            paged_impl=paged_impl,
                            prefix_share=prefix_share, kv_dtype=kv_dtype)
        elif kv_dtype not in (None, "fp"):
            raise ValueError(
                f"kv_dtype={kv_dtype!r} needs the paged block pool: serve "
                "with inner='paged' (the slot inner keeps contiguous fp "
                "decode state)")
        self.inner = BACKENDS[inner](cfg, capacity, max_seq, **inner_kw)
        # draft decode state: one per-lane state over the same lane ids the
        # inner backend assigns; k extra rows absorb the round's writes.
        # Its bytes reserve against whatever byte ledger backs the job —
        # the shared ledger, or the paged inner's private one; a slot
        # inner with a private kv_budget_bytes has no byte ledger, so that
        # budget bounds target slots only.
        self._charge_ledger = (ledger if ledger is not None
                               else getattr(self.inner, "ledger", None))
        self.draft_slot_bytes = dspec.decode_state_bytes(
            draft_cfg, 1, max_seq + draft_k)
        self._draft_width = max_seq + draft_k
        self._draft_state = stack_trees(
            [api.init_decode_state(draft_cfg, 1, self._draft_width,
                                   self.device)] * capacity)
        self._draft_step = make_decode_step(draft_cfg)
        self._draft_prefill = make_prefill_into_cache(draft_cfg)
        if inner == "slot":
            if verify_impl is not None:
                raise ValueError(
                    f"verify_impl={verify_impl!r} selects a paged verify "
                    "kernel: serve with inner='paged' (the slot inner "
                    "verifies against contiguous decode state)")
            self.verify_impl = None
            self._verify = make_verify_step(cfg, window=window)
        else:
            # default: verify through whatever impl decode uses — on a
            # card, the multi-query kernel scores all k draft rows through
            # the block tables in one launch per layer
            self.verify_impl = verify_impl or self.inner.paged_impl
            self._verify = make_paged_verify_step(cfg, window=window,
                                                  impl=self.verify_impl)
        self._pending: dict[int, deque] = {}    # lane -> emitted tokens
        self.degraded = False       # soft-overload shed: draft model off
        # round stats (summary)
        self.spec_rounds = 0        # batched verify forwards
        self.target_steps = 0       # per-lane verify participations
        self.draft_steps = 0        # per-lane draft tokens proposed
        self.spec_tokens = 0        # tokens emitted by spec rounds
        self.drafts_accepted = 0    # proposed drafts that matched target
        self.degraded_rounds = 0    # rounds run with the draft shed

    # -- introspection delegates (engine compat properties read these) -------
    @property
    def pool(self):
        return self.inner.pool

    @property
    def budget(self):
        return self.inner.budget

    @property
    def ledger(self):
        return getattr(self.inner, "ledger", None)

    @property
    def block_size(self):
        return getattr(self.inner, "block_size", None)

    @property
    def paged_impl(self):
        return getattr(self.inner, "paged_impl", None)

    @property
    def free_lanes(self) -> int:
        return self.inner.free_lanes

    # -- admission ------------------------------------------------------------
    def _worst_target_bytes(self, req: Request, prefill_rows: int) -> int:
        if isinstance(self.inner, PagedBackend):
            return self.inner._worst_blocks(req, prefill_rows) \
                * self.inner.pool.block_bytes
        return self.inner.slot_bytes

    def admission_check(self, req: Request, prefill_rows: int) -> None:
        self.inner.admission_check(req, prefill_rows)
        if self._charge_ledger is not None:
            need = self.draft_slot_bytes \
                + self._worst_target_bytes(req, prefill_rows)
            if need > self._charge_ledger.budget:
                raise ValueError(
                    f"speculative decode needs {need} B (draft state "
                    f"{self.draft_slot_bytes} B + target KV incl. "
                    f"{self.draft_k}-token verify headroom) but the ledger "
                    f"budget is {self._charge_ledger.budget} B — the "
                    "engine can never admit this request")

    def reserve(self, req: Request, prefill_rows: int) -> bool:
        if self._charge_ledger is not None \
                and not self._charge_ledger.reserve_kv(self.draft_slot_bytes):
            return False
        if not self.inner.reserve(req, prefill_rows):
            if self._charge_ledger is not None:
                self._charge_ledger.release_kv(self.draft_slot_bytes)
            return False
        self._pending[req.slot] = deque()
        return True

    def release(self, req: Request) -> None:
        # unconsumed pending tokens (overshoot past max_new_tokens / eos)
        # are discarded with the lane
        self._pending.pop(req.slot, None)
        self.inner.release(req)
        if self._charge_ledger is not None:
            self._charge_ledger.release_kv(self.draft_slot_bytes)

    # -- prefill --------------------------------------------------------------
    def fresh_states(self, n: int, prefill_rows: int):
        return self.inner.fresh_states(n, prefill_rows)

    def set_degraded(self, flag: bool) -> None:
        """Shed (or restore) the draft model — the SLO policy's soft-
        overload lever.  Takes effect at the next round."""
        self.degraded = bool(flag)

    def write_prefill(self, group: Sequence[Request], states) -> None:
        self.inner.write_prefill(group, states)
        if self.degraded:
            return      # draft shed: skip its prefill (lanes admitted now
            # draft garbage if un-degraded later — acceptance, never
            # correctness)
        # the draft model prefills the same prompts into its own lanes at
        # exact lengths (one batched call per same-length subgroup); its
        # prefill logits are unused — the first token is the target's
        by_len: dict[int, list[Request]] = {}
        for r in group:
            by_len.setdefault(r.prompt_len, []).append(r)
        for plen, reqs in sorted(by_len.items()):
            toks = torch.from_numpy(
                np.stack([r.prompt for r in reqs]).astype(np.int64)
            ).to(self.device)
            fresh = api.init_decode_state(self.draft_cfg, len(reqs),
                                          self._draft_width, self.device)
            _, dstates = self._draft_prefill(self.draft_params, fresh, toks)
            write_slots(self._draft_state, dstates, [r.slot for r in reqs])

    # -- decode ---------------------------------------------------------------
    def decode(self, params, tokens: np.ndarray, active: dict) -> np.ndarray:
        todo = {lane: req for lane, req in active.items()
                if not self._pending[lane]}
        if todo:
            self._spec_round(params, tokens, todo)
        out = np.zeros_like(tokens)
        for lane in active:
            out[lane, 0, 0] = self._pending[lane].popleft()
        return out

    def _draft_chain(self, t_last: np.ndarray) -> np.ndarray:
        """k sequential greedy draft steps over every lane (fixed width;
        non-participants are rolled back after the round); one host sync.
        Returns drafts (cap, k)."""
        toks = torch.from_numpy(t_last[:, None]).to(self.device)
        drafts = []
        for _ in range(self.draft_k):
            toks, self._draft_state = self._draft_step(
                self.draft_params, self._draft_state, toks)
            drafts.append(toks)
        return torch.cat(drafts, dim=1).cpu().numpy()

    def _spec_round(self, params, tokens: np.ndarray, todo: dict) -> None:
        """One draft+verify round for the lanes whose buffers ran dry."""
        k = self.draft_k
        cap = self.capacity
        dev = self.device
        t_last = tokens[:, 0, 0].astype(np.int64)            # (cap,)
        # 1. draft k greedy tokens per lane (degraded: the draft model is
        #    shed — propose the last token repeated; the verify below still
        #    emits >= 1 exact target token per round)
        if self.degraded:
            dr = np.repeat(t_last[:, None], k, axis=1)
        else:
            dr = self._draft_chain(t_last)                   # (cap, k)
        # 2. verify all k positions in ONE batched target forward: feed
        #    [t_last, d_1 .. d_{k-1}]; position i's argmax is the target's
        #    own next token after t_last, d_1 .. d_i
        V = torch.from_numpy(
            np.concatenate([t_last[:, None], dr[:, :k - 1]], axis=1)
        ).to(dev)
        if isinstance(self.inner, PagedBackend):
            # make the k write rows safe for participants (alloc + CoW —
            # the admission reservation includes the verify headroom) and
            # park non-participants' writes in the garbage block
            self.inner._prepare_lanes(todo, n_rows=k)
            tables = self.inner._tables.copy()
            outside = np.ones(cap, bool)
            outside[list(todo)] = False
            tables[outside, :] = BlockPool.GARBAGE
            g = self._verify(params, self.inner.pool.pages,
                             torch.from_numpy(tables).to(dev),
                             torch.from_numpy(self.inner._lengths).to(dev),
                             V)
        else:
            g, self.inner.pool.state = self._verify(
                params, self.inner.pool.state, V)
        g = g.cpu().numpy()                                  # (cap, k)
        # 3. greedy-exact acceptance: longest matching prefix + the
        #    target's correction (or the free k-th draft on a clean sweep)
        m = np.cumprod(dr == g, axis=1).sum(axis=1)          # leading matches
        accept = np.zeros(cap, np.int64)
        for lane in todo:
            accept[lane] = m[lane] + 1 if m[lane] < k else k
        for lane in todo:
            self._pending[lane].extend(
                int(t) for t in g[lane, :accept[lane]])
        # 4. roll both models back past the accept point (degraded: the
        #    draft never stepped, so only the target rewinds)
        delta = torch.from_numpy(k - accept).to(dev)
        if not self.degraded:
            self._draft_state = api.rollback_decode_state(
                self.draft_cfg, self._draft_state, delta)
        if isinstance(self.inner, PagedBackend):
            for lane in todo:
                self.inner._lengths[lane] += int(accept[lane])
                self.inner._rewind_lane(lane)
        else:
            self.inner.pool.state = api.rollback_decode_state(
                self.cfg, self.inner.pool.state, delta)
        # 5. stats (degraded rounds propose nothing, so they count no
        #    draft steps and no acceptances)
        self.spec_rounds += 1
        self.target_steps += len(todo)
        if self.degraded:
            self.degraded_rounds += 1
        else:
            self.draft_steps += len(todo) * k
            self.drafts_accepted += int(m[list(todo)].sum())
        self.spec_tokens += int(accept.sum())

    def advance(self, lane: int) -> None:
        pass        # rounds advance lengths/indices at the accept point

    def summary(self) -> dict:
        out = {
            "inner_backend": self.inner.name,
            "draft_model": self.draft_cfg.name,
            "draft_k": self.draft_k,
            "draft_slot_bytes": self.draft_slot_bytes,
            "verify_impl": self.verify_impl,
            "spec_rounds": self.spec_rounds,
            "target_steps": self.target_steps,
            "draft_steps": self.draft_steps,
            "spec_tokens": self.spec_tokens,
            "accepted_tokens_per_target_step":
                round(self.spec_tokens / self.target_steps, 3)
                if self.target_steps else None,
            "draft_accept_rate":
                round(self.drafts_accepted / self.draft_steps, 3)
                if self.draft_steps else None,
            "degraded": self.degraded,
            "degraded_rounds": self.degraded_rounds,
        }
        out.update(self.inner.summary())
        return out


BACKENDS = {"slot": SlotBackend, "paged": PagedBackend,
            "spec": SpecDecodeBackend}

# kwargs each backend constructor understands (make_backend drops the rest
# so one engine call site can carry the union)
_BACKEND_KWARGS = {
    "slot": ("window", "kv_budget_bytes", "ledger", "verify_headroom",
             "device"),
    "paged": ("window", "kv_budget_bytes", "ledger", "block_size",
              "n_blocks", "paged_impl", "prefix_share", "verify_headroom",
              "tiered", "kv_dtype", "device"),
    "spec": ("window", "kv_budget_bytes", "ledger", "block_size",
             "n_blocks", "paged_impl", "prefix_share", "draft_cfg",
             "draft_params", "draft_k", "inner", "kv_dtype",
             "verify_impl", "device"),
}


def make_backend(name: str, cfg, capacity: int, max_seq: int, **kw):
    """Construct a backend by name, dropping kwargs it does not take."""
    if name not in BACKENDS:
        raise ValueError(f"unknown decode backend {name!r} "
                         f"(have {sorted(BACKENDS)})")
    kw = {k: v for k, v in kw.items() if k in _BACKEND_KWARGS[name]}
    return BACKENDS[name](cfg, capacity, max_seq, **kw)
