"""Fixed-capacity slot pool over one per-lane decode state (port of
``repro.serving.slots``).

The JAX package stacks batch-1 decode states on a leading slot axis and
vmaps the decode step over it.  The port holds ONE contiguous decode state
instead — K/V planes of ``(L, S, max_seq, nkv, hd)`` and a ``(S,)`` int64
write index, one row per slot (``stack_trees``) — and runs the decode step
over the whole batch: every lane writes its own row and attends its own
causal prefix (``models.layers.attention`` with a tensor index), so lane
``s`` computes exactly what a lone batch-1 request would.

Slot writes copy a freshly prefilled group's lanes into the pool in place;
a freed slot keeps its stale state until the next admission overwrites it,
so nothing leaks between occupants.
"""

from __future__ import annotations

import torch

from repro_torch.models import api


def _lane_index(index, n: int, device) -> torch.Tensor:
    if isinstance(index, torch.Tensor):
        return index.to(device=device, dtype=torch.int64)
    return torch.full((n,), int(index), dtype=torch.int64, device=device)


def stack_trees(states):
    """[decode state, ...] -> ONE per-lane decode state holding every lane
    of every input, in order: the K/V planes concatenate on the lane axis
    and each lane keeps its own write index (an input's shared int index
    is repeated over its lanes).  Where the JAX package stacks batch-1
    states on a new slot axis for ``vmap``, the port's decode step takes
    the per-lane index directly."""
    kvs = [s["kv"] for s in states]
    device = kvs[0]["k"].device
    return {"kv": {
        "k": torch.cat([kv["k"] for kv in kvs], dim=1),
        "v": torch.cat([kv["v"] for kv in kvs], dim=1),
        "index": torch.cat([_lane_index(kv["index"], kv["k"].shape[1],
                                        device) for kv in kvs])}}


def write_slots(pool, sub, slot_ids):
    """Copy the lanes of ``sub`` (n of them) into ``pool`` lanes
    ``slot_ids``, in place; returns ``pool``.  ``sub`` may be narrower than
    the pool (the rows past its width keep their stale contents, masked by
    the causal limit)."""
    kv, new = pool["kv"], sub["kv"]
    ids = torch.as_tensor(list(slot_ids), dtype=torch.int64,
                          device=kv["k"].device)
    width = new["k"].shape[2]
    for name in ("k", "v"):
        plane = kv[name]
        plane[:, ids, :width] = new[name].to(plane.dtype)
    kv["index"][ids] = _lane_index(new["index"], len(ids), ids.device)
    return pool


class SlotPool:
    """Free-list of decode-state slots + the per-lane state itself."""

    def __init__(self, cfg, capacity: int, max_seq: int, device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.device = device
        self.state = stack_trees(
            [api.init_decode_state(cfg, 1, max_seq, device)] * capacity)
        # pop() hands out low slot ids first (stable layouts in tests)
        self._free = list(range(capacity - 1, -1, -1))
        self.occupant: dict[int, str] = {}          # slot -> request_id

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, request_id: str) -> int:
        if not self._free:
            raise RuntimeError(
                f"SlotPool exhausted: all {self.capacity} slots occupied "
                f"({len(self.occupant)} active requests); admission must "
                "check n_free before alloc")
        slot = self._free.pop()
        self.occupant[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        del self.occupant[slot]
        self._free.append(slot)

    def fresh_states(self, n: int):
        """A zeroed state of ``n`` lanes at the slot width, for a group of
        requests about to be prefilled (one shared write index)."""
        return api.init_decode_state(self.cfg, n, self.max_seq, self.device)
