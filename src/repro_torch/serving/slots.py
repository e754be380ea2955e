"""Fixed-capacity slot pool over one per-lane decode state (port of
``repro.serving.slots``).

The JAX package stacks batch-1 decode states on a leading slot axis and
vmaps the decode step over it.  The port holds ONE decode state with a
lane axis instead, one lane per slot (``stack_trees``), and runs the
decode step over the whole batch.  Every family's state has the same
shape of tree: its tensor leaves are layer-first with the lane axis second
— dense K/V planes ``(L, S, max_seq, nkv, hd)``, the hybrid's Mamba2
states ``(L, S, ...)`` and shared-block K/V slots ``(A, S, ...)``, the
xLSTM group states ``(G, S, ...)`` — and its write positions (``index``,
``pos``) become ``(S,)`` int64 tensors, one per lane.  Every lane writes
its own rows and attends its own causal prefix (``models.layers.attention``
with a tensor index), so lane ``s`` computes exactly what a lone batch-1
request would.

Slot writes copy a freshly prefilled group's lanes into the pool in place;
a freed slot keeps its stale state until the next admission overwrites it,
so nothing leaks between occupants.
"""

from __future__ import annotations

import torch

from repro_torch.models import api

# the per-lane write positions of a decode state (an int shared by the
# batch, or a (b,) tensor); every other leaf is a tensor, lane axis 1
LANE_INDEX_KEYS = ("index", "pos")


def _lane_index(index, n: int, device) -> torch.Tensor:
    if isinstance(index, torch.Tensor):
        return index.to(device=device, dtype=torch.int64)
    return torch.full((n,), int(index), dtype=torch.int64, device=device)


def _planes(tree):
    """The tensor leaves of a decode state (write positions excluded)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _planes(v)
        elif k not in LANE_INDEX_KEYS:
            yield v


def stack_trees(states):
    """[decode state, ...] -> ONE per-lane decode state holding every lane
    of every input, in order: the tensor leaves concatenate on the lane
    axis (1) and each lane keeps its own write position (an input's shared
    int is repeated over its lanes).  Where the JAX package stacks batch-1
    states on a new slot axis for ``vmap``, the port's decode step takes
    the per-lane positions directly."""
    first = next(_planes(states[0]))
    device = first.device
    lanes = [next(_planes(s)).shape[1] for s in states]

    def cat(trees):
        out = {}
        for k, v in trees[0].items():
            vals = [t[k] for t in trees]
            if isinstance(v, dict):
                out[k] = cat(vals)
            elif k in LANE_INDEX_KEYS:
                out[k] = torch.cat([_lane_index(x, n, device)
                                    for x, n in zip(vals, lanes)])
            else:
                out[k] = torch.cat(vals, dim=1)
        return out

    return cat(list(states))


def write_slots(pool, sub, slot_ids):
    """Copy the lanes of ``sub`` (n of them) into ``pool`` lanes
    ``slot_ids``, in place; returns ``pool``.  ``sub`` may be narrower than
    the pool along axis 2 (the K/V rows past its width keep their stale
    contents, masked by the causal limit)."""
    ids = torch.as_tensor(list(slot_ids), dtype=torch.int64,
                          device=next(_planes(pool)).device)

    def write(dst, src):
        for k, new in src.items():
            if isinstance(new, dict):
                write(dst[k], new)
            elif k in LANE_INDEX_KEYS:
                dst[k][ids] = _lane_index(new, len(ids), ids.device)
            else:
                plane = dst[k]
                plane[:, ids, :new.shape[2]] = new.to(plane.dtype)

    write(pool, sub)
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
