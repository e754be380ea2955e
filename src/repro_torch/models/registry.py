"""Capability-driven family registry: one ``FamilySpec`` per model family
(port of ``repro.models.registry``).

Execution layers ask ``spec(cfg)`` what a family can do instead of
testing family names.  Every family of the JAX package is registered:
``dense`` and ``vlm`` (``models.transformer``), ``moe``, ``ssm``,
``hybrid`` and ``audio`` (``models.encdec``); an unknown name raises
``KeyError`` naming what is available.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from importlib import import_module
from types import ModuleType
from typing import Any, Callable, Optional


class CapabilityFallbackWarning(UserWarning):
    """A requested serving feature is not in the family's declared
    capabilities; execution fell back to the closest supported mode."""


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if hasattr(tree, "dtype") and hasattr(tree, "shape"):
        return math.prod(tree.shape) * tree.dtype.itemsize
    return 4          # a Python int write index: JAX's int32 scalar


def _default_decode_state_bytes(mod: ModuleType, cfg, batch: int,
                                max_seq: int) -> int:
    """The bytes of ``mod.init_decode_state`` built on the meta device:
    the shapes and dtypes of a real state, nothing allocated."""
    return _tree_bytes(mod.init_decode_state(cfg, batch, max_seq,
                                             device="meta"))


@dataclass(frozen=True)
class FamilySpec:
    """One model family's declared surface + capabilities + cost model."""

    family: str
    module: ModuleType
    # -- capabilities ----------------------------------------------------------
    batched_prefill: bool = False   # whole prompt chunk in ONE decode_step
    padded_prefill: bool = False    # right-padded prefill token-identical
    paging: bool = False            # decode state can live in paged KV blocks
    pure_kv_state: bool = False     # decode state is a pure KV cache
    servable: bool = True           # InferenceEngine can serve this family
    token_stream_data: bool = True  # train/eval batches are {tokens, labels}
    spec_draftable: bool = False    # multi-token verify + KV rollback work:
    #   the family can be the target (or draft) of speculative decoding
    kv_quant: bool = False          # paged KV pool can be int8-quantized
    #   (per-row scales stored beside the pages; requires paging)
    # capability -> one-line reason it is absent
    notes: dict = field(default_factory=dict)
    # -- cost fns (admission control charges these against the ledger) ------
    decode_state_cost: Optional[Callable[[Any, int, int], int]] = None
    kv_block_cost: Optional[Callable[..., int]] = None

    def decode_state_bytes(self, cfg, batch: int, max_seq: int) -> int:
        """Residency bytes of one decode state: the family's cost fn, or
        the bytes of its decode state's shapes when it declares none."""
        if self.decode_state_cost is not None:
            return self.decode_state_cost(cfg, batch, max_seq)
        return _default_decode_state_bytes(self.module, cfg, batch, max_seq)

    def kv_block_bytes(self, cfg, block_size: int, kv_dtype=None) -> int:
        """Residency bytes of ONE physical KV block across all layers.
        ``kv_dtype='int8'`` prices the quantized pool (pages + per-row
        scale planes) and requires the ``kv_quant`` capability."""
        if kv_dtype in (None, "fp"):
            return self.kv_block_cost(cfg, block_size)
        if not self.kv_quant:
            raise ValueError(
                f"{self.family}: kv_dtype={kv_dtype!r} unsupported — "
                f"{self.why_not('kv_quant')}")
        return self.kv_block_cost(cfg, block_size, kv_dtype)

    @property
    def preemptible(self) -> bool:
        """A RUNNING request can be descheduled and resumed with prefill
        skipped: derived from ``paging`` (preemption snapshots the paged
        backend's refcounted block tables)."""
        return self.paging

    def capabilities(self) -> dict:
        """JSON-ready capability record (plan meta / poll)."""
        return {"batched_prefill": self.batched_prefill,
                "padded_prefill": self.padded_prefill,
                "paging": self.paging,
                "pure_kv_state": self.pure_kv_state,
                "servable": self.servable,
                "spec_draftable": self.spec_draftable,
                "kv_quant": self.kv_quant,
                "preemptible": self.preemptible}

    def why_not(self, capability: str) -> str:
        if capability == "kv_quant" and "kv_quant" not in self.notes:
            return ("int8 KV quantizes paged blocks on write; " +
                    ("the family has not declared a quantized page "
                     "layout + cost model" if self.paging
                     else self.why_not("paging")))
        if capability == "preemptible" and "preemptible" not in self.notes:
            # derived from paging: explain through the underlying flag
            return ("preemption snapshots paged block tables; " +
                    ("the slot/spec backends keep contiguous or lockstep "
                     "decode state — serve with backend='paged'"
                     if self.paging else self.why_not("paging")))
        return self.notes.get(capability, "not declared by the family spec")


_REGISTRY: dict[str, FamilySpec] = {}

# family -> module that registers it (lazy import on first lookup)
_FAMILY_MODULES = {"dense": "repro_torch.models.transformer",
                   "vlm": "repro_torch.models.transformer",
                   "moe": "repro_torch.models.moe",
                   "ssm": "repro_torch.models.ssm",
                   "hybrid": "repro_torch.models.hybrid",
                   "audio": "repro_torch.models.encdec"}


def register(spec: FamilySpec) -> FamilySpec:
    if not spec.family:
        raise ValueError("FamilySpec.family must be a non-empty name")
    _REGISTRY[spec.family] = spec
    return spec


def spec(family_or_cfg) -> FamilySpec:
    """Look up the FamilySpec for a family name or an ArchConfig."""
    family = getattr(family_or_cfg, "family", family_or_cfg)
    if family not in _REGISTRY and family in _FAMILY_MODULES:
        import_module(_FAMILY_MODULES[family])      # registration side effect
    if family not in _REGISTRY:
        raise KeyError(f"no registered model family {family!r} "
                       f"(have {sorted(_FAMILY_MODULES)})")
    return _REGISTRY[family]


def registered_families() -> tuple[str, ...]:
    """Every registerable family name, importing lazily as needed."""
    for fam in _FAMILY_MODULES:
        spec(fam)
    return tuple(sorted(_REGISTRY))


def families_with(capability: str) -> tuple[str, ...]:
    """Family names declaring ``capability`` True (registry-wide query)."""
    return tuple(f for f in registered_families()
                 if getattr(spec(f), capability))
