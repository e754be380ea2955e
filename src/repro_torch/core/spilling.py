"""Device byte ledger (port of ``repro.core.spilling``, ``DeviceMemory``
only).

The JAX package's ledger charges four terms against one device budget:
promoted shards, the double-buffer loading zone, serving KV pages and
hot serve weights.  The port's serving slice charges only the KV-page
term; the shard terms, the host model store and the tiered (host-DRAM)
KV moves come with the SHARP and tiering slices.
"""

from __future__ import annotations


class DeviceMemory:
    """KV-page byte accounting for one device."""

    def __init__(self, device_id: int, budget_bytes: int):
        self.device_id = device_id
        self.budget = budget_bytes
        self.kv_reserved_bytes = 0
        self.kv_peak_bytes = 0

    def used_bytes(self) -> int:
        return self.kv_reserved_bytes

    def can_reserve_kv(self, nbytes: int) -> bool:
        return self.used_bytes() + nbytes <= self.budget

    def reserve_kv(self, nbytes: int) -> bool:
        """Charge a KV-page reservation; False (not an error) when it does
        not fit — admission control degrades to queueing, not crashing."""
        if not self.can_reserve_kv(nbytes):
            return False
        self.kv_reserved_bytes += nbytes
        self.kv_peak_bytes = max(self.kv_peak_bytes, self.kv_reserved_bytes)
        return True

    def release_kv(self, nbytes: int) -> None:
        if nbytes > self.kv_reserved_bytes:
            raise RuntimeError(
                f"device {self.device_id}: release_kv({nbytes}) exceeds the "
                f"{self.kv_reserved_bytes} B reserved — release without a "
                "matching reserve")
        self.kv_reserved_bytes -= nbytes
