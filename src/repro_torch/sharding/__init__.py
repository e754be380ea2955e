"""Sharding rules and the activation context (port of
``repro.sharding``) on DTensor placements."""

from repro_torch.sharding import specs

__all__ = ["specs"]
