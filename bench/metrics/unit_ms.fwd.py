"""Median device interval of the forward shard units (``hydra.unit``
spans, direction "fwd") started in the traced window, in ms: promotion
and forward of one shard."""

from bench.metrics.spans import unit_ms


def read(ctx):
    return unit_ms(ctx, "fwd")
