"""Median device interval of the backward shard units (``hydra.unit``
spans, direction "bwd") started in the traced window, in ms: promotion,
backward, the shared gradients' host sum, the optimizer step and the
demotion of one shard."""

from bench.metrics.spans import unit_ms


def read(ctx):
    return unit_ms(ctx, "bwd")
