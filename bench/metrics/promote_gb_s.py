"""Bytes the promotions copied host to device (``hydra.promote`` spans
started in the traced window: weights for a forward, weights and AdamW
moments for a backward) over their device time, in GB/s."""

from bench.metrics.spans import gb_per_s, in_window, named


def read(ctx):
    return gb_per_s(named(in_window(ctx), "hydra.promote"))
