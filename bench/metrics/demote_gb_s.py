"""Bytes the demotions wrote back device to host (``hydra.demote`` spans
started in the traced window: weights and AdamW moments) over their
device time, in GB/s."""

from bench.metrics.spans import gb_per_s, in_window, named


def read(ctx):
    return gb_per_s(named(in_window(ctx), "hydra.demote"))
