"""Model FLOPs of the tokens completed in the traced window (``flops``,
counted by ``flops.py``) over the window times the card's dense bf16
peak, in %."""

from bench.metrics.peaks import PEAK_FLOPS


def read(ctx):
    if ctx.get("trace") is None or ctx["window_s"] <= 0 \
            or ctx["flops"] <= 0:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * PEAK_FLOPS["bfloat16"])
