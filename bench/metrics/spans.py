"""The program's spans (``repro_torch.tracing``) whose host start lies in
the traced window, for the readers of the ``program_span`` metrics.  A
program that records no spans, or a run without a trace, gives none, and
each reader then gives ``None``."""

from __future__ import annotations

import statistics


def in_window(ctx) -> list:
    if ctx.get("trace") is None or ctx.get("window_s", 0) <= 0:
        return []
    try:
        from repro_torch import tracing
    except ImportError:                # a program without spans
        return []
    t0 = round(ctx["t0_epoch"] * 1e9)
    return tracing.spans(since_ns=t0, until_ns=t0 + round(ctx["window_s"]
                                                          * 1e9))


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def nearest(s, by_id: dict, name: str):
    """The nearest enclosing span of ``name`` (``None`` if there is none
    in ``by_id``)."""
    while s.parent is not None and s.parent in by_id:
        s = by_id[s.parent]
        if s.name == name:
            return s
    return None


def median_ms(values_ns) -> float | None:
    values = list(values_ns)
    return statistics.median(values) / 1e6 if values else None


def gb_per_s(spans) -> float | None:
    """Sum of ``bytes`` over the sum of device time (bytes a ns = GB/s)."""
    ns = sum(s.device_ns for s in spans)
    return sum(s.attrs["bytes"] for s in spans) / ns if ns > 0 else None


def unit_ms(ctx, direction: str) -> float | None:
    return median_ms(s.device_ns for s in named(in_window(ctx), "hydra.unit")
                     if s.attrs.get("direction") == direction)
