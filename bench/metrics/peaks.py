"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and the roofline bound of a kernel, copied
from ``chip_smoke.py`` (``bound_ms``) for the kernel metrics of later
cells: the least time is the larger of the least bytes over the HBM rate
and the operations over the peak of their dtype."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,      # outside the tensor cores
              "tfloat32": 495e12,
              "bfloat16": 989e12,
              "float16": 989e12,
              "float8": 1979e12}


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    """(least ms, "bytes" or "operations": which of the two bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
