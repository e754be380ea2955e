"""The SwiGLU MLP ``silu(x @ Wg) * (x @ Wu) @ Wd``: the wrapper around the
hand-written Hopper kernels ``csrc/swiglu.cu``.

Replaces the TPU kernel ``swiglu_2d`` in ``src/repro/kernels/swiglu.py``.
What bounds it on an H100 is the weight bytes for few rows and the
products (``6 m d f`` flops) for many, so a call takes one of two routes
by its rows (``swiglu_route``): up to ``STREAM_MAX_ROWS`` rows the fused
decode layer's weight-streaming chain (4 launches), past that two tiled
tensor-core product launches (gate and up with ``silu(g) * u`` applied in
registers, then the down product); f32 operands are split into two bf16
parts there, three products each (``bound_flops``).  The design notes
are in the CUDA source.

For CUDA tensors the wrapper launches the kernel chain or raises; it never
falls back.  For tensors on the CPU, where no kernel exists, it runs the
plain version ``ref.swiglu_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import on_cpu
from repro_torch.kernels.ref import swiglu_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the most rows the stream route takes: one row tile of the streaming
# products (csrc/stream_gemm.cuh kMaxRows) in bf16; in f32 those products
# run on the CUDA cores, and past 8 rows (their 8-row tile) the tiled
# route's tensor cores are faster
STREAM_MAX_ROWS = {torch.bfloat16: 32, torch.float32: 8}
ROUTES = ("stream", "tiled")


def swiglu_route(m: int, dtype) -> str:
    """The route a call of ``m`` rows of ``dtype`` takes: ``"stream"``
    (the weights streamed past the rows) or ``"tiled"`` (tiled
    products)."""
    return "stream" if m <= STREAM_MAX_ROWS[dtype] else "tiled"


def bound_flops(m: int, d: int, f: int, dtype) -> tuple[int, str]:
    """The flops a bound of an (m, d, f) call counts, and the unit that
    runs them: ``"tensor"`` (bf16 tensor cores) or ``"f32"`` (CUDA
    cores).  The reference's ``6 m d f``, except on the tiled f32 route,
    which splits every operand into bf16 hi + lo and issues three
    tensor-core products for each of the reference's: a bound at the f32
    CUDA-core rate would be no bound for it."""
    flops = 6 * m * d * f
    if dtype == torch.float32:
        if swiglu_route(m, dtype) == "tiled":
            return 3 * flops, "tensor"
        return flops, "f32"
    return flops, "tensor"


def _lib():
    lib = _build.load("swiglu")
    fn = lib.swiglu_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.swiglu_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
    return lib


def swiglu_2d(x, w_gate, w_up, w_down):
    """x: (m, d); w_gate/w_up: (d, f); w_down: (f, d), all of one dtype.
    Returns (m, d) in x's dtype, computed in f32.  On CUDA tensors each
    call is one kernel chain (the stream route 4 CUDA launches, the tiled
    route 2), counted once in ``swiglu_2d.launches``."""
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}: expected (m, d)")
    m, d = x.shape
    f = w_gate.shape[-1]
    shapes = {"w_gate": (w_gate, (d, f)), "w_up": (w_up, (d, f)),
              "w_down": (w_down, (f, d))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"swiglu_2d: {name} {tuple(t.shape)}; expected "
                             f"{want}")
    named = {"x": x, "w_gate": w_gate, "w_up": w_up, "w_down": w_down}
    if on_cpu(named):
        return swiglu_ref(x, w_gate, w_up, w_down)
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"swiglu_2d: tensors on {devices}; expected all on "
                         "one CUDA device (or all on the CPU for the plain "
                         "version)")
    if x.dtype not in _DTYPE_CODES \
            or any(t.dtype != x.dtype for t in named.values()):
        raise TypeError(f"swiglu_2d: {[str(t.dtype) for t in named.values()]}"
                        "; the kernel takes one dtype, float32 or bfloat16")
    if d % 8 or f % 8:
        raise ValueError(f"swiglu_2d: d {d}, f {f}; the kernel takes "
                         "multiples of 8 (its vector loads)")
    for name, t in named.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"swiglu_2d: {name} is not contiguous and "
                             "16-byte aligned (the kernel's vector loads)")
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _lib()
    route = ROUTES.index(swiglu_route(m, x.dtype))
    code = _DTYPE_CODES[x.dtype]
    ws = torch.empty(lib.swiglu_workspace_bytes(m, d, f, code, route),
                     dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.swiglu_fwd(x.data_ptr(), w_gate.data_ptr(),
                             w_up.data_ptr(), w_down.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), m, d, f, code,
                             route,
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swiglu kernel launch failed: CUDA error {err}")
    swiglu_2d.launches += 1
    return out


swiglu_2d.launches = 0
