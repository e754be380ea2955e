"""Mamba2 SSD chunked scan: the wrapper around the hand-written Hopper
kernel ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``ssd_scan_bshpn`` in
``src/repro/kernels/ssd_scan.py``.  What bounds it on an H100 is the bytes
at zamba2's shape and the operations of its products (``ssd_flops``) at
the mLSTM's.  bf16 inputs run every product on the tensor cores; f32
inputs stay on the CUDA cores (the reference's 2e-4).  The design notes
are in the CUDA source.

Inputs are read through their strides: the Mamba2 block broadcasts one
B/C group over every head with ``expand`` (head stride 0), and the kernel
reads that view as it is — no per-head copy is made.  The bf16 kernel
copies 16-byte rows, so it takes unit last strides and other strides in
whole 8-element vectors; an operand that has neither is made contiguous
first (a layout copy; a broadcast view qualifies as it is).

The kernel is forward-only, as the TPU kernel is (``jax.grad`` through
its ``pallas_call`` raises): inputs that need a gradient raise, on every
device.

For a CUDA tensor the wrapper launches the kernel or raises; it never falls
back.  For tensors on the CPU, where no kernel exists, it runs the plain
version ``ref.ssd_chunked_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import refuse_grad
from repro_torch.kernels.paged_attention import on_cpu
from repro_torch.kernels.ref import ssd_chunked_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448           # bytes of shared memory a block can use
_MAX_CHUNK_BF16 = 256           # kMaxChunkTc: 16 query tiles of 16 rows


def _lib():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_flops(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """Operations of the chunked algorithm (2 per multiply-add): the
    causal half of C.B^T and of scores.x within each chunk, the carried
    state's C.S^T and the state update."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * (n + p) + 2 * 2 * chunk * p * n
    return b * h * nc * per_chunk


def _rows_of_vectors(t):
    """``t`` itself when its last stride is 1, its other strides are whole
    8-element vectors and it is 16-byte aligned (what the bf16 kernel's
    16-byte copies take), else a contiguous copy in fresh memory."""
    if t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ssd_scan_bshpn(x, log_a, b_coef, c_coef, *, chunk: int):
    """x: (b, s, h, p); log_a: (b, s, h) float32; b_coef / c_coef: (b, s,
    h, n) of x's dtype, any strides (a head stride of 0 is read as it is).
    ``s`` must be a multiple of ``chunk``.  Returns y (b, s, h, p) in x's
    dtype, contiguous.  On CUDA tensors each call is one kernel launch,
    counted in ``ssd_scan_bshpn.launches``."""
    if x.dim() != 4 or log_a.dim() != 3 or b_coef.dim() != 4 \
            or c_coef.dim() != 4:
        raise ValueError("expected x (b, s, h, p), log_a (b, s, h), "
                         "b_coef / c_coef (b, s, h, n)")
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    if tuple(log_a.shape) != (bsz, s, h) \
            or tuple(b_coef.shape) != (bsz, s, h, n) \
            or c_coef.shape != b_coef.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, b {tuple(b_coef.shape)}, "
                         f"c {tuple(c_coef.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan_bshpn: s % chunk must be 0 (s={s}, "
                         f"chunk={chunk}); the kernel route does not pad — "
                         "the plain ssd_chunked does")
    refuse_grad(x, b_coef, c_coef, name="ssd_scan_bshpn")
    named = {"x": x, "log_a": log_a, "b_coef": b_coef, "c_coef": c_coef}
    if on_cpu(named):
        return ssd_chunked_ref(x, log_a, b_coef, c_coef, chunk)[0]
    devices = {t.device for t in named.values()}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bshpn: tensors on {devices}; expected "
                         "all on one CUDA device (or all on the CPU for "
                         "the plain version)")
    if x.dtype not in _DTYPE_CODES or b_coef.dtype != x.dtype \
            or c_coef.dtype != x.dtype or log_a.dtype != torch.float32:
        raise TypeError(f"ssd_scan_bshpn: x {x.dtype}, b {b_coef.dtype}, "
                        f"c {c_coef.dtype}, log_a {log_a.dtype}; the kernel "
                        "takes x, b, c of one dtype (float32 or bfloat16) "
                        "and float32 log_a")
    if x.dtype == torch.bfloat16:
        if chunk > _MAX_CHUNK_BF16 or p % 8 or n % 8:
            raise ValueError(f"ssd_scan_bshpn: chunk {chunk}, p {p}, n {n}; "
                             "the bfloat16 kernel takes chunk <= "
                             f"{_MAX_CHUNK_BF16} and p, n multiples of 8 "
                             "(its 16-byte copies)")
        x, b_coef, c_coef = map(_rows_of_vectors, (x, b_coef, c_coef))
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(chunk, n, _DTYPE_CODES[x.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bshpn: chunk {chunk} with state width "
                         f"{n} needs {smem} B of shared memory a block; the "
                         f"card has {_SMEM_LIMIT}")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_longlong * 15)(
        *x.stride(), *log_a.stride(), *b_coef.stride(), *c_coef.stride())
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_fwd(
            x.data_ptr(), log_a.data_ptr(), b_coef.data_ptr(),
            c_coef.data_ptr(), y.data_ptr(), strides, bsz, s, h, p, n, chunk,
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan_bshpn.launches += 1
    return y


ssd_scan_bshpn.launches = 0
