"""The port's paged attention against the JAX package's.

The same numpy-seeded inputs go through the port's plain version
(``repro_torch.kernels.ref.paged_attention_ref``), the JAX oracle
(``repro.kernels.ref.paged_attention_ref``) and the Pallas kernel in
interpret mode (``paged_attention_lanes(..., interpret=True)``), over the
shape sweep of ``tests/test_kernels.py`` plus its stale-page and
garbage-block cases.  Tolerances are ``tests/test_kernel_oracles.py``'s:
2e-5 in f32, 2e-2 in bf16 (bf16 rounding of the output dominates).

The CUDA kernel itself runs only on a card: its case compares it with
the plain version there and skips elsewhere.  The JAX side is imported by
a fixture, so on a machine with a card but no JAX the CUDA cases still
run (``python -m pytest -m cuda tests/test_torch_paged_attention.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention_lanes

F32_TOL = 2e-5
BF16_TOL = 2e-2

SWEEP = [  # n, nh, nkv, hd, bs, B, P, window, dtype (tests/test_kernels.py)
    (3, 8, 2, 64, 8, 4, 16, None, "float32"),     # GQA, multi-block
    (2, 4, 4, 32, 16, 2, 8, None, "float32"),     # MHA
    (4, 8, 1, 64, 8, 8, 33, None, "float32"),     # deep tables
    (2, 8, 2, 64, 8, 4, 16, 5, "float32"),        # sliding window
    (3, 4, 2, 32, 8, 3, 12, None, "bfloat16"),    # serving dtype
    (1, 2, 1, 16, 4, 1, 2, None, "float32"),      # single block
]


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.paged_attention import paged_attention_lanes
    return SimpleNamespace(jnp=jnp, ref=jref.paged_attention_ref,
                           pallas=paged_attention_lanes)


def _inputs(seed, n, nh, nkv, hd, bs, B, P):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, nh, hd), np.float32)
    kp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    vp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    # distinct physical blocks per lane, never the garbage block 0
    tables = (rng.permutation(P - 1)[: n * B] + 1).reshape(n, B)
    # lengths cover: partial first block, block boundary, full table
    lengths = np.clip([max(1, (i * B * bs) // n) if i else bs // 2
                       for i in range(n)], 1, B * bs)
    return (q, kp, vp, tables.astype(np.int32),
            np.asarray(lengths, np.int32))


def _jax(jx, args, dtype):
    q, kp, vp, t, le = args
    jnp = jx.jnp
    dt = jnp.dtype(dtype)
    return (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
            jnp.asarray(t), jnp.asarray(le))


def _torch(args, dtype, device="cpu"):
    q, kp, vp, t, le = args
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dt)
                 for a in (q, kp, vp)) + tuple(
        torch.from_numpy(a).to(device) for a in (t, le))


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("n,nh,nkv,hd,bs,B,P,window,dtype", SWEEP)
def test_ref_matches_jax_oracle_and_pallas(jx, n, nh, nkv, hd, bs, B, P,
                                           window, dtype):
    args = _inputs(n * 100 + B, n, nh, nkv, hd, bs, B, P)
    out = ref.paged_attention_ref(*_torch(args, dtype), window=window)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == getattr(torch, dtype)
    _close(_np(out), jx.ref(*_jax(jx, args, dtype), window=window), tol)
    _close(_np(out), jx.pallas(*_jax(jx, args, dtype), window=window,
                               interpret=True), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_and_default_impl_run_the_plain_version(dtype):
    """On CPU tensors the kernel wrapper and ``ops.paged_attention`` with
    the device default both run the plain version, bit for bit."""
    args = _torch(_inputs(5, 3, 8, 2, 64, 8, 4, 16), dtype)
    exp = ref.paged_attention_ref(*args)
    before = paged_attention_lanes.launches
    assert torch.equal(paged_attention_lanes(*args), exp)
    assert torch.equal(ops.paged_attention(*args), exp)
    assert paged_attention_lanes.launches == before   # no kernel launched


def test_stale_pages_and_garbage_block_are_invisible(jx):
    """Rows past a lane's length (recycled pages, garbage block 0) get
    exactly zero weight: trashing them changes nothing, in the port as in
    the JAX oracle."""
    rng = np.random.default_rng(3)
    n, nh, nkv, hd, bs, P = 1, 2, 1, 16, 4, 6
    q = rng.standard_normal((n, nh, hd), np.float32)
    kp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    vp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    tables = np.asarray([[2, 5]], np.int32)
    lengths = np.asarray([5], np.int32)          # one row into block 5
    base = (q, kp, vp, tables, lengths)
    kp2, vp2 = kp.copy(), vp.copy()
    for a, val in ((kp2, 999.0), (vp2, 999.0)):
        a[5, 1:] = val
        a[0] = -val
    trashed = (q, kp2, vp2, tables, lengths)
    out = ref.paged_attention_ref(*_torch(base, "float32"))
    out2 = ref.paged_attention_ref(*_torch(trashed, "float32"))
    assert torch.equal(out, out2)
    _close(_np(out), jx.ref(*_jax(jx, trashed, "float32")), F32_TOL)


def test_inactive_lane_on_garbage_block_stays_finite(jx):
    """An inactive lane (table all garbage block 0, length 1 — what the
    decode layer passes for an empty lane) gives a finite output equal to
    the JAX oracle's."""
    args = list(_inputs(9, 3, 8, 2, 64, 8, 4, 16))
    args[3][1] = 0
    args[4][1] = 1
    out = ref.paged_attention_ref(*_torch(args, "float32"))
    assert torch.isfinite(out).all()
    _close(_np(out), jx.ref(*_jax(jx, args, "float32")), F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nh,nkv,hd,bs,B,P,window,dtype", SWEEP)
def test_cuda_kernel_matches_plain_version(n, nh, nkv, hd, bs, B, P, window,
                                           dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = list(_inputs(n * 100 + B, n, nh, nkv, hd, bs, B, P))
    args[3][-1] = 0                       # an inactive lane on the garbage
    args[4][-1] = 1                       # block, as the engine leaves it
    t = _torch(args, dtype, "cuda")
    out = ops.paged_attention(*t, window=window, impl="cuda")
    exp = ref.paged_attention_ref(*t, window=window)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_np(out), _np(exp), tol)
