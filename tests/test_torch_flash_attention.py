"""The port's flash attention against the JAX package's.

The same numpy-seeded inputs go through the port's plain version
(``repro_torch.kernels.ref.flash_attention_ref``), its ``ops`` entry point
on CPU tensors (which takes that plain version), the JAX oracle
(``repro.kernels.ref.flash_attention_ref``) and the Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention(interpret=True)``).
The sweep covers GQA groups 1, 2 and 4, ``sq == sk`` and ``sq < sk``,
lengths around the TPU kernel's 128-row tile (127, 128, 129, 200),
causal and non-causal attention and a sliding window.  Tolerances are
``tests/test_kernel_oracles.py``'s: 2e-5 in f32, 2e-2 in bf16.

The bf16 kernel feeds P to its second product (P.V on the tensor cores)
in bf16, where the plain version keeps it in f32: a test-local plain
version with P rounded the same way stays within the bf16 tolerance of the
JAX oracle at the eval paths' full per-batch shapes (qwen3-0.6b: 16/8
heads of 128, s 1024; zamba2-1.2b's shared block: 32/32 heads of 64).

The CUDA kernels run only on a card: their cases compare each kernel with
its plain version there and skip elsewhere.  JAX is imported by a fixture, so
on a machine with a card but no JAX the CUDA cases still run
(``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd

F32_TOL = 2e-5
BF16_TOL = 2e-2
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}

CASES = [  # b, nh, nkv, sq, sk, hd, causal, window, dtype
    (2, 4, 4, 127, 127, 32, True, None, "float32"),     # MHA, under a tile
    (1, 4, 2, 128, 128, 32, True, None, "float32"),     # groups 2, one tile
    (1, 8, 2, 129, 129, 32, True, None, "float32"),     # groups 4, tile + 1
    (1, 4, 2, 200, 200, 32, True, None, "float32"),     # ragged second tile
    (1, 4, 2, 64, 200, 32, True, None, "float32"),      # sq < sk
    (1, 4, 1, 129, 129, 32, False, None, "float32"),    # non-causal
    (1, 4, 2, 200, 200, 32, True, 50, "float32"),       # sliding window
    (1, 4, 2, 130, 200, 32, False, 64, "float32"),      # window, sq < sk
    (1, 4, 2, 129, 129, 32, True, None, "bfloat16"),    # compute dtype
]


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


def _inputs(b, nh, nkv, sq, sk, hd, dtype, seed=0):
    """q (b, sq, nh, hd), k/v (b, sk, nkv, hd) in the layer layout, as
    numpy f32 (bf16 cases round them through bf16 on both sides)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, nh, hd), np.float32)
    k = rng.standard_normal((b, sk, nkv, hd), np.float32)
    v = rng.standard_normal((b, sk, nkv, hd), np.float32)
    return q, k, v


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _jax(jx, a, dtype):
    return jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype))


def _close(out, exp, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,nh,nkv,sq,sk,hd,causal,window,dtype", CASES)
def test_plain_version_matches_jax_oracle(jx, b, nh, nkv, sq, sk, hd, causal,
                                          window, dtype):
    q, k, v = _inputs(b, nh, nkv, sq, sk, hd, dtype)
    bhsd = (0, 2, 1, 3)
    out = ref.flash_attention_ref(
        *(_torch(a, dtype).permute(*bhsd) for a in (q, k, v)),
        causal=causal, window=window)
    exp = jx.ref.flash_attention_ref(
        *(_jax(jx, a, dtype).transpose(*bhsd) for a in (q, k, v)),
        causal=causal, window=window)
    assert out.shape == (b, nh, sq, hd) and out.dtype == getattr(torch, dtype)
    _close(out.float().numpy(), exp, dtype)


@pytest.mark.parametrize("b,nh,nkv,sq,sk,hd,causal,window,dtype", CASES)
def test_ops_entry_point_matches_pallas_interpret(jx, b, nh, nkv, sq, sk, hd,
                                                  causal, window, dtype):
    """The layer-layout entry points of both packages on the CPU: the
    port's takes its plain version, the JAX package's runs the Pallas
    kernel in interpret mode (128-row tiles, padded and masked)."""
    q, k, v = _inputs(b, nh, nkv, sq, sk, hd, dtype, seed=1)
    out = ops.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                              causal=causal, window=window)
    exp = jx.ops.flash_attention(*(_jax(jx, a, dtype) for a in (q, k, v)),
                                 causal=causal, window=window,
                                 interpret=True)
    assert out.shape == (b, sq, nh, hd)
    _close(out.float().numpy(), exp, dtype)


def test_refuses_gradients_on_every_device():
    """The JAX package cannot differentiate the Pallas kernel; the port's
    op refuses inputs that need a gradient, on the CPU too, where it would
    otherwise run its differentiable plain version."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(1, 4, 2, 16, 16, 32, "float32"))
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    with torch.no_grad():                     # forward-only paths are fine
        assert ops.flash_attention(q, k, v).shape == (1, 16, 4, 32)


def test_cuda_impl_on_cpu_tensors_raises():
    q, k, v = (torch.from_numpy(a)
               for a in _inputs(1, 4, 2, 16, 16, 32, "float32"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")


def _flash_p_bf16(q, k, v, *, causal=True, window=None):
    """The plain version with the probabilities rounded to bf16 before
    P.V, as the tensor-core kernel feeds them to its second product: p =
    exp(s - max) in f32, rounded to bf16 for P.V, summed in f32 for the
    denominator.  q: (b, nh, sq, hd), k/v: (b, nkv, sk, hd)."""
    b, nh, sq, hd = q.shape
    nkv, sk = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(b, nkv, g, sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / np.sqrt(hd)
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    out = torch.einsum("bkgqs,bksh->bkgqh", p.bfloat16().float(), v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, nh, sq, hd).to(q.dtype)


@pytest.mark.parametrize("nh,nkv,hd", [(16, 8, 128), (32, 32, 64)],
                         ids=["qwen3-eval", "zamba2-shared-block"])
def test_bf16_probabilities_stay_within_bf16_tolerance(jx, nh, nkv, hd):
    """P in bf16 before P.V (the tensor-core kernel's second product) at
    the eval paths' per-batch shapes: within BF16_TOL of the JAX oracle,
    which keeps P in f32."""
    q, k, v = _inputs(1, nh, nkv, 1024, 1024, hd, "bfloat16", seed=3)
    bhsd = (0, 2, 1, 3)
    out = _flash_p_bf16(*(_torch(a, "bfloat16").permute(*bhsd)
                          for a in (q, k, v)))
    exp = jx.ref.flash_attention_ref(
        *(_jax(jx, a, "bfloat16").transpose(*bhsd) for a in (q, k, v)),
        causal=True)
    assert out.shape == (1, nh, 1024, hd)
    _close(out.float().numpy(), exp, "bfloat16")


GPU_CASES = [  # b, nh, nkv, sq, sk, hd, causal, window, dtype
    (2, 16, 8, 1, 1, 128, True, None, "bfloat16"),
    (2, 16, 8, 127, 127, 128, True, None, "bfloat16"),
    (1, 16, 8, 129, 129, 128, True, None, "float32"),
    (2, 16, 8, 1000, 1000, 128, True, None, "bfloat16"),
    (1, 16, 8, 300, 1000, 128, True, None, "float32"),
    (1, 16, 8, 1000, 1000, 128, False, None, "bfloat16"),
    (1, 16, 8, 1000, 1000, 128, True, 512, "float32"),
    (1, 4, 1, 200, 200, 64, True, None, "float32"),
    (1, 4, 4, 70, 70, 32, False, 16, "bfloat16"),
    (1, 2, 1, 90, 90, 256, True, None, "bfloat16"),
    # the tensor-core (bf16) kernel: zamba2's shared block, sq < sk with a
    # ragged last tile, head dims that are not a multiple of 16 or of 64,
    # GQA groups of 3 and 4, a window, and b 2 at s 4096
    (2, 32, 32, 1024, 1024, 64, True, None, "bfloat16"),
    (1, 16, 8, 100, 333, 128, True, None, "bfloat16"),
    (1, 4, 2, 70, 70, 40, True, None, "bfloat16"),
    (1, 4, 2, 150, 150, 96, True, None, "bfloat16"),
    (1, 2, 1, 130, 130, 192, False, None, "bfloat16"),
    (1, 6, 2, 200, 200, 64, True, 100, "bfloat16"),
    (1, 8, 2, 129, 300, 128, False, 64, "bfloat16"),
    (1, 16, 8, 1000, 1000, 128, True, 512, "bfloat16"),
    (2, 16, 8, 4096, 4096, 128, True, None, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,nh,nkv,sq,sk,hd,causal,window,dtype", GPU_CASES)
def test_cuda_kernel_matches_plain_version(b, nh, nkv, sq, sk, hd, causal,
                                           window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the flash kernel runs only on a card")
    q, k, v = (_torch(a, dtype, "cuda")
               for a in _inputs(b, nh, nkv, sq, sk, hd, dtype, seed=2))
    before = flash_attention_bhsd.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda")
    exp = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="ref")
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    assert out.shape == (b, sq, nh, hd) and out.dtype == q.dtype
    _close(out.float().cpu().numpy(), exp.float().cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv,hd,dtype", [(16, 8, 128, "bfloat16"),
                                             (32, 32, 64, "bfloat16"),
                                             (16, 8, 128, "float32")])
def test_cuda_kernel_repeats_bitwise(nh, nkv, hd, dtype):
    """Two calls on the same inputs give the same bits (the eval shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the flash kernel runs only on a card")
    q, k, v = (_torch(a, dtype, "cuda")
               for a in _inputs(2, nh, nkv, 1024, 1024, hd, dtype, seed=4))
    first = ops.flash_attention(q, k, v, impl="cuda")
    second = ops.flash_attention(q, k, v, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
