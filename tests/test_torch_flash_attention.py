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

The CUDA kernel runs only on a card: its cases compare the kernel with its
plain version there and skip elsewhere.  JAX is imported by a fixture, so
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
