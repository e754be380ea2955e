"""The port's SSD scan (``kernels/ref.py``: the sequential oracle
``ssd_scan_ref`` and the chunked ``ssd_chunked_ref``; ``models/ssm.py``:
``ssd_chunked``; ``kernels/ops.py``: ``ssd_scan``) against the JAX
package's.

* On the shapes of ``tests/test_kernels.py``'s SSD kernel test and over
  a hypothesis fuzz like ``tests/test_kernel_oracles.py``'s, the port's
  oracle and plain chunked scan give JAX ``ref.ssd_scan_ref``'s and the
  Pallas kernel's (``ops.ssd_scan(interpret=True)``) numbers on the same
  numpy-seeded inputs, at the reference's ``MM_TOL`` 2e-4 (f32; the scan
  is a chain of products).
* The chunked scan is invariant in the chunk length, carries an initial
  state and returns the final state as the JAX ``ssd_chunked`` does, and
  reads B/C broadcast over heads (stride 0) as it reads a copy.
* The kernel route raises where the JAX op asserts or drops an input:
  ``s % chunk``, ``initial_state``; ``impl="cuda"`` on CPU tensors
  raises; inputs that need a gradient raise.
* A plain model of the bf16 tensor-core kernel's numerics
  (``ssd_kernel_model``: per n slice of 64, the decayed scores, the f32
  state and x scaled by the state weights each split into bf16 hi + lo
  before they meet the bf16 inputs in f32 sums) gives JAX
  ``ref.ssd_scan_ref``'s and the Pallas kernel's numbers on
  bf16-representable inputs at 1e-3.  The split is the kernel's
  rounding choice: at the decay edge ``log_a = 0`` and at the mLSTM's
  state width, operands rounded once to bf16 put the model outside
  chip_smoke's 2e-2 bound, hi + lo keeps it within 1e-3.  The kernel keeps the reference's chunk order (no
  state-passing reorder), so no other sum order is modelled.
* On a card (``-m cuda``) the CUDA kernel is held against the plain
  version in f32 (2e-4) and bf16 (2e-2), contiguous and broadcast B/C,
  at the decay edges and the mLSTM shape, and two calls give the same
  bits.  The JAX side is imported by a fixture, so those cases run where
  JAX is missing.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan_bshpn
from repro_torch.models import ssm

MM_TOL = 2e-4
BF16_TOL = 2e-2
MODEL_TOL = 1e-3    # the bf16 kernel's model, hi + lo operands

# tests/test_kernels.py's SSD kernel shapes: b, s, h, p, n, chunk
SHAPES = [
    (2, 256, 2, 16, 8, 64),
    (1, 128, 4, 64, 32, 32),
    (1, 64, 1, 8, 8, 64),     # single chunk
    (2, 96, 2, 32, 16, 32),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import ssm as jssm
    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref, ssm=jssm)


def ssd_inputs(seed, b, s, h, p, n):
    """The reference tests' input scales: x ~ N(0, 1), log decay
    -|N(0, 1)| * 0.1, B and C ~ N(0, 1) * 0.3 (f32 numpy)."""
    rng = np.random.default_rng(seed)
    std = rng.standard_normal
    return (std((b, s, h, p)).astype(np.float32),
            (-np.abs(std((b, s, h))) * 0.1).astype(np.float32),
            (std((b, s, h, n)) * 0.3).astype(np.float32),
            (std((b, s, h, n)) * 0.3).astype(np.float32))


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device) if i == 1
            else torch.from_numpy(a).to(device=device, dtype=dtype)
            for i, a in enumerate(arrays)]


def _check_against_jax(jx, arrays, chunk):
    x, la, bc, cc = arrays
    exp = jx.ref.ssd_scan_ref(x, la, bc, cc, chunk=chunk)
    pallas, _ = jx.ops.ssd_scan(x, la, bc, cc, chunk=chunk, interpret=True)
    t = _torch(arrays)
    _close(ref.ssd_scan_ref(*t, chunk=chunk), exp, MM_TOL)
    y, _ = ssm.ssd_chunked(*t, chunk)
    _close(y, exp, MM_TOL)
    _close(y, pallas, MM_TOL)
    y_op, none = ops.ssd_scan(*t, chunk=chunk)
    assert none is None
    _close(y_op, y, 0)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_versions_match_jax_oracle_and_pallas(jx, b, s, h, p, n,
                                                    chunk):
    _check_against_jax(jx, ssd_inputs(1, b, s, h, p, n), chunk)


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10**6), st.integers(1, 2), st.integers(1, 3),
       st.sampled_from([8, 16]), st.sampled_from([8, 16]),
       st.sampled_from([32, 64]))
def test_fuzz_plain_versions_match_jax(seed, b, h, p, n, chunk):
    import jax  # noqa: F401  (the fuzz needs the JAX side; the suite has it)
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    s = chunk * (1 + seed % 3)
    _check_against_jax(SimpleNamespace(ops=jops, ref=jref),
                       ssd_inputs(seed, b, s, h, p, n), chunk)


def test_chunk_invariance_and_states_match_jax(jx):
    """Chunk lengths 16/32/64/96 (96: the padding branch) give one answer;
    an initial state carries in and the final state comes out as the JAX
    ``ssd_chunked`` gives them."""
    b, s, h, p, n = 2, 192, 3, 16, 8
    arrays = ssd_inputs(2, b, s, h, p, n)
    init = np.random.default_rng(3).standard_normal(
        (b, h, p, n)).astype(np.float32)
    t = _torch(arrays)
    base, st0 = ssm.ssd_chunked(*t, 64, initial_state=torch.from_numpy(init))
    jy, jst = jx.ssm.ssd_chunked(*arrays, 64, initial_state=init)
    _close(base, jy, MM_TOL)
    _close(st0, jst, MM_TOL)
    for chunk in (16, 32, 96):
        y, st_ = ssm.ssd_chunked(*t, chunk,
                                 initial_state=torch.from_numpy(init))
        _close(y, base, MM_TOL)
        _close(st_, st0, MM_TOL)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _hi_lo(t):
    """``t`` as the kernel's two bf16 parts, added back: hi + lo."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_kernel_model(x, log_a, b_coef, c_coef, chunk, *, width=64,
                     split=True):
    """The bf16 tensor-core kernel's numerics in plain torch (f32 sums,
    the reference's chunk order): per chunk, a_cum by cumsum; per n slice
    of ``width``, C.B^T decayed (masked before the exp) and the f32 state
    meet x and C as bf16 hi + lo parts (``split``; else rounded once to
    bf16); x scaled by the state weights, split the same way, updates the
    f32 state.  x, B, C are taken as they are (bf16 values)."""
    part = _hi_lo if split else _bf16
    bsz, s, h, p = x.shape
    n = b_coef.shape[-1]
    x, b_coef, c_coef = x.float(), b_coef.float(), c_coef.float()
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    state = torch.zeros(bsz, h, p, n)
    ys = []
    for t0 in range(0, s, chunk):
        rows = slice(t0, t0 + chunk)
        xc = x[:, rows]
        a_cum = torch.cumsum(log_a[:, rows].float(), 1)          # (b, Q, h)
        a_tot = a_cum[:, -1]
        li = a_cum[:, :, None] - a_cum[:, None, :]
        decay = torch.exp(torch.where(tril[None, :, :, None], li,
                                      torch.full_like(li, -1e30)))
        y_diag = torch.zeros(bsz, chunk, h, p)
        y_state = torch.zeros(bsz, chunk, h, p)
        for n0 in range(0, n, width):
            cs = c_coef[:, rows, :, n0:n0 + width]
            bs_ = b_coef[:, rows, :, n0:n0 + width]
            scores = part(torch.einsum("bqhn,bkhn->bqkh", cs, bs_) * decay)
            y_diag += torch.einsum("bqkh,bkhp->bqhp", scores, xc)
            y_state += torch.einsum("bqhn,bhpn->bqhp", cs,
                                    part(state[..., n0:n0 + width]))
        ys.append(y_diag + torch.exp(a_cum)[..., None] * y_state)
        w = torch.exp(a_tot[:, None] - a_cum)
        state = torch.exp(a_tot)[..., None, None] * state + torch.einsum(
            "bqhp,bqhn->bhpn", part(xc * w[..., None]), b_coef[:, rows])
    return torch.cat(ys, 1)


def _bf16_inputs(seed, b, s, h, p, n, log_a=None):
    """``ssd_inputs`` with x, B, C rounded to bf16 values (numpy f32, so
    JAX gets the same numbers); ``log_a`` pins every decay."""
    x, la, bc, cc = ssd_inputs(seed, b, s, h, p, n)
    x, bc, cc = (_bf16(torch.from_numpy(a)).numpy() for a in (x, bc, cc))
    if log_a is not None:
        la = np.full_like(la, log_a)
    return x, la, bc, cc


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_kernel_model_matches_jax_oracle_and_pallas(jx, b, s, h, p, n,
                                                    chunk):
    arrays = _bf16_inputs(8, b, s, h, p, n)
    out = ssd_kernel_model(*map(torch.from_numpy, arrays), chunk)
    _close(out, jx.ref.ssd_scan_ref(*arrays, chunk=chunk), MODEL_TOL)
    _close(out, jx.ops.ssd_scan(*arrays, chunk=chunk, interpret=True)[0],
           MODEL_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,log_a", [
    (1, 512, 2, 64, 64, 256, 0.0),       # zamba2's head, no decay
    (1, 512, 1, 64, 512, 256, None),     # the mLSTM's state width
])
def test_kernel_model_rounding_choice(jx, b, s, h, p, n, chunk, log_a):
    """hi + lo operands keep the model within 1e-3 of the JAX oracle;
    operands rounded once to bf16 leave it outside chip_smoke's 2e-2."""
    arrays = _bf16_inputs(9, b, s, h, p, n, log_a)
    exp = np.asarray(jx.ref.ssd_scan_ref(*arrays, chunk=chunk))
    t = list(map(torch.from_numpy, arrays))
    _close(ssd_kernel_model(*t, chunk), exp, MODEL_TOL)
    err = np.abs(ssd_kernel_model(*t, chunk, split=False).numpy() - exp)
    assert not (err <= BF16_TOL + BF16_TOL * np.abs(exp)).all()


def test_broadcast_b_c_read_as_a_copy():
    """B/C expanded over heads (head stride 0, the Mamba2 block's layout)
    give the numbers of a contiguous copy, through the op and the
    wrapper."""
    b, s, h, p, n, chunk = 2, 128, 4, 16, 8, 64
    x, la, bc, cc = _torch(ssd_inputs(4, b, s, h, p, n))
    bx = bc[:, :, :1].expand(b, s, h, n)
    cx = cc[:, :, :1].expand(b, s, h, n)
    assert bx.stride(2) == 0
    want = ref.ssd_chunked_ref(x, la, bx.contiguous(), cx.contiguous(),
                               chunk)[0]
    torch.testing.assert_close(ops.ssd_scan(x, la, bx, cx, chunk=chunk)[0],
                               want, rtol=0, atol=0)
    torch.testing.assert_close(ssd_scan_bshpn(x, la, bx, cx, chunk=chunk),
                               want, rtol=0, atol=0)


def test_kernel_route_raises_where_jax_asserts_or_drops():
    x, la, bc, cc = _torch(ssd_inputs(5, 1, 96, 2, 8, 8))
    with pytest.raises(ValueError, match=r"s % chunk"):
        ssm.ssd_chunked(x, la, bc, cc, 64, use_kernel=True)
    with pytest.raises(ValueError, match=r"s % chunk"):
        ssd_scan_bshpn(x, la, bc, cc, chunk=64)
    with pytest.raises(ValueError, match="initial_state"):
        ssm.ssd_chunked(x, la, bc, cc, 32, use_kernel=True,
                        initial_state=torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ssd_scan(x, la, bc, cc, chunk=32, impl="cuda")
    # the plain path pads and carries the state in
    y, st_ = ssm.ssd_chunked(x, la, bc, cc, 64,
                             initial_state=torch.zeros(1, 2, 8, 8))
    assert y.shape == x.shape and st_.shape == (1, 2, 8, 8)


def test_kernel_route_refuses_gradients_and_launches_nothing_on_cpu():
    x, la, bc, cc = _torch(ssd_inputs(6, 1, 64, 2, 8, 8))
    with pytest.raises(RuntimeError, match="no gradient"):
        ssd_scan_bshpn(x.requires_grad_(True), la, bc, cc, chunk=32)
    before = ssd_scan_bshpn.launches
    with torch.no_grad():
        ssd_scan_bshpn(x, la, bc, cc, chunk=32)
    assert ssd_scan_bshpn.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _cuda_inputs(seed, b, s, h, p, n, dtype, broadcast=False, log_a=None):
    x, la, bc, cc = _torch(ssd_inputs(seed, b, s, h, p, n), dtype, "cuda")
    if broadcast:
        bc = bc[:, :, :1].expand(b, s, h, n)
        cc = cc[:, :, :1].expand(b, s, h, n)
    if log_a is not None:
        la = torch.full_like(la, log_a)
    return x, la, bc, cc

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,broadcast", [
    *[(*shape, False) for shape in SHAPES],
    (2, 512, 8, 64, 64, 256, True),      # zamba2's Mamba2 head shape
    (1, 512, 2, 512, 512, 256, False),   # xlstm-350m's mLSTM head shape
])
def test_cuda_kernel_matches_plain_version(b, s, h, p, n, chunk, broadcast,
                                           dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dt = getattr(torch, dtype)
    x, la, bc, cc = _torch(ssd_inputs(7, b, s, h, p, n), dt, "cuda")
    if broadcast:
        bc = bc[:, :, :1].expand(b, s, h, n)
        cc = cc[:, :, :1].expand(b, s, h, n)
    before = ssd_scan_bshpn.launches
    with torch.no_grad():
        out = ops.ssd_scan(x, la, bc, cc, chunk=chunk, impl="cuda")[0]
    torch.cuda.synchronize()
    assert ssd_scan_bshpn.launches == before + 1
    want = ref.ssd_chunked_ref(x, la, bc, cc, chunk)[0]
    tol = MM_TOL if dtype == "float32" else BF16_TOL
    _close(out.float().cpu(), want.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,broadcast,log_a", [
    (1, 1024, 8, 64, 64, 256, True, 0.0),      # decay edges, zamba2 heads
    (1, 1024, 8, 64, 64, 256, True, -30.0),
    (1, 1024, 4, 512, 512, 256, False, None),  # the mLSTM, full length
    (2, 256, 3, 64, 64, 64, True, None),       # zamba2 smoke chunk
])
def test_cuda_kernel_edges_and_shapes(b, s, h, p, n, chunk, broadcast,
                                      log_a, dtype):
    _need_cuda()
    x, la, bc, cc = _cuda_inputs(10, b, s, h, p, n, getattr(torch, dtype),
                                 broadcast, log_a)
    with torch.no_grad():
        out = ops.ssd_scan(x, la, bc, cc, chunk=chunk, impl="cuda")[0]
    torch.cuda.synchronize()
    want = ref.ssd_chunked_ref(x, la, bc, cc, chunk)[0]
    _close(out.float().cpu(), want.float().cpu(),
           MM_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n", [(2, 1024, 64, 64, 64),
                                       (1, 512, 2, 512, 512)])
def test_cuda_kernel_repeats_bitwise(b, s, h, p, n, dtype):
    """Sums in a fixed order: two calls give the same bits."""
    _need_cuda()
    x, la, bc, cc = _cuda_inputs(11, b, s, h, p, n, getattr(torch, dtype),
                                 broadcast=n == 64)
    with torch.no_grad():
        first = ssd_scan_bshpn(x, la, bc, cc, chunk=256)
        second = ssd_scan_bshpn(x, la, bc, cc, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
