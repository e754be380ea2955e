"""Plain models of the rounding in the port's SwiGLU and RMSNorm kernels,
held against the JAX package's.

``swiglu_2d`` (``src/repro_torch/kernels/csrc/swiglu.cu``) takes one of two
routes by its rows (``swiglu.swiglu_route``):

* ``stream`` (at most 32 bf16 or 8 f32 rows): the fused decode layer's
  weight-streaming
  products (``test_torch_fused_decode._product_slices``): g and u as sums
  of depth slices with f32 activations split into bf16 hi + lo against
  bf16-exact weights (bf16 x is exact: no lo part), act = silu(g) * u in
  f32, split again for the down product; f32 weights on the CUDA cores
  (f32 sums, no rounding).
* ``tiled``: bf16 operands are exact, g and u are f32 sums, the f32
  hidden silu(g) * u goes to the down product as bf16 hi + lo, two
  products, whose depth slices (split where the output tiles would not
  fill the card) are added in order.  f32 operands are each split into
  bf16 hi + lo and every product is three (hi.hi + hi.lo + lo.hi), the
  hidden staying f32.

Each model meets the f32 (2e-4) and bf16 (2e-2) tolerances against JAX
``swiglu_2d(interpret=True)`` and the JAX oracle at small widths, and
against ``ref.swiglu_ref`` at qwen3-0.6b's widths (d 1024, f 3072), where
the cheaper f32 roundings — two products (x split, weights rounded once)
or one (both rounded once) — miss 2e-4, and the bf16 hidden rounded once
(one down product) misses 2e-2 where the weights' scale makes the
outputs large beside their smallest elements.  RMSNorm's plain version
gives the JAX kernel's (interpret) and the oracle's numbers at widths
that are no multiple of the kernel's 16-byte vectors and with x and w of
different dtypes.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_fused_decode import _product_slices, _slice_width

from repro_torch.kernels import ref
from repro_torch.kernels.swiglu import bound_flops, swiglu_route

F32_TOL = 2e-5
BF16_TOL = 2e-2
MM_TOL = 2e-4
TOL = {torch.float32: MM_TOL, torch.bfloat16: BF16_TOL}
# csrc/swiglu.cu kBN, kTargetBlocks, kSMs
TILE_N, TARGET_BLOCKS, SMS = 64, 264, 132


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.rmsnorm import rms_norm_2d as jrms
    from repro.kernels.swiglu import swiglu_2d as jswiglu
    return jnp, jref, jrms, jswiglu


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _product(a, b, products):
    """a @ b with f32 sums over operands split into bf16 hi + lo: 3 =
    hi.hi + hi.lo + lo.hi (the kernel's), 2 = b rounded once, 1 = both
    rounded once."""
    ah, al = _split(a)
    bh, bl = _split(b)
    terms = {3: (ah @ bl, al @ bh, ah @ bh), 2: (al @ bh, ah @ bh),
             1: (ah @ bh,)}[products]
    return sum(terms)


def _silu(g):
    return g / (1.0 + torch.exp(-g))      # the kernels' form of silu


def _down_slices(m, d, f, itemsize):
    """swiglu.cu tiled_layout: the depth of each slice of the down
    product (f when its output tiles fill the 132 SMs)."""
    bm = 128 if m > 64 else 64
    n = -(-m // bm) * -(-d // TILE_N)
    bk = 128 // itemsize
    chunks = -(-f // bk)
    s = 1 if n >= SMS else TARGET_BLOCKS // n
    s = min(max(s, 1), chunks)
    return -(-chunks // s) * bk


def tiled_model(x, wg, wu, wd, products=3):
    """The tiled route's numerics on f32 tensors holding x's dtype's
    values.  ``products`` 3, 2, 1: f32 operands split as ``_product``
    says; 0: bf16 operands (exact) with the hidden split into hi + lo for
    the down product; -1: the same with the hidden rounded once."""
    m, d = x.shape
    f = wg.shape[1]
    x, wg, wu, wd = (t.float() for t in (x, wg, wu, wd))
    if products <= 0:                     # bf16: exact operands
        h = _silu(x @ wg) * (x @ wu)
        parts = _split(h) if products == 0 else (_bf16(h),)
        kps = _down_slices(m, d, f, 2)
        out = torch.zeros(m, d)
        for k in range(0, f, kps):
            out = out + sum(p[:, k:k + kps] @ wd[k:k + kps]
                            for p in reversed(parts))
        return out
    h = _silu(_product(x, wg, products)) * _product(x, wu, products)
    kps = _down_slices(m, d, f, 4)
    out = torch.zeros(m, d)
    for k in range(0, f, kps):
        out = out + _product(h[:, k:k + kps], wd[k:k + kps], products)
    return out


def _f32_slices(x, w, n_mats):
    """A product on the CUDA cores: f32 sums over the same depth slices."""
    kps = _slice_width(x.shape[1], w.shape[1], n_mats, x.shape[0])
    return [x[:, k:k + kps] @ w[k:k + kps]
            for k in range(0, x.shape[1], kps)]


def stream_model(x, wg, wu, wd):
    """The stream route's numerics: bf16 weights on the tensor cores with
    split activations, f32 weights on the CUDA cores (f32 sums)."""
    if x.dtype == torch.bfloat16:
        def slices(a, w, n_mats):
            return _product_slices(a, w, n_mats, True)
    else:
        slices = _f32_slices
    x, wg, wu, wd = (t.float() for t in (x, wg, wu, wd))
    g = sum(slices(x, wg, 2))
    u = sum(slices(x, wu, 2))
    out = torch.zeros(x.shape[0], wd.shape[1])
    for part in slices(_silu(g) * u, wd, 1):
        out = out + part
    return out


def model(route, x, wg, wu, wd):
    if route == "stream":
        return stream_model(x, wg, wu, wd)
    return tiled_model(x, wg, wu, wd,
                       0 if x.dtype == torch.bfloat16 else 3)


def _inputs(seed, m, d, f, dtype, scale=None):
    """numpy-seeded x ~ N(0, 1) and weights ~ N(0, scale^2) (default
    1/fan_in), as tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((m, d), np.float32)] + [
        (rng.standard_normal(s) * (scale or s[0] ** -0.5))
        .astype(np.float32) for s in ((d, f), (d, f), (f, d))]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _within(out, exp, tol):
    """|out - exp| <= tol + tol |exp| everywhere (as chip_smoke.py)."""
    out, exp = (torch.from_numpy(np.array(t, np.float32))
                for t in (out, exp))
    return bool(((out - exp).abs() <= tol + tol * exp.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["stream", "tiled"])
@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (9, 64, 192),
                                   (40, 128, 256), (70, 96, 200)])
def test_models_match_jax_kernel_and_oracle(jx, route, dtype, m, d, f):
    jnp, jref, _, jswiglu = jx
    x, wg, wu, wd = _inputs(m * 100 + d + f, m, d, f, dtype)
    out = model(route, x, wg, wu, wd).to(dtype).float().numpy()
    jargs = [jnp.asarray(t.float().numpy()) for t in (x, wg, wu, wd)]
    assert _within(out, jswiglu(*jargs, interpret=True), TOL[dtype])
    assert _within(out, jref.swiglu_ref(*jargs), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 32, 33, 127])
def test_models_meet_the_gates_at_full_width(m, dtype):
    """d 1024, f 3072 (qwen3-0.6b): the rounding of the route the wrapper
    gives m rows against the f32 plain version."""
    route = swiglu_route(m, dtype)
    x, wg, wu, wd = _inputs(m, m, 1024, 3072, dtype)
    out = model(route, x, wg, wu, wd).to(dtype)
    assert _within(out.float(), ref.swiglu_ref(x, wg, wu, wd).float(),
                   TOL[dtype])


@pytest.mark.parametrize("products", [1, 2])
def test_cheaper_f32_roundings_miss_the_gate(products):
    """Three products per split pair meet 2e-4 at full width; two (the
    weights rounded once) or one (both operands rounded once, TF32's
    class of error) do not."""
    x, wg, wu, wd = _inputs(5, 33, 1024, 3072, torch.float32)
    exp = ref.swiglu_ref(x, wg, wu, wd)
    assert _within(tiled_model(x, wg, wu, wd, 3), exp, MM_TOL)
    assert not _within(tiled_model(x, wg, wu, wd, products), exp, MM_TOL)


@pytest.mark.parametrize("m", [33, 127])
def test_bf16_hidden_split_where_rounding_once_misses_the_gate(m):
    """Weights of scale 0.05 (outputs ~4, as in the card tests): the
    hidden split into hi + lo keeps the tiled bf16 route within 2e-2 of
    the f32 plain version; rounded once to bf16 it is not."""
    x, wg, wu, wd = _inputs(m + 1, m, 1024, 3072, torch.bfloat16, 0.05)
    exp = ref.swiglu_ref(x.float(), wg.float(), wu.float(), wd.float())

    def out(products):
        return tiled_model(x, wg, wu, wd, products).to(torch.bfloat16)
    assert _within(out(0).float(), exp, BF16_TOL)
    assert not _within(out(-1).float(), exp, BF16_TOL)


def test_route_boundary_and_bound_flops():
    """bf16: 32 rows stream, 33 tile; f32: 8 stream, 9 tile.  The tiled
    f32 route issues three tensor-core products for each of the
    reference's, the stream f32 route runs the reference's on the CUDA
    cores."""
    for dtype, last in ((torch.bfloat16, 32), (torch.float32, 8)):
        assert swiglu_route(last, dtype) == "stream"
        assert swiglu_route(last + 1, dtype) == "tiled"
    fl = 6 * 512 * 512 * 1024
    assert bound_flops(512, 512, 1024, torch.float32) == (3 * fl, "tensor")
    assert bound_flops(512, 512, 1024, torch.bfloat16) == (fl, "tensor")
    assert bound_flops(8, 512, 1024, torch.float32) == (fl // 64, "f32")


@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,d", [(3, 13), (8, 100), (33, 1000)])
def test_rms_norm_ref_matches_jax_at_ragged_widths(jx, rows, d, xd, wd):
    """d % 8 != 0 (the kernel's single-element path in bf16) and the four
    x / w dtype pairs: the plain version against the JAX kernel
    (interpret) and oracle, at the tolerance of x's dtype."""
    jnp, jref, jrms, _ = jx
    rng = np.random.default_rng(rows * 7 + d)
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32)).to(xd)
    w = torch.from_numpy((rng.standard_normal(d) * 0.1 + 1.0)
                         .astype(np.float32)).to(wd)
    out = ref.rms_norm_ref(x, w)
    assert out.dtype == xd
    tol = F32_TOL if xd == torch.float32 else BF16_TOL
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jxa = jnp.asarray(x.float().numpy()).astype(jdt[xd])
    jwa = jnp.asarray(w.float().numpy()).astype(jdt[wd])
    got = out.float().numpy()
    assert _within(got, np.asarray(jrms(jxa, jwa, interpret=True),
                                   np.float32), tol)
    assert _within(got, np.asarray(jref.rms_norm_ref(jxa, jwa), np.float32),
                   tol)
    assert torch.equal(out, ref.rms_norm_ref(x, w))     # repeats bitwise


def test_silu_forms_agree():
    """The kernels' silu, g / (1 + exp(-g)), is F.silu to f32 rounding."""
    g = torch.linspace(-30, 30, 10001)
    assert torch.allclose(_silu(g), F.silu(g), rtol=1e-6, atol=1e-7)
