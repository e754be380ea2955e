"""The port's paged attention against the JAX package's.

The same numpy-seeded inputs go through the port's plain version
(``repro_torch.kernels.ref.paged_attention_ref``), the JAX oracle
(``repro.kernels.ref.paged_attention_ref``) and the Pallas kernel in
interpret mode (``paged_attention_lanes(..., interpret=True)``), over the
shape sweep of ``tests/test_kernels.py`` plus its stale-page and
garbage-block cases.  Tolerances are ``tests/test_kernel_oracles.py``'s:
2e-5 in f32, 2e-2 in bf16 (bf16 rounding of the output dominates).

The kernels split each lane's rows into fixed splits and merge the
splits' partial softmax states in a fixed order: a test-local emulation
of that split-and-merge, at the kernel's own split size and at 8 and 16
rows over blocks of 4, 8 and 16, for fp pages and for int8 pages with
their scales applied where the kernel applies them (the K scale to the
score, the V scale to the probability), equals the plain versions and the
JAX oracles in f32 (2e-5).  Its lanes: one of length 1 on the garbage
block, one ending exactly on a split edge, one a row past it, and one
whose window starts inside a split.

The CUDA kernels themselves run only on a card: their cases compare them
with the plain versions there and skip elsewhere — long ragged lanes over
many splits in bf16 and f32, fp and int8, the four fp dtype pairs, a
window of 512 across split edges, two calls giving the same bits, and
every shape of the sweep launching once.  The JAX side is imported by a
fixture, so on a machine with a card but no JAX the CUDA cases still run
(``python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import (SPLIT_ROWS, n_splits,
                                                 paged_attention_lanes,
                                                 paged_attention_quant_lanes)

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
                           quant_ref=jref.paged_attention_quant_ref,
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


NEG = -1e30


def _split_merge(q, kp, vp, tables, lengths, window, split, scales=None):
    """The decode kernels' split-and-merge in plain torch: each lane's
    logical rows in fixed splits of ``split`` rows; per split and query
    head a partial (m, l, acc) with masked scores at -1e30 (an empty split
    keeps m = -1e30, l = 0); the merge walks the splits in order, skipping
    those with l = 0.  With ``scales`` = (k_scales, v_scales) the pages are
    int8 and, as in the kernel, a row's K scale multiplies its score and
    its V scale its probability."""
    n, nh, hd = q.shape
    _, bs, nkv, _ = kp.shape
    cap = tables.shape[1] * bs
    g = nh // nkv
    tl = tables.long()
    k = kp[tl].reshape(n, cap, nkv, hd).float()
    v = vp[tl].reshape(n, cap, nkv, hd).float()
    if scales is None:
        ks = vs = torch.ones(n, cap, nkv)
    else:
        ks, vs = (s[tl].reshape(n, cap, nkv).float() for s in scales)
    qg = q.reshape(n, nkv, g, hd).float()
    le = lengths.long()[:, None]
    out = torch.zeros(n, nkv, g, hd)
    big = torch.full((n, nkv, g), NEG)
    parts = []
    for lo in range(0, cap, split):
        rows = torch.arange(lo, min(lo + split, cap))
        mask = rows[None, :] < le
        if window is not None:
            mask &= rows[None, :] >= le - window
        mask = mask[:, None, None, :]                             # n 1 1 s
        logits = torch.einsum("nkgh,nskh->nkgs", qg, k[:, rows]) \
            * ks[:, rows].permute(0, 2, 1)[:, :, None, :] / np.sqrt(hd)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG))
        m = logits.amax(-1)
        mu = torch.where(m == NEG, torch.zeros_like(m), m)
        p = torch.exp(logits - mu[..., None]) * mask
        pv = p * vs[:, rows].permute(0, 2, 1)[:, :, None, :]
        acc = torch.einsum("nkgs,nskh->nkgh", pv, v[:, rows])
        parts.append((m, p.sum(-1), acc))
        big = torch.maximum(big, m)
    den = torch.zeros_like(big)
    for m, l, acc in parts:                                     # in order
        w = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        den += l * w
        out += acc * w[..., None]
    out = out / den.clamp_min(1e-30)[..., None]
    return out.reshape(n, nh, hd).to(q.dtype)


def _split_inputs(seed, split, bs, quant, n_heads=(8, 2), hd=32):
    """Lanes: length 1 on the garbage block 0 (an inactive lane), one
    ending exactly on a split edge, one a row past it, one 2.5 splits long
    (a window starts inside its last split), each on distinct random
    blocks for the rows it holds and the garbage block elsewhere."""
    rng = np.random.default_rng(seed)
    nh, nkv = n_heads
    lengths = np.asarray([1, split, split + 1, 2 * split + split // 2],
                         np.int32)
    B = -(-int(lengths.max()) // bs) + 1
    need = [0] + [-(-int(x) // bs) for x in lengths[1:]]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    q = rng.standard_normal((len(lengths), nh, hd), np.float32)
    if not quant:
        kp = rng.standard_normal((P, bs, nkv, hd), np.float32)
        vp = rng.standard_normal((P, bs, nkv, hd), np.float32)
        return q, kp, vp, tables, lengths
    kq = rng.integers(-127, 128, (P, bs, nkv, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, bs, nkv, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (P, bs, nkv)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (P, bs, nkv)).astype(np.float32)
    return q, kq, vq, ks, vs, tables, lengths


SPLIT_CASES = [  # bs, window: a window of 5 / 37 starts inside a split
    (4, None), (8, 5), (16, 37)]


@pytest.mark.parametrize("split", [SPLIT_ROWS, 16, 8])
@pytest.mark.parametrize("bs,window", SPLIT_CASES)
def test_split_merge_matches_ref_and_jax(jx, split, bs, window):
    """fp pages: the emulated split-and-merge equals the plain version and
    the JAX oracle (f32, 2e-5); splits of 16 cut at block edges, of 8
    inside blocks of 16."""
    args = _split_inputs(split + bs, split, bs, quant=False)
    t = [torch.from_numpy(a) for a in args]
    out = _split_merge(*t, window, split)
    _close(_np(out), _np(ref.paged_attention_ref(*t, window=window)),
           F32_TOL)
    _close(_np(out), jx.ref(*_jax(jx, args, "float32"), window=window),
           F32_TOL)


@pytest.mark.parametrize("split", [SPLIT_ROWS, 16, 8])
@pytest.mark.parametrize("bs,window", SPLIT_CASES)
def test_split_merge_int8_matches_ref_and_jax(jx, split, bs, window):
    """int8 pages with per-row scales: the emulated split-and-merge (K
    scale on the score, V scale on the probability) equals the plain
    dequantizing version and the JAX oracle (f32, 2e-5)."""
    args = _split_inputs(split + bs + 1, split, bs, quant=True)
    q, kq, vq, ks, vs, tables, lengths = (torch.from_numpy(a) for a in args)
    out = _split_merge(q, kq, vq, tables, lengths, window, split,
                       scales=(ks, vs))
    _close(_np(out), _np(ref.paged_attention_quant_ref(
        q, kq, vq, ks, vs, tables, lengths, window=window)), F32_TOL)
    jargs = [jx.jnp.asarray(a) for a in args]
    _close(_np(out), jx.quant_ref(*jargs, window=window), F32_TOL)


def _long_inputs(seed, lengths, nh, nkv, hd, bs, q_dtype, kv_dtype,
                 device="cuda"):
    """Lanes of the given lengths, each on distinct random blocks for the
    rows it holds and the garbage block 0 elsewhere; a lane of length 1
    reads only the garbage block.  kv_dtype "int8" gives int8 pages and
    f32 scales (``ref.quantize_kv`` of normal values)."""
    rng = np.random.default_rng(seed)
    B = -(-max(lengths) // bs)
    need = [0 if x == 1 else -(-int(x) // bs) for x in lengths]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    q = torch.from_numpy(rng.standard_normal((len(lengths), nh, hd),
                                             np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, bs, nkv, hd), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, bs, nkv, hd), np.float32))
    q = q.to(device, getattr(torch, q_dtype))
    tl = torch.from_numpy(tables).to(device)
    le = torch.from_numpy(np.asarray(lengths, np.int32)).to(device)
    if kv_dtype == "int8":
        kq, ks = ref.quantize_kv(kp)
        vq, vs = ref.quantize_kv(vp)
        return tuple(x.to(device) for x in (kq, vq, ks, vs)), q, tl, le
    dt = getattr(torch, kv_dtype)
    return (kp.to(device, dt), vp.to(device, dt)), q, tl, le


def _run(pages, q, tables, lengths, window):
    """(kernel, plain) outputs, and the launch count's step, of the fp or
    the int8 entry point, by the pages' dtype."""
    if pages[0].dtype == torch.int8:
        counter = paged_attention_quant_lanes
        before = counter.launches
        out = ops.paged_attention_quant(q, *pages, tables, lengths,
                                        window=window, impl="cuda")
        exp = ref.paged_attention_quant_ref(q, *pages, tables, lengths,
                                            window=window)
    else:
        counter = paged_attention_lanes
        before = counter.launches
        out = ops.paged_attention(q, *pages, tables, lengths, window=window,
                                  impl="cuda")
        exp = ref.paged_attention_ref(q, *pages, tables, lengths,
                                      window=window)
    torch.cuda.synchronize()
    return out, exp, counter.launches - before


LONG_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 889, 4096)

LONG = [  # lengths, nh, nkv, hd, bs, window, q dtype, kv dtype
    (LONG_LENGTHS, 16, 8, 128, 16, None, "bfloat16", "bfloat16"),
    (LONG_LENGTHS, 16, 8, 128, 16, None, "float32", "float32"),
    (LONG_LENGTHS, 16, 8, 128, 16, None, "bfloat16", "int8"),
    (LONG_LENGTHS, 16, 8, 128, 16, None, "float32", "int8"),
    # the four fp (q, kv) dtype pairs
    ((1100, 37, 511, 1), 16, 8, 128, 16, None, "float32", "bfloat16"),
    ((1100, 37, 511, 1), 16, 8, 128, 16, None, "bfloat16", "float32"),
    # a window of 512 across split edges (rows 377..888, 3584..4095)
    (LONG_LENGTHS, 16, 8, 128, 16, 512, "bfloat16", "bfloat16"),
    (LONG_LENGTHS, 16, 8, 128, 16, 512, "bfloat16", "int8"),
    # head_dim 256 in f32 (one ring stage), 8 query heads per KV head
    ((700, 1, 129), 16, 2, 256, 16, 300, "float32", "float32"),
    ((700, 1, 129), 16, 2, 256, 16, None, "bfloat16", "int8"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,nh,nkv,hd,bs,window,q_dtype,kv_dtype",
                         LONG)
def test_cuda_split_kernels_match_plain_version(lengths, nh, nkv, hd, bs,
                                                window, q_dtype, kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    pages, q, tables, le = _long_inputs(len(lengths) + hd, lengths, nh, nkv,
                                        hd, bs, q_dtype, kv_dtype)
    out, exp, launched = _run(pages, q, tables, le, window)
    assert launched == 1
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    tol = F32_TOL if q_dtype == "float32" else BF16_TOL
    _close(_np(out), _np(exp), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cuda_split_kernels_repeat_bitwise(kv_dtype):
    """Two calls at the serve path's shape (8 lanes of 79..890 rows,
    58-block tables, 16/8 heads of 128, bf16 q) give the same bits: the
    merge takes the splits in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    lengths = (890, 273, 564, 332, 368, 112, 145, 88)
    pages, q, tables, le = _long_inputs(17, lengths, 16, 8, 128, 16,
                                        "bfloat16", kv_dtype)
    pad = torch.zeros(len(lengths), 58 - tables.shape[1], dtype=torch.int32,
                      device="cuda")
    tables = torch.cat([tables, pad], 1).contiguous()
    first, _, _ = _run(pages, q, tables, le, None)
    second, exp, _ = _run(pages, q, tables, le, None)
    assert torch.equal(first, second)
    _close(_np(first), _np(exp), BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nh,nkv,hd,bs,B,P,window,dtype", SWEEP)
def test_cuda_sweep_shapes_launch_once(n, nh, nkv, hd, bs, B, P, window,
                                       dtype):
    """Every shape the one-block-per-lane kernel took still launches the
    split kernels: one counted call, the plain version's result."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = _torch(_inputs(n * 100 + B, n, nh, nkv, hd, bs, B, P), dtype,
                  "cuda")
    out, exp, launched = _run(args[1:3], args[0], args[3], args[4], window)
    assert launched == 1
    _close(_np(out), _np(exp), F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
def test_cuda_split_count_follows_the_table_width():
    """The library's split count is ceil(n_table * bs / SPLIT_ROWS), at
    least one, never a function of the lengths."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for n_table, bs in ((0, 16), (1, 4), (8, 16), (9, 16), (58, 16),
                        (256, 16), (33, 8)):
        assert n_splits(n_table, bs) == max(1, -(-n_table * bs
                                                 // SPLIT_ROWS))
