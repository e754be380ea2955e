"""The port's speculative-verify and int8 paged attention against the JAX
package's.

The same numpy-seeded inputs go through the port's plain versions
(``repro_torch.kernels.ref``), the JAX oracles (``repro.kernels.ref``) and
the Pallas kernels in interpret mode (``paged_verify_lanes`` and
``paged_attention_quant_lanes`` with ``interpret=True``).  The verify
sweep covers k in {1, 3, 4}, lengths on and across block edges, a lane
whose table is all garbage block 0, single-token lanes (length 0, k 1) and
a sliding window.  Tolerances are ``tests/test_kernel_oracles.py``'s: 2e-5
in f32, 2e-2 in bf16 (bf16 rounding of the output dominates).
``quantize_kv`` must give the JAX int8 values bit for bit on f32 input,
with scales within 1e-7 relative.

The verify kernel splits each lane's rows into fixed splits and merges the
splits' partial softmax states in a fixed order: a test-local emulation of
that split-and-merge (empty splits as m = -1e30, l = 0) equals the plain
version and the JAX oracle in f32, with splits cut at row 0, at block
edges and inside a window, and a lane on the garbage block.

Past the kernel's 64 query rows (k x groups) the wrapper launches it over
query chunks with ``lengths`` advanced by each chunk's offset: the plain
version over the chunks equals the plain version of the whole call and
the JAX oracle (f32, 12 and 16 groups).

The CUDA kernels run only on a card: their cases compare each kernel with
its plain version there and skip elsewhere.  JAX is imported by a fixture,
so on a machine with a card but no JAX the CUDA cases still run
(``python -m pytest --noconftest -m cuda tests/test_torch_paged_verify.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention_quant_lanes
from repro_torch.kernels.paged_verify import paged_verify_lanes

F32_TOL = 2e-5
BF16_TOL = 2e-2
SCALE_RTOL = 1e-7

VERIFY = [  # n, k, nh, nkv, hd, bs, B, window, dtype
    (4, 1, 8, 2, 64, 8, 4, None, "float32"),      # single-token verify
    (4, 3, 8, 2, 64, 8, 4, None, "float32"),      # GQA, block edges
    (3, 4, 4, 4, 32, 16, 2, None, "float32"),     # MHA
    (4, 4, 8, 1, 64, 8, 6, None, "float32"),      # deep tables, 8 groups
    (4, 3, 8, 2, 64, 8, 4, 5, "float32"),         # sliding window
    (4, 4, 4, 2, 32, 8, 3, None, "bfloat16"),     # serving dtype
    (2, 1, 2, 1, 16, 4, 2, None, "float32"),      # tiny, single token
]

QUANT = [  # n, nh, nkv, hd, bs, B, window, q dtype
    (3, 8, 2, 64, 8, 4, None, "float32"),
    (2, 4, 4, 32, 16, 2, None, "float32"),
    (3, 8, 2, 64, 8, 4, 5, "float32"),
    (3, 4, 2, 32, 8, 3, None, "bfloat16"),
]


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.paged_attention import paged_attention_quant_lanes
    from repro.kernels.paged_verify import paged_verify_lanes
    return SimpleNamespace(jnp=jnp, ref=jref, verify=paged_verify_lanes,
                           quant=paged_attention_quant_lanes)


def _tables(rng, n, B, P):
    """Distinct physical blocks per lane, never the garbage block 0."""
    return (rng.permutation(P - 1)[: n * B] + 1).reshape(n, B).astype(
        np.int32)


def _verify_inputs(seed, n, kk, nh, nkv, hd, bs, B):
    """Lane 0 starts at length 0 (its first query is the lane's only
    row); lane 1's queries straddle a block edge; the last lane reads only
    the garbage block (the tables the spec backend gives lanes outside a
    round); the others are random, all within the table."""
    rng = np.random.default_rng(seed)
    P = n * B + 2
    q = rng.standard_normal((n, kk, nh, hd), np.float32)
    kp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    vp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    tables = _tables(rng, n, B, P)
    cap = B * bs - kk                      # largest committed length
    lengths = rng.integers(0, cap + 1, n)
    lengths[0] = 0
    if n > 2:
        lengths[1] = min(cap, max(0, bs - 1 - kk // 2))
    tables[-1] = 0
    return q, kp, vp, tables, lengths.astype(np.int32)


def _quant_inputs(seed, n, nh, nkv, hd, bs, B):
    rng = np.random.default_rng(seed)
    P = n * B + 2
    q = rng.standard_normal((n, nh, hd), np.float32)
    kq = rng.integers(-127, 128, (P, bs, nkv, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (P, bs, nkv, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (P, bs, nkv)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (P, bs, nkv)).astype(np.float32)
    tables = _tables(rng, n, B, P)
    lengths = np.clip([max(1, (i * B * bs) // n) if i else bs // 2
                       for i in range(n)], 1, B * bs).astype(np.int32)
    lengths[-1] = 1                       # an inactive lane ...
    tables[-1] = 0                        # ... on the garbage block
    return q, kq, vq, ks, vs, tables, lengths


def _cast(arrays, dtype, float_idx, device="cpu"):
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(a).to(device)
        out.append(t.to(getattr(torch, dtype)) if i in float_idx else t)
    return out


def _jcast(jx, arrays, dtype, float_idx):
    dt = jx.jnp.dtype(dtype)
    return [jx.jnp.asarray(a, dt) if i in float_idx else jx.jnp.asarray(a)
            for i, a in enumerate(arrays)]


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("n,kk,nh,nkv,hd,bs,B,window,dtype", VERIFY)
def test_verify_ref_matches_jax_oracle_and_pallas(jx, n, kk, nh, nkv, hd, bs,
                                                  B, window, dtype):
    args = _verify_inputs(n * 10 + kk, n, kk, nh, nkv, hd, bs, B)
    out = ref.paged_verify_ref(*_cast(args, dtype, (0, 1, 2)), window=window)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (n, kk, nh, hd)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jargs = _jcast(jx, args, dtype, (0, 1, 2))
    _close(_np(out), jx.ref.paged_verify_ref(*jargs, window=window), tol)
    _close(_np(out), jx.verify(*jargs, window=window, interpret=True), tol)


def test_verify_k1_equals_single_token_decode():
    """One query per lane verifies exactly what a decode step attends:
    ``paged_verify_ref(lengths)`` == ``paged_attention_ref(lengths + 1)``."""
    q, kp, vp, t, le = _cast(_verify_inputs(3, 4, 1, 8, 2, 64, 8, 4),
                             "float32", (0, 1, 2))
    out = ref.paged_verify_ref(q, kp, vp, t, le)
    exp = ref.paged_attention_ref(q[:, 0], kp, vp, t, le + 1)
    _close(_np(out[:, 0]), _np(exp), F32_TOL)


def test_quantize_kv_is_bit_identical_to_jax(jx):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 7, 3, 64)).astype(np.float32) \
        * rng.uniform(1e-3, 30, (5, 7, 3, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero row: exact zeros back
    x[1, 2, 1] = 0.0                     # scale exactly 1.0, so these are
    x[1, 2, 1, :6] = [127.0, 0.5, -0.5, 1.5, 2.5, -2.5]   # exact ties
    q8, scale = ref.quantize_kv(torch.from_numpy(x))
    jq, jscale = jx.ref.quantize_kv(jx.jnp.asarray(x))
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                               rtol=SCALE_RTOL, atol=0)
    assert (q8[0, 0, 0] == 0).all()
    assert q8[1, 2, 1, :6].tolist() == [127, 0, 0, 2, 2, -2]   # half to even
    back = ref.dequantize_kv(q8, scale)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jx.ref.dequantize_kv(jq, jscale)),
        rtol=SCALE_RTOL, atol=0)
    assert (back - torch.from_numpy(x)).abs().max() \
        <= scale.max() / 2 + 1e-6


@pytest.mark.parametrize("n,nh,nkv,hd,bs,B,window,dtype", QUANT)
def test_quant_ref_matches_jax_oracle_and_pallas(jx, n, nh, nkv, hd, bs, B,
                                                 window, dtype):
    args = _quant_inputs(n * 7 + B, n, nh, nkv, hd, bs, B)
    out = ref.paged_attention_quant_ref(*_cast(args, dtype, (0,)),
                                        window=window)
    assert out.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jargs = _jcast(jx, args, dtype, (0,))
    _close(_np(out), jx.ref.paged_attention_quant_ref(*jargs, window=window),
           tol)
    _close(_np(out), jx.quant(*jargs, window=window, interpret=True), tol)


@pytest.mark.parametrize("kk,window", [(1, None), (3, None), (4, 5)])
def test_verify_quant_ref_matches_jax_oracle(jx, kk, window):
    n, nh, nkv, hd, bs, B = 4, 8, 2, 64, 8, 4
    q, *_ = _verify_inputs(kk, n, kk, nh, nkv, hd, bs, B)
    _, kq, vq, ks, vs, tables, _ = _quant_inputs(kk, n, nh, nkv, hd, bs, B)
    lengths = np.asarray([0, 5, 17, B * bs - kk], np.int32)
    args = (q, kq, vq, ks, vs, tables, lengths)
    out = ref.paged_verify_quant_ref(*_cast(args, "float32", (0,)),
                                     window=window)
    _close(_np(out), jx.ref.paged_verify_quant_ref(
        *_jcast(jx, args, "float32", (0,)), window=window), F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrappers_and_default_impl_run_the_plain_versions(dtype):
    """On CPU tensors the kernel wrappers and the ``ops`` entry points
    with the device default run the plain versions, bit for bit, and
    launch nothing."""
    v = _cast(_verify_inputs(5, 4, 3, 8, 2, 64, 8, 4), dtype, (0, 1, 2))
    qa = _cast(_quant_inputs(5, 3, 8, 2, 64, 8, 4), dtype, (0,))
    before = (paged_verify_lanes.launches,
              paged_attention_quant_lanes.launches)
    exp = ref.paged_verify_ref(*v)
    assert torch.equal(paged_verify_lanes(*v), exp)
    assert torch.equal(ops.paged_verify(*v), exp)
    exp = ref.paged_attention_quant_ref(*qa)
    assert torch.equal(paged_attention_quant_lanes(*qa), exp)
    assert torch.equal(ops.paged_attention_quant(*qa), exp)
    assert (paged_verify_lanes.launches,
            paged_attention_quant_lanes.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_verify(*v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_quant(*qa, impl="cuda")


NEG = -1e30


def _split_merge(q, kp, vp, tables, lengths, window, split):
    """The verify kernel's split-and-merge in plain torch: each lane's
    logical rows in fixed splits of ``split`` rows; per split and query
    row a partial (m, l, acc) with masked scores at -1e30 (an empty split
    keeps m = -1e30, l = 0); the merge walks the splits in order, skipping
    those with l = 0."""
    n, kk, nh, hd = q.shape
    _, bs, nkv, _ = kp.shape
    cap = tables.shape[1] * bs
    g = nh // nkv
    k = kp[tables.long()].reshape(n, cap, nkv, hd).float()
    v = vp[tables.long()].reshape(n, cap, nkv, hd).float()
    qg = q.reshape(n, kk, nkv, g, hd).float()
    pos = lengths.long()[:, None] + torch.arange(kk)[None, :]     # (n, k)
    out = torch.zeros(n, kk, nkv, g, hd)
    big = torch.full((n, kk, nkv, g), NEG)
    parts = []
    for lo in range(0, cap, split):
        rows = torch.arange(lo, min(lo + split, cap))
        mask = rows[None, None, :] <= pos[:, :, None]
        if window is not None:
            mask &= rows[None, None, :] > pos[:, :, None] - window
        mask = mask[:, :, None, None, :]                        # n k 1 1 s
        logits = torch.einsum("nqkgh,nskh->nqkgs", qg, k[:, rows]) \
            / np.sqrt(hd)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG))
        m = logits.amax(-1)
        mu = torch.where(m == NEG, torch.zeros_like(m), m)
        p = torch.exp(logits - mu[..., None]) * mask
        acc = torch.einsum("nqkgs,nskh->nqkgh", p, v[:, rows])
        parts.append((m, p.sum(-1), acc))
        big = torch.maximum(big, m)
    den = torch.zeros_like(big)
    for m, l, acc in parts:                                     # in order
        w = torch.where(l > 0, torch.exp(m - big), torch.zeros_like(m))
        den += l * w
        out += acc * w[..., None]
    out = out / den.clamp_min(1e-30)[..., None]
    return out.reshape(n, kk, nh, hd).to(q.dtype)


@pytest.mark.parametrize("split", [8, 16])
@pytest.mark.parametrize("n,kk,nh,nkv,hd,bs,B,window,dtype",
                         [c for c in VERIFY if c[-1] == "float32"])
def test_split_merge_matches_ref_and_jax(jx, split, n, kk, nh, nkv, hd, bs,
                                         B, window, dtype):
    """Splits of 8 or 16 rows over blocks of 4, 8 or 16: splits cut at
    row 0 (lane 0 has length 0), at block edges, inside the window (5
    rows), and the last lane reads only the garbage block."""
    args = _verify_inputs(n * 10 + kk, n, kk, nh, nkv, hd, bs, B)
    t = _cast(args, dtype, (0, 1, 2))
    out = _split_merge(*t, window, split)
    _close(_np(out), _np(ref.paged_verify_ref(*t, window=window)), F32_TOL)
    jargs = _jcast(jx, args, dtype, (0, 1, 2))
    _close(_np(out), jx.ref.paged_verify_ref(*jargs, window=window),
           F32_TOL)


def _long_verify_inputs(seed, lengths, kk, nh, nkv, hd, bs, B, q_dtype,
                        kv_dtype, device="cuda"):
    """Lanes of the given committed lengths, each on distinct random
    blocks for the rows it holds and the garbage block 0 elsewhere."""
    rng = np.random.default_rng(seed)
    need = [-(-(int(x) + kk) // bs) for x in lengths]
    P = sum(need) + 1
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), B), np.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    q = rng.standard_normal((len(lengths), kk, nh, hd), np.float32)
    kp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    vp = rng.standard_normal((P, bs, nkv, hd), np.float32)
    return (torch.from_numpy(q).to(device, getattr(torch, q_dtype)),
            torch.from_numpy(kp).to(device, getattr(torch, kv_dtype)),
            torch.from_numpy(vp).to(device, getattr(torch, kv_dtype)),
            torch.from_numpy(tables).to(device),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(device))


LONG_VERIFY = [  # lengths, k, nh, nkv, hd, bs, B, window, q dtype, kv dtype
    # a lane over 8 splits of 256 rows, a lane of length 0, block edges
    ((2500, 0, 15, 256, 1023), 4, 16, 8, 128, 16, 170, None, "bfloat16",
     "bfloat16"),
    # a window across a split edge (rows 301..603 cross row 512)
    ((600, 530, 3000), 4, 16, 8, 128, 16, 200, 300, "bfloat16",
     "bfloat16"),
    # k * groups = 64 rows
    ((700, 0, 257), 8, 16, 2, 128, 16, 48, None, "bfloat16", "bfloat16"),
    ((700, 0, 257), 8, 16, 2, 128, 16, 48, None, "float32", "float32"),
    # the four (q, kv) dtype pairs
    ((1100, 37, 511), 4, 16, 8, 128, 16, 80, None, "float32", "float32"),
    ((1100, 37, 511), 4, 16, 8, 128, 16, 80, None, "float32", "bfloat16"),
    ((1100, 37, 511), 4, 16, 8, 128, 16, 80, None, "bfloat16", "float32"),
    ((1100, 37, 511), 4, 16, 8, 128, 16, 80, None, "bfloat16", "bfloat16"),
    # head_dim 256 with 64 rows in f32 (32-row tiles fit shared memory)
    ((600, 3), 8, 16, 2, 256, 16, 40, 100, "float32", "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,kk,nh,nkv,hd,bs,B,window,q_dtype,kv_dtype",
                         LONG_VERIFY)
def test_cuda_split_verify_matches_plain_version(lengths, kk, nh, nkv, hd, bs,
                                                 B, window, q_dtype,
                                                 kv_dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = _long_verify_inputs(len(lengths) + kk, lengths, kk, nh, nkv, hd,
                               bs, B, q_dtype, kv_dtype)
    before = paged_verify_lanes.launches
    out = ops.paged_verify(*args, window=window, impl="cuda")
    exp = ref.paged_verify_ref(*args, window=window)
    torch.cuda.synchronize()
    assert paged_verify_lanes.launches == before + 1
    assert out.dtype == args[0].dtype
    tol = F32_TOL if q_dtype == "float32" else BF16_TOL
    _close(_np(out), _np(exp), tol)


@pytest.mark.cuda
def test_cuda_verify_repeats_bitwise():
    """Two calls at the spec serve path's shape (8 lanes, k 4, 16/8 heads
    of 128, bf16, lengths up to ~1,050) give the same bits: the merge
    takes the splits in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    lengths = (1050, 981, 700, 512, 255, 64, 16, 0)
    args = _long_verify_inputs(8, lengths, 4, 16, 8, 128, 16, 80,
                               "bfloat16", "bfloat16")
    first = ops.paged_verify(*args, impl="cuda")
    second = ops.paged_verify(*args, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("n,kk,nh,nkv,hd,bs,B,window,dtype", VERIFY)
def test_cuda_verify_kernel_matches_plain_version(n, kk, nh, nkv, hd, bs, B,
                                                  window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = _cast(_verify_inputs(n * 10 + kk, n, kk, nh, nkv, hd, bs, B),
                 dtype, (0, 1, 2), "cuda")
    before = paged_verify_lanes.launches
    out = ops.paged_verify(*args, window=window, impl="cuda")
    exp = ref.paged_verify_ref(*args, window=window)
    torch.cuda.synchronize()
    assert paged_verify_lanes.launches == before + 1
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_np(out), _np(exp), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nh,nkv,hd,bs,B,window,dtype", QUANT)
def test_cuda_quant_kernel_matches_plain_version(n, nh, nkv, hd, bs, B,
                                                 window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = _cast(_quant_inputs(n * 7 + B, n, nh, nkv, hd, bs, B), dtype,
                 (0,), "cuda")
    before = paged_attention_quant_lanes.launches
    out = ops.paged_attention_quant(*args, window=window, impl="cuda")
    exp = ref.paged_attention_quant_ref(*args, window=window)
    torch.cuda.synchronize()
    assert paged_attention_quant_lanes.launches == before + 1
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(_np(out), _np(exp), tol)


# ---------------------------------------------------------------------------
# k x groups past the kernel's 64 rows: query chunks
# ---------------------------------------------------------------------------

CHUNKED = [  # lengths, k, nh, nkv, hd, bs, B, window
    # command-r-plus-104b's 12 groups at k 8: 96 rows, chunks of 5 + 3
    ((700, 0, 257, 40), 8, 12, 1, 32, 16, 48, None),
    ((700, 0, 257, 40), 8, 12, 1, 32, 16, 48, 37),
    # 16 groups at k 5: 80 rows, chunks of 4 + 1
    ((300, 15, 16), 5, 32, 2, 32, 8, 40, None),
]


@pytest.mark.parametrize("lengths,kk,nh,nkv,hd,bs,B,window", CHUNKED)
def test_query_chunks_add_up_to_the_whole_verify(lengths, kk, nh, nkv, hd,
                                                 bs, B, window, jx):
    """The wrapper's route for k x groups > 64: the plain version over
    each chunk of ``query_chunk(k, groups)`` queries, with ``lengths``
    advanced by the chunk's offset, is the plain version of the whole call
    and the JAX oracle (f32), with a window inside the chunks and a lane
    of length 0."""
    from repro_torch.kernels.paged_verify import query_chunk
    args = _long_verify_inputs(len(lengths) + kk, lengths, kk, nh, nkv, hd,
                               bs, B, "float32", "float32", device="cpu")
    q, kp, vp, tables, le = args
    chunk = query_chunk(kk, nh // nkv)
    assert chunk * (nh // nkv) <= 64 < kk * (nh // nkv)
    parts = [ref.paged_verify_ref(q[:, c0:c0 + chunk].contiguous(), kp, vp,
                                  tables, le + c0, window=window)
             for c0 in range(0, kk, chunk)]
    whole = ref.paged_verify_ref(q, kp, vp, tables, le, window=window)
    _close(_np(torch.cat(parts, dim=1)), _np(whole), F32_TOL)
    jargs = [jx.jnp.asarray(a.numpy()) for a in args]
    _close(_np(torch.cat(parts, dim=1)),
           jx.ref.paged_verify_ref(*jargs, window=window), F32_TOL)


def test_query_chunk_sizes():
    from repro_torch.kernels.paged_verify import query_chunk
    assert query_chunk(4, 16) == 4 and query_chunk(8, 8) == 8
    assert query_chunk(8, 12) == 5 and query_chunk(5, 16) == 4
    assert query_chunk(3, 64) == 1 and query_chunk(1, 64) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,kk,nh,nkv,hd,bs,B,window",
                         CHUNKED + [((1500, 3, 800), 8, 96, 8, 128, 16, 100,
                                     None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_verify_past_64_rows_matches_plain_version(
        lengths, kk, nh, nkv, hd, bs, B, window, dtype):
    """The kernel over query chunks equals its plain version (the last
    case: command-r-plus-104b's 96/8 heads of 128 at k 8); one call counts
    once."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    args = _long_verify_inputs(len(lengths) + kk, lengths, kk, nh, nkv, hd,
                               bs, B, dtype, dtype)
    before = paged_verify_lanes.launches
    out = ops.paged_verify(*args, window=window, impl="cuda")
    exp = ref.paged_verify_ref(*args, window=window)
    torch.cuda.synchronize()
    assert paged_verify_lanes.launches == before + 1
    _close(_np(out), _np(exp), F32_TOL if dtype == "float32" else BF16_TOL)
