"""The fp8 e4m3 KV cache in the port against the JAX package.

``ArchConfig.kv_cache_dtype="float8_e4m3fn"`` halves the KV cache's bytes:
rows are cast on write and upcast to f32 where attention reads them, in
the contiguous cache and in the paged pool alike.

* JAX's ``test_fp8_kv_cache_decode`` on the port (qwen3-0.6b and
  mixtral-8x22b smoke): no NaN, and the softmax within a mean 2e-3 of the
  bf16 cache's (the JAX test's bound).
* The cache's bits: the same f32 rows written through each package's
  contiguous and paged writes give the same e4m3 bytes; eight f32 decode
  steps of both packages with the same weights give logits within 2e-5
  (the f32 bound of ``tests/test_kernel_oracles.py``) and caches that
  agree to one e4m3 step where the f32 rows rounded apart.
* The bytes every admission decision charges (``decode_state_bytes``,
  ``kv_block_bytes``) equal JAX's for every config, half of bf16's K/V.
* A paged engine over fp8 pages with prefix sharing and the host tier on
  admits, tick by tick, what JAX's engine admits under the same budget,
  with the same tokens (f32 compute), and more than the bf16 pool does.

The CUDA cases hold each e4m3 route (split-KV decode, the fused layer's
attention phase, verify) against its plain version and repeat bitwise;
they skip without a card ("no CUDA device").  The JAX side is imported
inside the CPU cases, so the card's run needs no JAX (``python -m pytest
--noconftest -m cuda tests/test_torch_fp8_kv.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_decode import fused_decode_layer
from repro_torch.kernels.paged_attention import paged_attention_lanes
from repro_torch.kernels.paged_verify import paged_verify_lanes
from repro_torch.models import api
from repro_torch.models import layers as nn

FP8 = "float8_e4m3fn"
F32_TOL = 2e-5
BF16_TOL = 2e-2
MAX_SEQ = 64


def _jax():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    return jax, jget_config, japi


def _f32(cfg):
    return cfg.replace(dtype="float32", kv_cache_dtype=FP8)


# ---------------------------------------------------------------------------
# decode through the contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_fp8_kv_cache_decode(arch):
    """Serving optimization: the fp8 cache decodes without blowup and
    tracks the bf16-cache logits closely (JAX's test, on the port)."""
    cfg16 = get_config(arch, smoke=True)
    cfg8 = cfg16.replace(kv_cache_dtype=FP8)
    params = api.init_params(cfg16, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg16.vocab_size, (2, 8)))
    outs = {}
    for name, cfg in (("f8", cfg8), ("bf16", cfg16)):
        state = api.init_decode_state(cfg, 2, 16, "cpu")
        for i in range(8):
            logits, state = api.decode_step(cfg, params, state,
                                            toks[:, i:i + 1])
        outs[name] = torch.softmax(logits.float(), dim=-1)
    assert not torch.isnan(outs["f8"]).any()
    assert float((outs["f8"] - outs["bf16"]).abs().mean()) < 2e-3


def _e4m3_rows(seed, shape):
    """f32 rows over e4m3's range: normals, subnormals (|x| < 2^-6),
    exact ties between two e4m3 values and the largest finite, 448."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 4
    flat = x.reshape(-1)
    flat[:8] = [2.0 ** -7, -2.0 ** -9, 2.0 ** -10, 1.0625, -1.1875,
                448.0, -448.0, 0.0]
    flat[8:16] *= 2.0 ** -8
    return x


def test_fp8_cache_bits_equal_jax_after_the_same_writes():
    """The same f32 rows through each package's write paths: the
    contiguous cache's slice write (JAX's ``dynamic_update_slice`` of
    ``k.astype(cache dtype)``) and the paged scatter (``_scatter_kv_rows``)
    give the same e4m3 bytes."""
    jax, jget_config, _ = _jax()
    import jax.numpy as jnp
    from repro.models import layers as jnn
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype=FP8)
    cfg = _f32(get_config("qwen3-0.6b", smoke=True))
    nkv, hd = cfg.n_kv_heads, cfg.head_dim
    rows = _e4m3_rows(0, (2, 5, nkv, hd))
    cache = nn.init_kv_cache(cfg, 2, 16, "cpu", n_layers=1)
    nn.store_rows(cache["k"][0], (slice(None), slice(3, 8)),
                  torch.from_numpy(rows))
    jcache = jnn.init_kv_cache(jcfg, 2, 16, n_layers=1)
    jk = jax.lax.dynamic_update_slice_in_dim(
        jcache["k"][0], jnp.asarray(rows).astype(jcache["k"].dtype), 3,
        axis=1)
    assert cache["k"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        cache["k"][0].view(torch.uint8).numpy(),
        np.asarray(jk).view(np.uint8))

    P, bs = 6, 4
    kr, vr = _e4m3_rows(1, (3, nkv, hd)), _e4m3_rows(2, (3, nkv, hd))
    blk, off = np.array([2, 5, 2]), np.array([0, 3, 1])
    pages = {n: torch.zeros((P, bs, nkv, hd), dtype=torch.float8_e4m3fn)
             for n in ("k", "v")}
    nn._scatter_kv_rows(pages, torch.from_numpy(blk), torch.from_numpy(off),
                        torch.from_numpy(kr), torch.from_numpy(vr))
    jpages = {n: jnp.zeros((P, bs, nkv, hd), jnp.float8_e4m3fn)
              for n in ("k", "v")}
    jpages = jnn._scatter_kv_rows(jpages, jnp.asarray(blk),
                                  jnp.asarray(off), jnp.asarray(kr),
                                  jnp.asarray(vr))
    for n in ("k", "v"):
        np.testing.assert_array_equal(pages[n].view(torch.uint8).numpy(),
                                      np.asarray(jpages[n]).view(np.uint8))


def test_fp8_decode_matches_jax_in_f32():
    """Eight decode steps of both packages in f32 compute over fp8 caches,
    with the same weights: logits within 2e-5, and every cache byte equal
    or one e4m3 step apart (a row whose f32 value the two packages round
    to different sides of a tie)."""
    from _torch_weights import both_params
    jax, jget_config, japi = _jax()
    import jax.numpy as jnp
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype=FP8)
    cfg = _f32(get_config("qwen3-0.6b", smoke=True))
    jparams, params = both_params(jcfg, cfg, 0)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    jstate = japi.init_decode_state(jcfg, 2, 16)
    for i in range(8):
        logits, state = api.decode_step(cfg, params, state,
                                        torch.from_numpy(toks[:, i:i + 1]))
        jlogits, jstate = japi.decode_step(jcfg, jparams, jstate,
                                           jnp.asarray(toks[:, i:i + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=F32_TOL, atol=F32_TOL)
    for n in ("k", "v"):
        got = state["kv"][n].float().numpy()
        exp = np.asarray(jstate["kv"][n]).astype(np.float32)
        # one e4m3 step: 2^-3 relative (3 mantissa bits), 2^-9 absolute
        np.testing.assert_allclose(got, exp, rtol=2.0 ** -3, atol=2.0 ** -9)
        assert (state["kv"][n].view(torch.uint8).numpy()
                == np.asarray(jstate["kv"][n]).view(np.uint8)).mean() > 0.99


# ---------------------------------------------------------------------------
# bytes and admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_fp8_state_and_block_bytes_equal_jax(arch, smoke):
    """``decode_state_bytes`` and ``kv_block_bytes`` of the fp8 cache equal
    JAX's for every config (the families whose state has K/V planes; the
    hybrid's shared-attention slots too), and the K/V term is half of
    bf16's."""
    _, jget_config, japi = _jax()
    cfg16 = get_config(arch, smoke=smoke)
    cfg = cfg16.replace(kv_cache_dtype=FP8)
    jcfg = jget_config(arch, smoke=smoke).replace(kv_cache_dtype=FP8)
    for b, s in ((1, 16), (8, 1024)):
        assert api.decode_state_bytes(cfg, b, s) == \
            japi.decode_state_bytes(jcfg, b, s)
    if api.family_spec(cfg).paging:
        for bs in (8, 16):
            got = api.kv_block_bytes(cfg, bs)
            assert got == japi.kv_block_bytes(jcfg, bs)
            assert 2 * got == api.kv_block_bytes(cfg16, bs)


def _prompts(vocab, n=6):
    """Two share a 16-token prefix (two whole blocks of 8), the rest are
    their own: prefix sharing aliases blocks."""
    rng = np.random.default_rng(900)
    shared = rng.integers(0, vocab, 16)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, 3 + i)
        head = shared if i < 2 else rng.integers(0, vocab, 16)
        out.append(np.concatenate([head, tail]).astype(np.int32))
    return out


def _admission_run(is_jax, cfg, params, budget, prompts):
    if is_jax:
        from repro.serving.engine import InferenceEngine
        kw = {}
    else:
        from repro_torch.serving.engine import InferenceEngine
        kw = {"device": "cpu"}
    eng = InferenceEngine(cfg, params, capacity=6, max_seq=MAX_SEQ,
                          backend="paged", block_size=8,
                          kv_budget_bytes=budget, prefix_share=True,
                          tiered_kv=True, **kw)
    reqs = [eng.submit(p, 6) for p in prompts]
    trace = []
    while eng.step():
        trace.append((len(eng.active_requests()), eng.pool.n_free,
                      eng.budget.reserved_bytes,
                      sorted(eng.pool.refcounts().values())))
    s = eng.summary()
    return (trace, max(t[0] for t in trace),
            [list(map(int, r.generated)) for r in reqs],
            {k: s[k] for k in ("block_bytes", "kv_page_peak_bytes",
                               "kv_budget_bytes", "n_completed")
             if k in s})


def test_fp8_paged_engine_admits_as_jax_under_one_budget():
    """One KV budget (4 bf16 blocks of 8 rows), six requests of two blocks
    each, two sharing a whole-block prefix, the host tier on: the fp8
    pool's admissions, pool and budget bytes tick by tick, summary bytes
    and tokens equal JAX's (f32 compute), and it runs more lanes at once
    than the bf16 pool under the same budget."""
    from _torch_weights import both_params
    _, jget_config, _ = _jax()
    import jax.numpy as jnp
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype=FP8)
    cfg = _f32(get_config("qwen3-0.6b", smoke=True))
    jparams, params = both_params(jcfg, cfg, 0)
    budget = 4 * api.kv_block_bytes(cfg.replace(kv_cache_dtype="bfloat16"),
                                    8)
    prompts = _prompts(cfg.vocab_size)
    port = _admission_run(False, cfg, params, budget, prompts)
    jax_ = _admission_run(True, jcfg, jparams, budget, prompts)
    assert port[0] == jax_[0]
    assert port[2] == jax_[2]
    assert port[3] == jax_[3]
    bf16 = _admission_run(False, cfg.replace(kv_cache_dtype="bfloat16"),
                          params, budget, prompts)
    assert port[1] > bf16[1], (port[1], bf16[1])


# ---------------------------------------------------------------------------
# the e4m3 kernel routes on a card
# ---------------------------------------------------------------------------

SERVE_LENGTHS = (890, 273, 564, 332, 368, 112, 145, 88)


def _paged_inputs(seed, lengths, nh, nkv, hd, bs, q_dtype, kq=None,
                  width=None):
    """fp8 pages holding each lane's rows in shuffled blocks, a garbage
    block 0, tables padded with it to ``width`` blocks, q in ``q_dtype``."""
    g = torch.Generator().manual_seed(seed)
    nb = [-(-(n + (kq or 0)) // bs) for n in lengths]
    width = width or max(nb)
    P = sum(nb) + 1
    perm = torch.randperm(P - 1, generator=g) + 1
    tables = torch.zeros((len(lengths), width), dtype=torch.int32)
    at = 0
    for i, k in enumerate(nb):
        tables[i, :k] = perm[at:at + k]
        at += k
    pages = [torch.randn((P, bs, nkv, hd), generator=g).to(torch.float8_e4m3fn)
             for _ in range(2)]
    shape = (len(lengths), nh, hd) if kq is None \
        else (len(lengths), kq, nh, hd)
    q = torch.randn(shape, generator=g).to(getattr(torch, q_dtype))
    le = torch.tensor(lengths, dtype=torch.int32)
    return [t.cuda() for t in (q, *pages, tables, le)]


def _close(got, exp, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               exp.float().cpu().numpy(), rtol=tol, atol=tol)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("window", [None, 512])
def test_cuda_e4m3_decode_route_matches_plain(q_dtype, window):
    _need_card()
    q, kp, vp, tb, le = _paged_inputs(5, SERVE_LENGTHS, 16, 8, 128, 16,
                                      q_dtype, width=58)
    before = paged_attention_lanes.launches
    out = ops.paged_attention(q, kp, vp, tb, le, window=window, impl="cuda")
    again = ops.paged_attention(q, kp, vp, tb, le, window=window,
                                impl="cuda")
    exp = ref.paged_attention_ref(q, kp, vp, tb, le, window=window)
    torch.cuda.synchronize()
    assert paged_attention_lanes.launches - before == 2
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    assert torch.equal(out, again)
    _close(out, exp, F32_TOL if q_dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_e4m3_fused_route_matches_plain(dtype):
    _need_card()
    d, f, nh, hd = 1024, 3072, 16, 128
    q, kp, vp, tb, le = _paged_inputs(6, SERVE_LENGTHS, nh, 8, hd, 16,
                                      dtype, width=58)
    g = torch.Generator().manual_seed(7)
    dt = getattr(torch, dtype)

    def w(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dt).cuda()

    h = w(len(SERVE_LENGTHS), d, scale=1.0)
    weights = (w(nh * hd, d, scale=(nh * hd) ** -0.5), 1 + w(d, scale=0.1),
               w(d, f, scale=d ** -0.5), w(d, f, scale=d ** -0.5),
               w(f, d, scale=f ** -0.5))
    before = fused_decode_layer.launches
    out = fused_decode_layer(h, q, kp, vp, tb, le, *weights)
    again = fused_decode_layer(h, q, kp, vp, tb, le, *weights)
    exp = ref.fused_decode_layer_ref(h, q, kp, vp, tb, le, *weights)
    torch.cuda.synchronize()
    assert fused_decode_layer.launches - before == 2
    assert torch.equal(out, again)
    _close(out, exp, 2e-4 if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kq", [1, 4, 8])
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_cuda_e4m3_verify_route_matches_plain(kq, q_dtype):
    _need_card()
    q, kp, vp, tb, le = _paged_inputs(8, SERVE_LENGTHS, 16, 8, 128, 16,
                                      q_dtype, kq=kq)
    before = paged_verify_lanes.launches
    out = paged_verify_lanes(q, kp, vp, tb, le)
    again = paged_verify_lanes(q, kp, vp, tb, le)
    exp = ref.paged_verify_ref(q, kp, vp, tb, le)
    torch.cuda.synchronize()
    assert paged_verify_lanes.launches - before == 2
    assert torch.equal(out, again)
    _close(out, exp, F32_TOL if q_dtype == "float32" else BF16_TOL)
