"""The port's fused paged decode layer, RMSNorm and SwiGLU against the JAX
package's.

* The plain versions (``repro_torch.kernels.ref``) give the JAX oracles'
  and the Pallas kernels' (interpret mode) numbers on the same
  numpy-seeded inputs: the fused layer over the reference's fuzz space
  (``tests/test_kernel_oracles.py``: n 1-3, kv heads and groups 1-2, hd
  16/32, block 4/8, window None/6, d 64/96) at 2e-4, RMSNorm at 2e-5 and
  SwiGLU at 2e-4 — the reference's own tolerances (f32; the fused layer
  and SwiGLU end in matmul chains).
* ``paged_decode_step(impl="fused")`` of ``qwen3-0.6b`` smoke in f32
  gives JAX ``impl="fused_interpret"``'s logits (2e-4) and tokens over six
  steps; configs without RMSNorm + SwiGLU quietly take the unfused path.
* f32 engines with ``paged_impl="fused"`` — plain paged, spec over the
  paged inner, an int8 pool (where the fused gate falls back) — give the
  JAX engine's token streams and lane assignments tick by tick.
* A plain model of the CUDA kernel chain's numerics
  (``fused_kernel_model``: split-KV attention over 128-row splits with
  f32 partials merged in split order, each product over the kernel's
  depth slices with every activation split into bf16 hi + lo against
  bf16-exact weights, the slices' sums added in order, silu(g) * u formed
  from the summed slices) gives the JAX oracle's and the Pallas kernel's
  numbers over the fuzz sample at 2e-4.  The split is the kernel's
  rounding choice: at d 1024 with 16/8 heads of 128 the model is within
  1e-4 of the f32 plain version, where activations rounded once to bf16
  are not within the f32 tolerance 2e-4.
* On CPU tensors each kernel wrapper runs its plain version and launches
  nothing; the CUDA kernels are held against their plain versions on a
  card (``-m cuda``: the fuzz sample, 8 and 33 lanes at full width, 32
  lanes up to 4096 rows with and without a window of 512 and an inactive
  lane on the garbage block, f32 at 8 lanes (the 8-row tile), two calls
  giving the same bits; the JAX side is imported by fixtures, so those
  cases run where JAX is missing); RMSNorm and SwiGLU at rows 1 to 2048
  of d 1024 (f 3072) across SwiGLU's route boundaries, one
  launch counted per op call, RMSNorm at widths off the 16-byte vectors
  (d 13, 100), over several warps (4096) and past the registers (20000)
  with each x / w dtype pair and an unaligned x, and both kernels
  repeating bit for bit.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_paged_attention import _long_inputs, _split_merge

from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_decode import fused_decode_layer
from repro_torch.kernels.rmsnorm import rms_norm_2d
from repro_torch.kernels.swiglu import swiglu_2d

F32_TOL = 2e-5
BF16_TOL = 2e-2
MM_TOL = 2e-4

# n, nkv, groups, hd, bs, B, window, d — a fixed sample of the reference's
# fuzz space, every axis at both of its ends
FUZZ = [
    (1, 1, 1, 16, 4, 1, None, 64),
    (2, 2, 1, 32, 8, 3, 6, 96),
    (3, 1, 2, 32, 4, 2, None, 96),
    (3, 2, 2, 16, 8, 2, 6, 64),
    (2, 2, 2, 32, 4, 3, None, 64),
    (1, 1, 2, 16, 8, 1, 6, 96),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.rmsnorm import rms_norm_2d as jrms
    from repro.kernels.swiglu import swiglu_2d as jswiglu
    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref, rms=jrms,
                           swiglu=jswiglu)


def fused_inputs(seed, n, nkv, groups, hd, bs, B, d):
    """numpy inputs of the fused layer: distinct physical blocks per lane
    (never the garbage block 0), ragged lengths incl. the current token."""
    rng = np.random.default_rng(seed)
    nh, f = nkv * groups, 2 * d
    P = n * B + 1 + int(rng.integers(0, 3))
    std = rng.standard_normal
    return dict(
        h=std((n, d), np.float32),
        q=std((n, nh, hd), np.float32),
        k_pages=std((P, bs, nkv, hd), np.float32),
        v_pages=std((P, bs, nkv, hd), np.float32),
        tables=(rng.permutation(P - 1)[: n * B] + 1).reshape(n, B)
        .astype(np.int32),
        lengths=rng.integers(1, B * bs + 1, n).astype(np.int32),
        wo=(std((nh * hd, d)) * 0.05).astype(np.float32),
        mlp_scale=(std(d) * 0.1 + 1.0).astype(np.float32),
        w_gate=(std((d, f)) * 0.05).astype(np.float32),
        w_up=(std((d, f)) * 0.05).astype(np.float32),
        w_down=(std((f, d)) * 0.05).astype(np.float32))


def _torch(arrays, dtype=torch.float32, device="cpu"):
    """numpy inputs as tensors: int32 tables/lengths stay int32, the rest
    in ``dtype``."""
    return {k: torch.from_numpy(v).to(
        device=device, dtype=torch.int32 if v.dtype == np.int32 else dtype)
        for k, v in arrays.items()}


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("n,nkv,groups,hd,bs,B,window,d", FUZZ)
def test_fused_ref_matches_jax_oracle_and_pallas(jx, n, nkv, groups, hd, bs,
                                                 B, window, d):
    a = fused_inputs(n * 1000 + B * 10 + d, n, nkv, groups, hd, bs, B, d)
    out = ref.fused_decode_layer_ref(**_torch(a), window=window)
    ja = {k: jx.jnp.asarray(v) for k, v in a.items()}
    for impl in ("jnp", "pallas_interpret"):
        exp = jx.ops.fused_decode_layer(**ja, window=window, impl=impl)
        _close(_np(out), exp, MM_TOL)


# csrc/paged_decode.cuh kSplit; csrc/stream_gemm.cuh kTileN, kSliceK,
# kTargetBlocks, kMaxRows
SPLIT_ROWS, TILE_N, SLICE_K, TARGET_BLOCKS, MAX_ROWS = 128, 64, 64, 264, 32


def _slice_width(K, N, n_mats, n):
    """sg::plan: the depth of each slice of a product."""
    others = -(-N // TILE_N) * n_mats * -(-n // MAX_ROWS)
    granules = -(-K // SLICE_K)
    splits = min(max(-(-TARGET_BLOCKS // others), 1), granules)
    return -(-granules // splits) * SLICE_K


def _product_slices(x, w, n_mats, split):
    """One product of the chain: per depth slice the f32 sum of x's bf16
    hi and lo parts (``split``; else x rounded once to bf16) times w."""
    hi = x.to(torch.bfloat16).float()
    parts = (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)
    K = x.shape[1]
    kps = _slice_width(K, w.shape[1], n_mats, x.shape[0])
    return [sum(xp[:, k:k + kps] @ w[k:k + kps] for xp in parts)
            for k in range(0, K, kps)]


def fused_kernel_model(t, window, *, eps=1e-6, split=True):
    """The CUDA kernel chain's numerics in plain torch, f32 sums: split-KV
    attention (f32 partials, merged in split order), h1 = h + the wo
    slices in order, RMSNorm, g and u each the sum of their slices,
    act = silu(g) * u, out = h1 + the down slices in order."""
    n, nh, hd = t["q"].shape
    attn = _split_merge(t["q"].float(), t["k_pages"].float(),
                        t["v_pages"].float(), t["tables"], t["lengths"],
                        window, SPLIT_ROWS).reshape(n, nh * hd)
    h1 = t["h"].float()
    for part in _product_slices(attn, t["wo"].float(), 1, split):
        h1 = h1 + part
    hn = h1 * torch.rsqrt(h1.square().mean(-1, keepdim=True) + eps) \
        * t["mlp_scale"].float()
    g = sum(_product_slices(hn, t["w_gate"].float(), 2, split))
    u = sum(_product_slices(hn, t["w_up"].float(), 2, split))
    out = h1
    for part in _product_slices(F.silu(g) * u, t["w_down"].float(), 1,
                                split):
        out = out + part
    return out


def _bf16_weights(a):
    """The fuzz inputs with wo and the MLP matrices rounded to bf16 values
    (the bf16 kernel's weights are exact in its products)."""
    for k in ("wo", "w_gate", "w_up", "w_down"):
        a[k] = torch.from_numpy(a[k]).to(torch.bfloat16).float().numpy()
    return a


@pytest.mark.parametrize("n,nkv,groups,hd,bs,B,window,d", FUZZ)
def test_kernel_model_matches_jax_oracle_and_pallas(jx, n, nkv, groups, hd,
                                                    bs, B, window, d):
    a = _bf16_weights(fused_inputs(n * 1000 + B * 10 + d + 1, n, nkv,
                                   groups, hd, bs, B, d))
    out = fused_kernel_model(_torch(a), window)
    ja = {k: jx.jnp.asarray(v) for k, v in a.items()}
    for impl in ("jnp", "pallas_interpret"):
        exp = jx.ops.fused_decode_layer(**ja, window=window, impl=impl)
        _close(_np(out), exp, MM_TOL)


def test_kernel_model_activation_split_at_full_width():
    """8 lanes, 16/8 heads of 128, d 1024: the model with hi + lo
    activations is within 1e-4 of the f32 plain version; activations
    rounded once to bf16 are not within 2e-4."""
    t = _torch(_bf16_weights(fused_inputs(12, 8, 8, 2, 128, 16, 20, 1024)))
    exp = ref.fused_decode_layer_ref(**t)
    _close(_np(fused_kernel_model(t, None)), _np(exp), 1e-4)
    err = (fused_kernel_model(t, None, split=False) - exp).abs()
    assert not bool((err <= MM_TOL + MM_TOL * exp.abs()).all())


@pytest.mark.parametrize("rows,d", [(1, 128), (7, 96), (64, 128)])
def test_rms_norm_ref_matches_jax_oracle_and_pallas(jx, rows, d):
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d), np.float32)
    w = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    out = _np(ref.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w)))
    _close(out, jx.ref.rms_norm_ref(jx.jnp.asarray(x), jx.jnp.asarray(w)),
           F32_TOL)
    _close(out, jx.rms(jx.jnp.asarray(x), jx.jnp.asarray(w),
                       interpret=True), F32_TOL)


@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (9, 64, 192),
                                   (64, 128, 256)])
def test_swiglu_ref_matches_jax_oracle_and_pallas(jx, m, d, f):
    rng = np.random.default_rng(m + d + f)
    x = rng.standard_normal((m, d), np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    out = _np(ref.swiglu_ref(torch.from_numpy(x),
                             *map(torch.from_numpy, ws)))
    jargs = [jx.jnp.asarray(v) for v in (x, *ws)]
    _close(out, jx.ref.swiglu_ref(*jargs), MM_TOL)
    _close(out, jx.swiglu(*jargs, interpret=True), MM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_run_the_plain_versions(dtype):
    """On CPU tensors each kernel wrapper and its ``ops`` entry point with
    the device default run the plain version, bit for bit, and launch
    nothing."""
    t = _torch(fused_inputs(3, 2, 2, 2, 32, 8, 3, 64), dtype)
    before = (fused_decode_layer.launches, rms_norm_2d.launches,
              swiglu_2d.launches)
    exp = ref.fused_decode_layer_ref(**t, window=6)
    assert torch.equal(fused_decode_layer(**t, window=6), exp)
    assert torch.equal(ops.fused_decode_layer(**t, window=6), exp)
    x = t["h"]
    exp = ref.rms_norm_ref(x, t["mlp_scale"])
    assert torch.equal(rms_norm_2d(x, t["mlp_scale"]), exp)
    assert torch.equal(ops.rms_norm(x[:, None], t["mlp_scale"])[:, 0], exp)
    mats = (t["w_gate"], t["w_up"], t["w_down"])
    exp = ref.swiglu_ref(x, *mats)
    assert torch.equal(swiglu_2d(x, *mats), exp)
    assert torch.equal(ops.swiglu(x[None], *mats)[0], exp)
    assert (fused_decode_layer.launches, rms_norm_2d.launches,
            swiglu_2d.launches) == before


def test_layer_use_kernel_flags_match_the_plain_layers():
    """``layers.rms_norm`` / ``layers.swiglu`` with ``use_kernel=True`` (on
    the CPU: the kernels' plain versions) give the plain layers' numbers."""
    from repro_torch.models import layers as nn
    t = _torch(fused_inputs(5, 3, 2, 2, 16, 4, 2, 64))
    x = t["h"][None]
    p_norm = {"scale": t["mlp_scale"]}
    p_mlp = {k: t[k] for k in ("w_gate", "w_up", "w_down")}
    torch.testing.assert_close(nn.rms_norm(p_norm, x, use_kernel=True),
                               nn.rms_norm(p_norm, x), rtol=F32_TOL,
                               atol=F32_TOL)
    torch.testing.assert_close(nn.swiglu(p_mlp, x, use_kernel=True),
                               nn.swiglu(p_mlp, x), rtol=MM_TOL, atol=MM_TOL)


# ---------------------------------------------------------------------------
# the decode step and the engines, against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(seed=0):
    """qwen3-0.6b smoke in f32: (jax cfg, jax params, port cfg, port
    params), the port's carried across from the JAX init through numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro_torch.checkpoint.convert import params_from_numpy
    from repro_torch.configs import get_config
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_fused_decode_step_matches_jax_fused_interpret(jx):
    """Six decode steps of two lanes through the fused layer: the port's
    ``impl="fused"`` (plain versions on the CPU) against JAX
    ``impl="fused_interpret"`` (the Pallas kernel interpreted), logits at
    2e-4 and greedy tokens equal (after ``test_kernel_oracles.py``'s
    ``test_fused_impl_matches_jnp_paged_decode``, in f32)."""
    from repro.models import api as japi
    from repro_torch.models import api
    jnp = jx.jnp
    jcfg, jparams, cfg, params = _model()
    n, bs, B = 2, 4, 5
    P = n * B + 1
    rng = np.random.default_rng(3)
    tables = (rng.permutation(P - 1)[: n * B] + 1).reshape(n, B) \
        .astype(np.int32)
    jpages = japi.init_kv_pages(jcfg, P, bs)
    pages = api.init_kv_pages(cfg, P, bs, "cpu")
    tok = rng.integers(0, cfg.vocab_size, (n, 1)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok).long()
    for step in range(6):
        lengths = np.full((n,), step, np.int32)
        jl, jpages = japi.paged_decode_step(
            jcfg, jparams, jpages, jnp.asarray(tables), jnp.asarray(lengths),
            jtok, impl="fused_interpret")
        tl = api.paged_decode_step(
            cfg, params, pages, torch.from_numpy(tables),
            torch.from_numpy(lengths), ttok, impl="fused")
        _close(_np(tl), jl, MM_TOL)
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tl[:, -1], -1)[:, None]
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())


def test_fused_gate_falls_back_for_other_configs():
    """``impl="fused"`` on a layer-norm / GELU config (no fused kernel
    for it) takes the unfused paged path: the same logits as the default
    impl, bit for bit; and ``"fused_ref"`` equals ``"fused"`` on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    base = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    rng = np.random.default_rng(1)
    tables = torch.from_numpy(
        (rng.permutation(8)[:6] + 1).reshape(2, 3).astype(np.int32))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 1)))
    for cfg, impls in ((base.replace(norm="layer", mlp="gelu"),
                        (None, "fused")), (base, ("fused", "fused_ref"))):
        params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        outs = []
        for impl in impls:
            pages = api.init_kv_pages(cfg, 9, 4, "cpu")
            for plane in pages.values():
                plane.copy_(torch.randn(plane.shape,
                            generator=torch.Generator().manual_seed(2)))
            outs.append(api.paged_decode_step(cfg, params, pages, tables,
                                              lengths, tokens, impl=impl))
        assert torch.equal(outs[0], outs[1])


SCHEDULE = {0: ("a", "b"), 1: ("c", "d"), 3: ("e",)}   # tick -> arrivals


def _prompts(vocab):
    rng = np.random.default_rng(4)
    a = rng.integers(0, vocab, 24, dtype=np.int32)   # 3 full blocks of 8
    return {"a": a, "b": a[:20].copy(),              # shared prefix + CoW
            "c": rng.integers(0, vocab, 13, dtype=np.int32),
            "d": rng.integers(0, vocab, 21, dtype=np.int32),
            "e": rng.integers(0, vocab, 7, dtype=np.int32)}


def _drive(engine, vocab):
    """Submit on the fixed schedule; record lane -> request id per tick."""
    prompts = _prompts(vocab)
    lanes, tick = [], 0
    while engine.has_work() or tick <= max(SCHEDULE):
        for rid in SCHEDULE.get(tick, ()):
            engine.submit(prompts[rid], 6, request_id=rid)
        engine.step()
        lanes.append({lane: r.request_id
                      for lane, r in engine._active.items()})
        tick += 1
    engine.run()
    return lanes, {r.request_id: list(map(int, r.generated))
                   for r in engine.completed}


@pytest.mark.parametrize("kw", [
    {"backend": "paged"},
    {"backend": "spec", "spec_inner": "paged", "draft_k": 3},
    {"backend": "paged", "kv_dtype": "int8"},
], ids=["paged", "spec-paged", "int8"])
def test_fused_engines_match_jax(jx, kw):
    from repro.serving.engine import InferenceEngine as JEngine
    from repro_torch.serving.engine import InferenceEngine
    jcfg, jparams, cfg, params = _model()
    common = dict(capacity=2, max_seq=48, block_size=8, **kw)
    jkw, tkw = dict(common), dict(common)
    if kw["backend"] == "spec":
        _, jdraft, _, draft = _model(7)           # rollback every round
        jkw.update(draft_cfg=jcfg, draft_params=jdraft)
        tkw.update(draft_cfg=cfg, draft_params=draft)
    jeng = JEngine(jcfg, jparams, paged_impl="fused_interpret", **jkw)
    eng = InferenceEngine(cfg, params, paged_impl="fused", device="cpu",
                          **tkw)
    assert eng.paged_impl == "fused"
    if kw["backend"] == "spec":
        assert eng.backend.verify_impl == "fused"
    jlanes, jout = _drive(jeng, cfg.vocab_size)
    lanes, out = _drive(eng, cfg.vocab_size)
    assert out == jout and len(out) == len(SCHEDULE) + 2
    assert lanes == jlanes
    assert eng.summary()["paged_impl"] == "fused"


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,nkv,groups,hd,bs,B,window,d",
                         FUZZ + [(8, 8, 2, 128, 16, 40, None, 1024),
                                 (33, 8, 2, 128, 16, 9, 40, 256)])
def test_cuda_fused_layer_matches_plain_version(n, nkv, groups, hd, bs, B,
                                                window, d, dtype):
    _need_cuda()
    a = fused_inputs(n + B + d, n, nkv, groups, hd, bs, B, d)
    a["tables"][-1] = 0                  # an inactive lane on the garbage
    a["lengths"][-1] = 1                 # block, as the engine leaves it
    t = _torch(a, getattr(torch, dtype), "cuda")
    before = fused_decode_layer.launches
    out = ops.fused_decode_layer(**t, window=window, impl="cuda")
    exp = ref.fused_decode_layer_ref(**t, window=window)
    torch.cuda.synchronize()
    assert fused_decode_layer.launches == before + 1
    _close(_np(out), _np(exp), MM_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,f", [(1, 1024, 3072), (8, 1024, 3072),
                                      (127, 1024, 3072), (512, 512, 1024),
                                      (64, 128, 256)])
def test_cuda_rms_norm_and_swiglu_match_plain_versions(rows, d, f, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dt)
    w = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0).to(dt)
    mats = [(torch.randn(s, device="cuda", generator=g) * 0.05).to(dt)
            for s in ((d, f), (d, f), (f, d))]
    out = ops.rms_norm(x, w, impl="cuda")
    exp = ref.rms_norm_ref(x, w)
    torch.cuda.synchronize()
    _close(_np(out), _np(exp), F32_TOL if dtype == "float32" else BF16_TOL)
    out = ops.swiglu(x, *mats, impl="cuda")
    exp = ref.swiglu_ref(x, *mats)
    torch.cuda.synchronize()
    _close(_np(out), _np(exp), MM_TOL if dtype == "float32" else BF16_TOL)


def _mlp_operands(rows, d, f, dtype, seed, w_dtype=None):
    """x ~ N(0, 1), the norm scale ~ 1 + N(0, 0.01) in ``w_dtype`` (x's
    by default), SwiGLU weights ~ N(0, 1/fan_in), on the card."""
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dt)
    w = (torch.randn(d, device="cuda", generator=g) * 0.1 + 1.0).to(
        getattr(torch, w_dtype or dtype))
    mats = [(torch.randn(s, device="cuda", generator=g) / s[0] ** 0.5)
            .to(dt) for s in ((d, f), (d, f), (f, d))]
    return x, w, mats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 8, 32, 33, 127, 512, 2048])
def test_cuda_rms_norm_and_swiglu_over_the_routes(rows, dtype):
    """qwen3-0.6b's widths (d 1024, f 3072) at rows on both sides of
    SwiGLU's route boundaries (bf16: 32 stream, 33 tiled; f32: 8 and 32
    | 33): each kernel against its plain version, one launch counted per
    op call."""
    from repro_torch.kernels.swiglu import swiglu_route
    _need_cuda()
    x, w, mats = _mlp_operands(rows, 1024, 3072, dtype, rows)
    before = (rms_norm_2d.launches, swiglu_2d.launches)
    out = ops.rms_norm(x, w, impl="cuda")
    torch.cuda.synchronize()
    assert (rms_norm_2d.launches, swiglu_2d.launches) == (before[0] + 1,
                                                          before[1])
    _close(_np(out), _np(ref.rms_norm_ref(x, w)),
           F32_TOL if dtype == "float32" else BF16_TOL)
    out = ops.swiglu(x, *mats, impl="cuda")
    torch.cuda.synchronize()
    assert (rms_norm_2d.launches, swiglu_2d.launches) == (before[0] + 1,
                                                          before[1] + 1)
    last = {"bfloat16": 32, "float32": 8}[dtype]     # the stream route's
    assert swiglu_route(rows, x.dtype) == ("stream" if rows <= last
                                           else "tiled")
    _close(_np(out), _np(ref.swiglu_ref(x, *mats)),
           MM_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("rows,d", [(7, 100), (33, 100), (5, 13),
                                    (64, 4096), (3, 20000)])
def test_cuda_rms_norm_widths_and_mixed_dtypes(rows, d, x_dtype, w_dtype):
    """d 100 and 13 (no multiple of the 16-byte vectors: the element
    path), 4096 (a row over several warps), 20000 (wider than the
    registers: the two-pass kernel), x and w of each dtype pair, and an
    x that starts 2 bytes past a 16-byte boundary."""
    _need_cuda()
    x, w, _ = _mlp_operands(rows, d, 8, x_dtype, d, w_dtype)
    before = rms_norm_2d.launches
    out = ops.rms_norm(x, w, impl="cuda")
    xs = torch.empty(rows * d + 1, device="cuda",
                     dtype=x.dtype)[1:].view(rows, d)
    xs.copy_(x)
    out_shifted = ops.rms_norm(xs, w, impl="cuda")
    torch.cuda.synchronize()
    assert rms_norm_2d.launches == before + 2
    tol = F32_TOL if x_dtype == "float32" else BF16_TOL
    _close(_np(out), _np(ref.rms_norm_ref(x, w)), tol)
    _close(_np(out_shifted), _np(ref.rms_norm_ref(x, w)), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 127, 2048])
def test_cuda_rms_norm_and_swiglu_repeat_bitwise(rows, dtype):
    """Fixed-order sums (RMSNorm's warps, the slices of SwiGLU's split
    products): two calls give the same bits on both routes."""
    _need_cuda()
    x, w, mats = _mlp_operands(rows, 1024, 3072, dtype, 7)
    first = (ops.rms_norm(x, w, impl="cuda"), ops.swiglu(x, *mats,
                                                         impl="cuda"))
    second = (ops.rms_norm(x, w, impl="cuda"), ops.swiglu(x, *mats,
                                                          impl="cuda"))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _long_layer(seed, lengths, dtype, d=1024):
    """The fused layer's operands on the card: lanes of ``lengths`` over
    16/8 heads of 128 in blocks of 16 (``_long_inputs``; a lane of length
    1 reads only the garbage block), h and weights at width d (f 3d)."""
    pages, q, tables, lens = _long_inputs(seed, lengths, 16, 8, 128, 16,
                                          dtype, dtype)
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(dt)
    f = 3 * d
    return dict(h=randn(len(lengths), d), q=q, k_pages=pages[0],
                v_pages=pages[1], tables=tables, lengths=lens,
                wo=randn(16 * 128, d, scale=(16 * 128) ** -0.5),
                mlp_scale=(torch.randn(d, device="cuda", generator=g) * 0.1
                           + 1.0).to(dt),
                w_gate=randn(d, f, scale=d ** -0.5),
                w_up=randn(d, f, scale=d ** -0.5),
                w_down=randn(f, d, scale=f ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,window", [(32, None), (32, 512), (8, None)])
def test_cuda_fused_layer_long_lanes(n, window, dtype):
    """Lanes of 1 (an inactive lane on the garbage block) to 4096 rows over
    many 128-row splits, with and without a window of 512; at 8 lanes the
    f32 products take their 8-row tile."""
    _need_cuda()
    lengths = np.random.default_rng(n).integers(1, 4097, n)
    lengths[0], lengths[-1] = 1, 4096
    t = _long_layer(n, lengths.tolist(), dtype)
    before = fused_decode_layer.launches
    out = ops.fused_decode_layer(**t, window=window, impl="cuda")
    exp = ref.fused_decode_layer_ref(**t, window=window)
    torch.cuda.synchronize()
    assert fused_decode_layer.launches == before + 1
    _close(_np(out), _np(exp), MM_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_layer_repeats_bitwise(dtype):
    """Partial sums in a fixed order: two calls give the same bits."""
    _need_cuda()
    t = _long_layer(7, [890, 273, 564, 332, 368, 112, 145, 88], dtype)
    first = ops.fused_decode_layer(**t, impl="cuda")
    second = ops.fused_decode_layer(**t, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
