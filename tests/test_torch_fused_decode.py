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
* On CPU tensors each kernel wrapper runs its plain version and launches
  nothing; the CUDA kernels are held against their plain versions on a
  card (``-m cuda``; the JAX side is imported by fixtures, so those cases
  run where JAX is missing).
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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
