"""The port's VLM family (llava-next-mistral-7b smoke, the paper's
vit-smoke) against the JAX package's.

A VLM batch carries the frontend stub's fused patch+text ``embeds``
instead of tokens: a forward from the same numpy-seeded embeddings
compares at the reference's matmul-chain bound (2e-4) in float32 and at
2e-2 in bfloat16.  VLM decode takes tokens, as the dense family's does
(the family shares ``models.transformer``), so llava serves through every
dense backend: float32 slot, paged, fused paged, speculative (over the
paged inner, a random draft) and int8-paged engines give JAX's engines'
tokens and lanes tick by tick.  ``input_specs`` and ``make_dummy_batch``
have JAX's keys and shapes, and the vlm ``FamilySpec`` is JAX's.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_weights import both_params

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import registry as jregistry
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.models import api, registry, transformer
from repro_torch.serving.engine import InferenceEngine

LLAVA, VIT = "llava-next-mistral-7b", "vit-300m"
MM_TOL = 2e-4
BF16_TOL = 2e-2
TOL = {"float32": MM_TOL, "bfloat16": BF16_TOL}
GEN = 5
SCHEDULE = {0: ("a", "b"), 1: ("c",), 3: ("d", "e")}   # tick -> arrivals
LENS = {"a": 9, "b": 4, "c": 9, "d": 6, "e": 3}


def _embeds(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
                np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [LLAVA, VIT])
def test_forward_from_embeds_matches_jax(arch, dtype):
    """The embeds, cast to the compute dtype, are the first hidden state
    (no token embedding): logits and the last-position logits equal
    JAX's; ViT* is non-causal and layer-norm/GELU, as bert-large-1b."""
    jcfg = jget_config(arch, smoke=True).replace(dtype=jnp.dtype(dtype))
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jparams, params = both_params(jcfg, cfg, 0)
    batch = _embeds(cfg)
    jb = {"embeds": jnp.asarray(batch["embeds"])}
    with torch.no_grad():
        tb = {"embeds": torch.from_numpy(batch["embeds"])}
        out = api.forward(cfg, params, tb)
        last = api.forward(cfg, params, tb, last_only=True)
        x = transformer.embed_inputs(cfg, params, tb)
    assert x.dtype == getattr(torch, dtype)
    jout = japi.forward(jcfg, jparams, jb)
    _close(out.numpy(), jout, TOL[dtype])
    _close(last.numpy(), jout[:, -1:], TOL[dtype])


def test_tokens_still_embed_for_vlm():
    """A vlm batch without ``embeds`` embeds its tokens, as JAX's
    ``embed_inputs`` does."""
    jcfg = jget_config(LLAVA, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(LLAVA, smoke=True).replace(dtype="float32")
    jparams, params = both_params(jcfg, cfg, 1)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    with torch.no_grad():
        out = api.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(out.numpy(), japi.forward(jcfg, jparams, {
        "tokens": jnp.asarray(toks, jnp.int32)}), MM_TOL)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return {k: rng.integers(0, vocab, n, dtype=np.int32)
            for k, n in LENS.items()}


def _drive(engine, vocab):
    prompts = _prompts(vocab)
    lanes, tick = [], 0
    while engine.has_work() or tick <= max(SCHEDULE):
        for rid in SCHEDULE.get(tick, ()):
            engine.submit(prompts[rid], GEN, request_id=rid)
        engine.step()
        lanes.append({lane: r.request_id
                      for lane, r in engine._active.items()})
        tick += 1
    engine.run()
    return lanes, {r.request_id: list(map(int, r.generated))
                   for r in engine.completed}


ENGINES = {
    "slot": (dict(backend="slot"), {}),
    "paged": (dict(backend="paged", block_size=8), {}),
    "fused": (dict(backend="paged", block_size=8),
              dict(jax=dict(paged_impl="fused_interpret"),
                   port=dict(paged_impl="fused"))),
    "spec": (dict(backend="spec", spec_inner="paged", draft_k=3,
                  block_size=8), {}),
    "int8": (dict(backend="paged", kv_dtype="int8", block_size=8), {}),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_match_jax(name):
    """llava smoke in f32 through each backend dense serves through:
    tokens and lanes tick by tick equal JAX's engine (the spec engine with
    a random draft from another seed: a rollback every round); the
    backend is the one asked for, not a fallback."""
    common, impls = ENGINES[name]
    jcfg = jget_config(LLAVA, smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config(LLAVA, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams, params = both_params(jcfg, cfg, 2)
    jkw = dict(capacity=3, max_seq=40, **common, **impls.get("jax", {}))
    tkw = dict(capacity=3, max_seq=40, **common, **impls.get("port", {}))
    if name == "spec":
        jd, td = both_params(jcfg, cfg, 7)
        jkw.update(draft_cfg=jcfg, draft_params=jd)
        tkw.update(draft_cfg=cfg, draft_params=td)
    jeng = JEngine(jcfg, jparams, **jkw)
    eng = InferenceEngine(cfg, params, device="cpu", **tkw)
    assert eng.backend.name == common["backend"] == jeng.backend.name
    jlanes, jout = _drive(jeng, cfg.vocab_size)
    lanes, out = _drive(eng, cfg.vocab_size)
    assert sorted(out) == sorted(LENS)
    assert all(len(t) == GEN for t in out.values())
    assert out == jout
    assert lanes == jlanes
    s, js = eng.summary(), jeng.summary()
    for key in ("decode_steps", "prefill_calls", "peak_concurrency",
                "kv_peak_bytes"):
        assert s[key] == js[key], key
    if name == "fused":
        assert s["paged_impl"] == "fused"


def test_family_spec_matches_jax():
    spec, jspec = registry.spec("vlm"), jregistry.spec("vlm")
    assert spec.module is transformer
    assert spec.capabilities() == jspec.capabilities()
    assert spec.capabilities() == registry.spec("dense").capabilities()
    assert spec.notes == jspec.notes
    assert spec.token_stream_data is jspec.token_stream_data is False
    assert registry.spec("dense").token_stream_data is True
    assert spec.why_not("token_stream_data") == \
        jspec.why_not("token_stream_data")
    for arch in (LLAVA, VIT):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert spec.decode_state_bytes(cfg, 4, 256) == \
            jspec.decode_state_bytes(jcfg, 4, 256)
        for kv in (None, "int8"):
            assert spec.kv_block_bytes(cfg, 16, kv) == \
                jspec.kv_block_bytes(jcfg, 16, kv)


@pytest.mark.parametrize("arch", [LLAVA, VIT])
def test_input_specs_and_dummy_batch_match_jax(arch):
    from repro.models.api import input_specs as jinput_specs
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in ("train_4k", "prefill_32k"):
        specs = api.input_specs(cfg, INPUT_SHAPES[name])
        jspecs = jinput_specs(jcfg, JINPUT_SHAPES[name])
        assert list(specs) == list(jspecs) == ["embeds", "labels"]
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}
        assert specs["embeds"].dtype == torch.bfloat16
        assert specs["labels"].dtype == torch.int64
    scfg = get_config(arch, smoke=True)
    batch = api.make_dummy_batch(scfg, 2, 16,
                                 torch.Generator().manual_seed(0), "cpu")
    jbatch = japi.make_dummy_batch(jget_config(arch, smoke=True), 2, 16)
    assert list(batch) == list(jbatch)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jbatch.items()}
    assert jax.tree.map(lambda a: str(a.dtype), jbatch)["embeds"] == \
        "bfloat16" and batch["embeds"].dtype == torch.bfloat16
    with torch.no_grad():
        out = api.forward(scfg, api.init_params(
            scfg, torch.Generator().manual_seed(0), "cpu"), batch)
    assert out.shape == (2, 16, scfg.vocab_size)
    assert bool(torch.isfinite(out).all())
