"""The port's encoder-decoder family (``repro_torch.models.encdec``,
whisper-medium smoke) against the JAX package's ``repro.models.encdec``.

The same weights (``_torch_weights.both_params``) and numpy-seeded frame
embeddings and tokens go through both packages.  ``encode``, ``forward``,
``precompute_cross_kv`` and ``decode_step`` compare in float32 at the
reference's matmul-chain bound (2e-4) and in bfloat16 at 2e-2.  The
cross-attention K/V cache is bf16 in both packages whatever the config
dtype, so ``decode_step`` is compared from one cross cache (JAX's) fed to
both; JAX's own ``test_decode_matches_forward`` bound (2e-2 between the
token-by-token decode and the forward) holds on both packages.  The
cross-attention layer (rope on and off, with and without a cache), the
decoder's kernel route (the port's ``attn_impl="cuda"``, whose plain
version runs on CPU tensors, against JAX's ``pallas_interpret``), the
``FamilySpec`` and the engine's refusal are JAX's.  The flash kernel at
whisper-medium's decoder shape is a ``cuda`` case of
``tests/test_torch_flash_attention.py`` (a file the card can import).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_weights import both_params

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as jnn
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import api, encdec, registry
from repro_torch.models import layers as nn
from repro_torch.serving.engine import InferenceEngine

ARCH = "whisper-medium"
MM_TOL = 2e-4
BF16_TOL = 2e-2
TOL = {"float32": MM_TOL, "bfloat16": BF16_TOL}
B, S = 2, 8


def _setup(dtype, **kw):
    jcfg = jget_config(ARCH, smoke=True).replace(
        dtype=jnp.dtype(dtype), remat=False, **kw)
    cfg = get_config(ARCH, smoke=True).replace(dtype=dtype, remat=False)
    jparams, params = both_params(jcfg, cfg, 0)
    return jcfg, jparams, cfg, params


def _batch(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return {"enc_embeds": rng.standard_normal(
                (B, cfg.encoder_len, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_forward_match_jax(dtype):
    jcfg, jparams, cfg, params = _setup(dtype)
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    with torch.no_grad():
        enc = encdec.encode(cfg, params, _t(batch)["enc_embeds"])
        logits = api.forward(cfg, params, _t(batch))
        last = api.forward(cfg, params, _t(batch), last_only=True)
    assert enc.dtype == getattr(torch, dtype)
    _close(_np(enc), jencdec.encode(jcfg, jparams, jb["enc_embeds"]),
           TOL[dtype])
    jlogits = japi.forward(jcfg, jparams, jb)
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(_np(logits), jlogits, TOL[dtype])
    _close(_np(last), jlogits[:, -1:], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precompute_cross_kv_matches_jax(dtype):
    """Stacked (D, b, F, nkv, hd) bf16 K/V of every decoder layer: bf16
    in both packages, so the bf16 bound."""
    jcfg, jparams, cfg, params = _setup(dtype)
    emb = _batch(cfg)["enc_embeds"]
    with torch.no_grad():
        enc = encdec.encode(cfg, params, torch.from_numpy(emb))
        cross = encdec.precompute_cross_kv(cfg, params, enc)
    jcross = jencdec.precompute_cross_kv(
        jcfg, jparams, jencdec.encode(jcfg, jparams, jnp.asarray(emb)))
    for k in ("k", "v"):
        assert cross[k].dtype == torch.bfloat16
        assert tuple(cross[k].shape) == tuple(jcross[k].shape) == (
            cfg.n_layers, B, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
        _close(_np(cross[k]), jcross[k], BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    """S decode steps from JAX's cross cache in both packages: logits at
    the dtype's bound, the self-attention cache index advanced and its
    rows written (the cache is ``kv_cache_dtype`` bf16 in both: the bf16
    bound)."""
    jcfg, jparams, cfg, params = _setup(dtype)
    batch = _batch(cfg)
    jcross = jencdec.precompute_cross_kv(
        jcfg, jparams, jencdec.encode(jcfg, jparams,
                                      jnp.asarray(batch["enc_embeds"])))
    jstate = japi.init_decode_state(jcfg, B, S + 4)
    jstate["cross"] = jcross
    state = api.init_decode_state(cfg, B, S + 4, device="cpu")
    state["cross"] = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) for k, v in jcross.items()}
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(S):
            tok = batch["tokens"][:, i:i + 1]
            lg, state = api.decode_step(cfg, params, state,
                                        torch.from_numpy(tok).long())
            jlg, jstate = japi.decode_step(jcfg, jparams, jstate,
                                           jnp.asarray(tok))
            outs.append(_np(lg[:, 0]))
            jouts.append(np.asarray(jlg[:, 0], np.float32))
    _close(np.stack(outs, 1), np.stack(jouts, 1), TOL[dtype])
    assert state["kv"]["index"] == S == int(jstate["kv"]["index"])
    _close(_np(state["kv"]["k"][:, :, :S]),
           np.asarray(jstate["kv"]["k"][:, :, :S], np.float32), BF16_TOL)


def _decode_vs_forward_port(cfg, params, batch):
    with torch.no_grad():
        full = api.forward(cfg, params, batch)
        enc = encdec.encode(cfg, params, batch["enc_embeds"])
        state = api.init_decode_state(cfg, B, S + 4, device="cpu")
        state["cross"] = encdec.precompute_cross_kv(cfg, params, enc)
        outs = []
        for i in range(S):
            lg, state = api.decode_step(cfg, params, state,
                                        batch["tokens"][:, i:i + 1])
            outs.append(lg[:, 0])
    return float((torch.stack(outs, 1) - full).abs().max())


def test_decode_matches_forward_on_both_packages():
    """JAX ``tests/test_models_smoke.py::test_decode_matches_forward`` for
    whisper (the default bf16 config, remat off), on each package: the
    token-by-token decode over the precomputed cross cache reproduces
    the forward's logits within 2e-2."""
    jcfg, jparams, cfg, params = _setup("bfloat16")
    batch = _batch(cfg, seed=3)
    jb = jax.tree.map(jnp.asarray, batch)
    full = japi.forward(jcfg, jparams, jb)
    state = japi.init_decode_state(jcfg, B, S + 4)
    state["cross"] = jencdec.precompute_cross_kv(
        jcfg, jparams, jencdec.encode(jcfg, jparams, jb["enc_embeds"]))
    outs = []
    for i in range(S):
        lg, state = japi.decode_step(jcfg, jparams, state,
                                     jb["tokens"][:, i:i + 1])
        outs.append(lg[:, 0])
    jdiff = float(jnp.max(jnp.abs(jnp.stack(outs, axis=1) - full)))
    diff = _decode_vs_forward_port(cfg, params, _t(batch))
    assert jdiff < 2e-2 and diff < 2e-2, (jdiff, diff)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_jax(rope, cached):
    """``attention(xkv=...)``: k and v from the encoder stream, q alone
    rotated with ``rope``; with a cache, the cache's K/V are attended
    non-causally and the cache comes back unchanged (f32)."""
    jcfg, jparams, cfg, params = _setup("float32")
    lp = {k: v[0] for k, v in params["decoder"]["cross_attn"].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams["decoder"]["cross_attn"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.array([[4, 5, 6]]), (B, 3)).astype(np.int32)
    kw = dict(causal=False, rope=rope)
    if cached:
        kv = {n: rng.standard_normal(
            (B, 11, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for n in ("k", "v")}
        cache = {**{n: torch.from_numpy(a) for n, a in kv.items()},
                 "index": 4}
        out, back = nn.attention(lp, torch.from_numpy(x), cfg, cache,
                                 positions=torch.from_numpy(pos).long(),
                                 xkv=torch.from_numpy(x), **kw)
        jout, _ = jnn.attention(jlp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), xkv=jnp.asarray(x),
                                kv_cache={**{n: jnp.asarray(a)
                                             for n, a in kv.items()},
                                          "index": 4}, **kw)
        assert back is cache
    else:
        out, back = nn.attention(lp, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos).long(),
                                 xkv=torch.from_numpy(enc), **kw)
        jout, _ = jnn.attention(jlp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos),
                                xkv=jnp.asarray(enc), **kw)
        assert back is None
    _close(_np(out), jout, MM_TOL)


def test_self_attention_without_rope_matches_jax():
    """``rope=False`` on self-attention (the encoder's and the decoder's
    self-attention) rotates neither q nor k."""
    jcfg, jparams, cfg, params = _setup("float32")
    lp = {k: v[0] for k, v in params["encoder"]["attn"].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams["encoder"]["attn"])
    x = np.random.default_rng(6).standard_normal(
        (B, 9, cfg.d_model)).astype(np.float32)
    for causal in (False, True):
        out, _ = nn.attention(lp, torch.from_numpy(x), cfg, causal=causal,
                              rope=False)
        jout, _ = jnn.attention(jlp, jnp.asarray(x), jcfg, causal=causal,
                                rope=False)
        _close(_np(out), jout, MM_TOL)


def test_decoder_kernel_route_matches_pallas_interpret(monkeypatch):
    """With the kernel ``attn_impl`` only the decoder's causal
    self-attention takes the flash route (the encoder and the
    cross-attention are non-causal, in JAX too): one call a decoder layer,
    logits equal to JAX's Pallas kernel in interpret mode (f32)."""
    jcfg, jparams, cfg, params = _setup("float32",
                                        attn_impl="pallas_interpret")
    cfg = cfg.replace(attn_impl="cuda")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = _batch(cfg, s=16)
    with torch.no_grad():
        out = api.forward(cfg, params, _t(batch))
    assert len(calls) == cfg.n_layers
    _close(_np(out), japi.forward(jcfg, jparams,
                                  jax.tree.map(jnp.asarray, batch)), MM_TOL)


def test_family_spec_matches_jax():
    """The audio ``FamilySpec``: flags, notes, capabilities, reasons, the
    decode state's bytes (self K/V, index, bf16 cross K/V) from its
    shapes, no allocation; ``token_stream_data`` False."""
    spec, jspec = registry.spec("audio"), jregistry.spec("audio")
    assert spec.module is encdec
    assert spec.capabilities() == jspec.capabilities()
    assert spec.notes == jspec.notes
    assert spec.token_stream_data is jspec.token_stream_data is False
    for cap in list(spec.capabilities()) + ["token_stream_data"]:
        assert spec.why_not(cap) == jspec.why_not(cap)
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    for b, s in ((1, 16), (3, 448)):
        assert spec.decode_state_bytes(cfg, b, s) == \
            jspec.decode_state_bytes(jcfg, b, s)
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert spec.decode_state_bytes(full, 8, 448) == \
        jspec.decode_state_bytes(jfull, 8, 448)
    assert "audio" in registry.registered_families()
    assert registry.families_with("servable") == \
        jregistry.families_with("servable")


def test_engine_refuses_whisper():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        InferenceEngine(cfg, params=None, capacity=1, max_seq=16,
                        device="cpu")


def test_init_params_layout_matches_jax():
    """The tree the port initializes has JAX's keys, shapes and dtypes
    leaf for leaf (stacked ``encoder``/``decoder``, 8192-row ``dec_pos``),
    and ``param_count`` equals JAX's."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                           jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_leaves_with_path(specs)}
    ours = {jax.tree_util.keystr(p): (tuple(v.shape),
                                      str(v.dtype).removeprefix("torch."))
            for p, v in jax.tree_util.tree_leaves_with_path(
                params, is_leaf=lambda v: isinstance(v, torch.Tensor))}
    assert ours == flat
    assert params["dec_pos"].shape == (8192, cfg.d_model)
    assert api.param_count(params) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(specs))

