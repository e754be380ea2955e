"""The port's recurrent families (``models/ssm.py``: Mamba2, mLSTM, sLSTM,
the xLSTM model; ``models/hybrid.py``: zamba2) against the JAX package's.

Inputs and parameters are made with numpy (or by the JAX initializer)
and cross over as numpy; configs run with ``dtype`` and
``kv_cache_dtype`` float32 on both sides.  Tolerances: 2e-5 for
elementwise work and single products (the conv, the SSD step); 2e-4 for
matmul chains (blocks, whole models, decode over several steps), the
``MM_TOL`` of ``tests/test_kernel_oracles.py`` — f32 products summed in
another order by XLA and by PyTorch.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import api, hybrid, registry, ssm

EW_TOL = 2e-5
MM_TOL = 2e-4
ARCHS = ["xlstm-350m", "zamba2-1.2b"]


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    jcfg = jget_config(arch, smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tree = _np(jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, device="cpu"), tree


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _block_params(init, jcfg, seed=1):
    """One block's JAX params, and the port's (bridged)."""
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(_np(jp), device="cpu")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_causal_conv1d_and_step_match_jax():
    rng = np.random.default_rng(0)
    b, s, c, k = 2, 11, 24, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = rng.standard_normal((k, c)).astype(np.float32) * 0.3
    bias = rng.standard_normal((c,)).astype(np.float32)
    _close(ssm.causal_conv1d(_t(x), _t(w), _t(bias)),
           jssm.causal_conv1d(x, w, bias), EW_TOL)
    st = rng.standard_normal((b, k - 1, c)).astype(np.float32)
    y, new = ssm.causal_conv1d_step(_t(st), _t(x[:, 0]), _t(w), _t(bias))
    jy, jnew = jssm.causal_conv1d_step(st, x[:, 0], w, bias)
    _close(y, jy, EW_TOL)
    _close(new, jnew, 0)


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(1)
    b, h, p, n = 2, 3, 8, 5
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    la = -np.abs(rng.standard_normal((b, h))).astype(np.float32)
    bt = rng.standard_normal((b, h, n)).astype(np.float32)
    ct = rng.standard_normal((b, h, n)).astype(np.float32)
    y, new = ssm.ssd_step(_t(st), _t(x), _t(la), _t(bt), _t(ct))
    jy, jnew = jssm.ssd_step(st, x, la, bt, ct)
    _close(y, jy, EW_TOL)
    _close(new, jnew, EW_TOL)


# ---------------------------------------------------------------------------
# blocks and their steps
# ---------------------------------------------------------------------------

BLOCKS = {
    # name: (arch, JAX init, forward pair, state init pair, step pair)
    "mamba2": ("zamba2-1.2b", jssm.init_mamba2,
               (jssm.mamba2_forward, ssm.mamba2_forward),
               (jssm.init_mamba2_state, ssm.init_mamba2_state),
               (jssm.mamba2_step, ssm.mamba2_step)),
    "mlstm": ("xlstm-350m", jssm.init_mlstm,
              (jssm.mlstm_forward, ssm.mlstm_forward),
              (jssm.init_mlstm_state, ssm.init_mlstm_state),
              (jssm.mlstm_step, ssm.mlstm_step)),
    "slstm": ("xlstm-350m", jssm.init_slstm,
              (jssm.slstm_forward, ssm.slstm_forward),
              (jssm.init_slstm_state, ssm.init_slstm_state),
              (jssm.slstm_step, ssm.slstm_step)),
}


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_steps_match_jax(block):
    arch, init, (jfwd, fwd), (jinit_st, init_st), (jstep, step) = \
        BLOCKS[block]
    jcfg, cfg = _cfgs(arch)
    jp, p = _block_params(init, jcfg)
    # a sequence longer than one chunk and not a multiple of it: the
    # padding branch and the carried state both run
    b, s = 2, cfg.ssm_chunk + 9
    x = np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    y = fwd(p, _t(x), cfg)
    _close(y, jfwd(jp, x, jcfg), MM_TOL)
    # four steps from zero state, each against JAX and against the forward
    jst, st = jinit_st(jcfg, b), init_st(cfg, b, "cpu")
    for t in range(4):
        yt, st = step(p, _t(x[:, t]), st, cfg)
        jyt, jst = jstep(jp, x[:, t], jst, jcfg)
        _close(yt, jyt, MM_TOL)
        _close(yt, y[:, t], MM_TOL)
    for k, v in _np(jst).items():
        _close(st[k], v, MM_TOL)


def test_use_kernel_on_cpu_equals_plain():
    """``use_kernel=True`` on CPU tensors takes the kernel op's plain
    version: the same numbers as the plain path, Mamba2 and mLSTM."""
    for block in ("mamba2", "mlstm"):
        arch, init, (_, fwd), *_ = BLOCKS[block]
        jcfg, cfg = _cfgs(arch)
        _, p = _block_params(init, jcfg)
        x = _t(np.random.default_rng(3).standard_normal(
            (2, 2 * cfg.ssm_chunk, cfg.d_model)))
        with torch.no_grad():
            torch.testing.assert_close(fwd(p, x, cfg, use_kernel=True),
                                       fwd(p, x, cfg), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def test_params_round_trip_through_numpy(bridged):
    *_, params, tree = bridged
    back = params_to_numpy(params)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)


def test_smoke_logits_match_jax(bridged):
    jcfg, jparams, cfg, params, _ = bridged
    toks = _tokens(cfg.vocab_size, 2, 2 * cfg.ssm_chunk + 5)
    with torch.no_grad():
        out = api.forward(cfg, params, {"tokens": torch.from_numpy(toks)
                                        .long()})
        last = api.forward(cfg, params, {"tokens": torch.from_numpy(toks)
                                         .long()}, last_only=True)
    exp = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    _close(out, exp, MM_TOL)
    _close(last, out[:, -1:], EW_TOL)


def test_decode_steps_match_jax_and_forward(bridged):
    """Eight decode steps from a zero state: the logits equal the JAX
    package's step by step, and the cache-free forward's at every position
    (the ``tests/test_attention_math.py`` check); the final state leaves
    equal JAX's."""
    jcfg, jparams, cfg, params, _ = bridged
    b, steps = 2, 8
    toks = _tokens(cfg.vocab_size, b, steps, seed=1)
    with torch.no_grad():
        full = api.forward(cfg, params, {"tokens": torch.from_numpy(toks)
                                         .long()})
        st = api.init_decode_state(cfg, b, 16, device="cpu")
        jst = japi.init_decode_state(jcfg, b, 16)
        for t in range(steps):
            tok = toks[:, t:t + 1]
            logits, st = api.decode_step(cfg, params, st,
                                         torch.from_numpy(tok).long())
            jlogits, jst = japi.decode_step(jcfg, jparams, jst,
                                            jnp.asarray(tok))
            _close(logits, jlogits, MM_TOL)
            _close(logits[:, 0], full[:, t], MM_TOL)
    assert st["pos"] == steps == int(jst["pos"])
    jleaves = jax.tree_util.tree_leaves_with_path(_np(jst))
    for path, leaf in jleaves:
        got = st
        for k in path:
            got = got[k.key]
        if isinstance(got, torch.Tensor):
            _close(got, leaf, MM_TOL)
        else:
            assert got == int(leaf)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,max_seq", [(1, 48), (3, 256)])
def test_decode_state_bytes_match_jax(arch, batch, max_seq):
    """Admission charges ``decode_state_bytes``: it must equal the JAX
    package's ``jax.eval_shape`` count (int32 ``pos`` / ``index``
    included), or the two engines admit differently — in the default
    bf16 KV dtype and in f32."""
    for kv in ("bfloat16", "float32"):
        jcfg = jget_config(arch, smoke=True).replace(kv_cache_dtype=kv)
        cfg = get_config(arch, smoke=True).replace(kv_cache_dtype=kv)
        assert registry.spec(cfg).decode_state_bytes(cfg, batch, max_seq) \
            == jregistry.spec(jcfg).decode_state_bytes(jcfg, batch, max_seq)
    full, jfull = get_config(arch), jget_config(arch)
    assert registry.spec(full).decode_state_bytes(full, 1, 4096) \
        == jregistry.spec(jfull).decode_state_bytes(jfull, 1, 4096)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_spec_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    spec, jspec = registry.spec(cfg), jregistry.spec(jcfg)
    for cap in ("batched_prefill", "paging", "servable", "spec_draftable",
                "kv_quant"):
        assert getattr(spec, cap) == getattr(jspec, cap), cap
    assert spec.notes == jspec.notes
    assert cfg.n_params == jcfg.n_params
    assert cfg.layer_params == jcfg.layer_params


def test_full_width_configs_match_jax():
    for arch in ARCHS:
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke), jget_config(arch, smoke)
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "ssm_state",
                      "ssm_expand", "ssm_chunk", "conv_kernel",
                      "slstm_ratio", "attn_every", "max_seq_len", "source"):
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
    assert list(hybrid.attn_flags(get_config("zamba2-1.2b"))) == list(
        jhybrid.attn_flags(jget_config("zamba2-1.2b")))
    assert hybrid.n_attn_invocations(get_config("zamba2-1.2b")) == 6
