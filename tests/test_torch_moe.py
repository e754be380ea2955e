"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, for mixtral-8x22b and dbrx-132b smoke in
float32 on the CPU.

Routing is discontinuous: a rounding difference can flip an expert and
move every later capacity position.  So routing decisions (experts,
positions, keep mask, capacity) must be EQUAL in f32, and only then do
values compare, at the reference's tolerances: 2e-5 for f32 elementwise
work, 2e-4 for matmul chains (``tests/test_kernel_oracles.py``).
Weights come from ``_torch_weights.both_params``; inputs from numpy
seeds.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_weights import both_params

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, as_tensors
from repro_torch.models import api, moe
from repro_torch.optim import optimizers as opt
from repro_torch.training import moe_total_loss
from repro_torch.training.train_loop import make_train_step

F32_TOL = 2e-5
MM_TOL = 2e-4
ARCHS = ["mixtral-8x22b", "dbrx-132b"]


def _cfgs(arch, **kw):
    return (jget_config(arch, smoke=True).replace(dtype=jnp.float32, **kw),
            get_config(arch, smoke=True).replace(dtype="float32", **kw))


def _close(out, exp, tol=MM_TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _aux_close(aux, jaux, tol):
    assert set(aux) == set(jaux)
    for k in jaux:
        _close(aux[k].numpy(), jaux[k], tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_routing_decisions_equal_jax(arch, capacity_factor):
    """Gates, experts, positions, keep and C are JAX's; at a capacity
    factor of 0.3 tokens drop (frac_dropped > 0) and the drops are the
    same tokens."""
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = both_params(jcfg, cfg, 0)
    router = tp["layers"]["moe"]["router"][0]
    x = _x(cfg, 2, 64)
    jr = jmoe._routing(jnp.asarray(x), jnp.asarray(router.numpy()), jcfg)
    r = moe._routing(torch.from_numpy(x), router, cfg)
    _close(r[0].numpy(), jr[0], F32_TOL)
    for got, exp in zip(r[1:4], jr[1:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert r[4] == jr[4]
    _aux_close(r[5], jr[5], F32_TOL)
    assert (float(r[5]["frac_dropped"]) > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunked", [False, True])
def test_moe_mlp_matches_jax(arch, chunked):
    """The unchunked inner layer, and the sequence-chunked ``moe_mlp``
    at two chunks (b 8: chunk = min(1024, 16384 // 8) = 1024, s 2048),
    whose aux is the mean of the chunks' (not the unchunked aux)."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = both_params(jcfg, cfg, 0)
    lp = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    if chunked:
        b, s = 8, 2 * moe.MOE_SEQ_CHUNK
        x = _x(cfg, b, s, seed=1)
        y, aux = moe.moe_mlp(lp, torch.from_numpy(x), cfg)
        jy, jaux = jmoe.moe_mlp(jlp, jnp.asarray(x), jcfg)
        whole = moe._moe_mlp_inner(lp, torch.from_numpy(x), cfg)[1]
        assert float(whole["lb_loss"]) != pytest.approx(
            float(aux["lb_loss"]), rel=1e-7)
    else:
        x = _x(cfg, 2, 48, seed=2)
        y, aux = moe._moe_mlp_inner(lp, torch.from_numpy(x), cfg)
        jy, jaux = jmoe._moe_mlp_inner(jlp, jnp.asarray(x), jcfg)
    _close(y.numpy(), jy)
    _aux_close(aux, jaux, F32_TOL)


@pytest.mark.parametrize("e_pow", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_expert_capacity_matches_jax(e_pow, k):
    """JAX ``tests/test_property_extra.py``'s grid, at several group
    sizes: equal, >= 8 and a multiple of 8."""
    kw = dict(n_experts=2 ** e_pow, top_k=min(k, 2 ** e_pow))
    jcfg = jget_config("mixtral-8x22b", smoke=True).replace(**kw)
    cfg = get_config("mixtral-8x22b", smoke=True).replace(**kw)
    for n in (1, 7, 128, 1000):
        c = moe.expert_capacity(cfg, n)
        assert c == jmoe.expert_capacity(jcfg, n)
        assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_and_aux_match_jax(arch, last_only):
    jcfg, cfg = _cfgs(arch)
    jp, tp = both_params(jcfg, cfg, 0)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    jl, jaux = jmoe.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                            return_aux=True, last_only=last_only)
    with torch.no_grad():
        tl, aux = moe.forward(cfg, tp, {"tokens": torch.from_numpy(toks)},
                              return_aux=True, last_only=last_only)
        assert torch.equal(api.forward(cfg, tp, {"tokens": torch.from_numpy(
            toks)}, last_only=last_only), tl)
    _close(tl.numpy(), jl)
    _aux_close(aux, jaux, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tokens_match_jax(arch):
    """Greedy: a batched prompt prefill, then 8 one-token steps; the
    tokens and the last logits equal JAX's (window 128 on mixtral).  The
    cache is f32 too: a bf16 cache rounds K/V rows in both packages."""
    jcfg, cfg = _cfgs(arch, kv_cache_dtype="float32")
    jp, tp = both_params(jcfg, cfg, 0)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    js = japi.init_decode_state(jcfg, 2, 32)
    st = api.init_decode_state(cfg, 2, 32, "cpu")
    jstep = jax.jit(japi.decode_step, static_argnums=0)
    jl, js = jstep(jcfg, jp, js, jnp.asarray(toks))
    with torch.no_grad():
        tl, st = api.decode_step(cfg, tp, st, torch.from_numpy(toks))
    out, jout = [], []
    for _ in range(8):
        _close(tl[:, -1].numpy(), jl[:, -1])
        nxt, jnxt = tl[:, -1].argmax(-1), jnp.argmax(jl[:, -1], -1)
        out.append(nxt.tolist())
        jout.append(np.asarray(jnxt).tolist())
        jl, js = jstep(jcfg, jp, js, jnxt[:, None])
        with torch.no_grad():
            tl, st = api.decode_step(cfg, tp, st, nxt[:, None])
    assert out == jout
    assert st["kv"]["index"] == int(js["kv"]["index"]) == 20


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step (clip on): loss, xent, lb_loss, z_loss and the grad
    norm at 2e-4; ``moe_total_loss`` puts the loss together as JAX's."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = both_params(jcfg, cfg, 0)
    kw = dict(kind="adamw", lr=1e-3, grad_clip=1.0)
    jocfg, ocfg = jopt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    dcfg = dict(batch_size=2, seq_len=32, vocab_size=cfg.vocab_size, seed=3)
    jb = next(iter(JSyntheticTokens(JDataConfig(**dcfg))))
    b = next(iter(SyntheticTokens(DataConfig(**dcfg))))
    _, _, jm = jax.jit(jmake_train_step(jcfg, jocfg))(
        jp, jopt.init_state(jocfg, jp), jax.tree.map(jnp.asarray, jb))
    _, _, m = make_train_step(cfg, ocfg)(tp, opt.init_state(ocfg, tp),
                                         as_tensors(b, "cpu"))
    for k in ("loss", "xent", "lb_loss", "z_loss", "grad_norm"):
        _close(m[k].numpy(), jm[k])
    total = moe_total_loss(m["xent"], {"lb_loss": m["lb_loss"],
                                       "z_loss": m["z_loss"]})
    _close(total.numpy(), m["loss"].numpy(), F32_TOL)
