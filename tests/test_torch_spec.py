"""The port's slot, speculative and int8 engines against the JAX package's.

Both engines serve ``qwen3-0.6b`` smoke in float32 from the same bridged
parameters, with the same prompts submitted on the same ticks (two
prompts share a block-aligned prefix, so the paged inner aliases and
copy-on-writes):

* the slot engine gives the same token streams and the same lane
  assignment tick by tick;
* the spec engine, over the slot and the paged inner, with the target's
  own parameters as the draft (every proposal accepted) and a seed-7
  random draft (rollback every round), at k in {1, 3}, gives identical
  tokens and equal ``spec_rounds`` / ``target_steps`` / ``spec_tokens`` /
  ``draft_accept_rate``; afterwards the paged pool is empty and the
  ledger at 0, and the tokens equal plain greedy decode;
* lanes stacked into one per-lane state (``slots.stack_trees``) decode
  as if each were alone, and ``verify_step`` logits at position i equal
  i single decode steps (2e-4, the matmul-chain tolerance of
  ``tests/test_kernel_oracles.py``);
* the int8 paged engine gives the JAX int8 engine's tokens,
  ``block_bytes`` and ``kv_page_peak_bytes``;
* the default backend resolves as the JAX engine's does.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.slots import stack_trees

MM_TOL = 2e-4
GEN = 6
KW = dict(capacity=2, max_seq=48)
PAGED_KW = dict(block_size=8)
SCHEDULE = {0: ("a", "b"), 1: ("c", "d"), 3: ("e",)}   # tick -> arrivals


@functools.lru_cache(maxsize=None)
def _configs():
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params(seed):
    """(JAX params, port params) from one JAX init, bridged through numpy."""
    jcfg, _ = _configs()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(4)
    a = rng.integers(0, vocab, 24, dtype=np.int32)   # 3 full blocks of 8
    return {
        "a": a,
        "b": a[:20].copy(),                          # 2 full + boundary
        "c": rng.integers(0, vocab, 13, dtype=np.int32),
        "d": np.concatenate([a[:16],                 # 2 full blocks only
                             rng.integers(0, vocab, 5, dtype=np.int32)]),
        "e": rng.integers(0, vocab, 7, dtype=np.int32),
    }


def _drive(engine):
    """Submit on the fixed schedule; record lane -> request id per tick."""
    prompts = _prompts(_configs()[1].vocab_size)
    lanes, tick = [], 0
    while engine.has_work() or tick <= max(SCHEDULE):
        for rid in SCHEDULE.get(tick, ()):
            engine.submit(prompts[rid], GEN, request_id=rid)
        engine.step()
        lanes.append({lane: r.request_id
                      for lane, r in engine._active.items()})
        tick += 1
    engine.run()
    return lanes, {r.request_id: list(r.generated) for r in engine.completed}


@functools.lru_cache(maxsize=None)
def _served(backend, **kw):
    """Both engines built with the same arguments and driven on the
    schedule: (jax engine, jax run, port engine, port run)."""
    jcfg, cfg = _configs()
    jparams, params = _params(1)
    jkw, tkw = dict(KW), dict(KW)
    if "draft" in kw:
        draft = kw.pop("draft")
        jd, td = _params(1) if draft == "self" else _params(draft)
        jkw.update(draft_cfg=jcfg, draft_params=jd)
        tkw.update(draft_cfg=cfg, draft_params=td)
    if backend == "paged" or kw.get("spec_inner") == "paged":
        jkw.update(PAGED_KW)
        tkw.update(PAGED_KW)
    jkw.update(kw)
    tkw.update(kw)
    jeng = JEngine(jcfg, jparams, backend=backend, **jkw)
    eng = InferenceEngine(cfg, params, backend=backend, device="cpu", **tkw)
    return jeng, _drive(jeng), eng, _drive(eng)


def test_slot_engine_matches_tick_by_tick():
    jeng, (jlanes, jout), eng, (lanes, out) = _served("slot")
    assert eng.backend.name == "slot" == jeng.backend.name
    assert sorted(out) == ["a", "b", "c", "d", "e"]
    assert all(len(toks) == GEN for toks in out.values())
    assert out == jout
    assert lanes == jlanes
    s, js = eng.summary(), jeng.summary()
    for key in ("slot_bytes", "kv_peak_bytes", "kv_reserved_bytes",
                "peak_concurrency", "decode_steps", "prefill_calls"):
        assert s[key] == js[key], key
    assert s["kv_reserved_bytes"] == 0


SPEC_CASES = [(inner, draft, k) for inner in ("slot", "paged")
              for draft in ("self", 7) for k in (1, 3)]


@pytest.mark.parametrize("inner,draft,k", SPEC_CASES,
                         ids=[f"{i}-draft{d}-k{k}" for i, d, k in SPEC_CASES])
def test_spec_engine_matches_jax_and_plain_decode(inner, draft, k):
    jeng, (jlanes, jout), eng, (lanes, out) = _served(
        "spec", spec_inner=inner, draft=draft, draft_k=k)
    assert eng.backend.name == "spec" and eng.backend.inner.name == inner
    assert out == jout
    assert lanes == jlanes
    s, js = eng.summary(), jeng.summary()
    for key in ("spec_rounds", "target_steps", "draft_steps", "spec_tokens",
                "draft_accept_rate", "accepted_tokens_per_target_step",
                "draft_slot_bytes", "kv_peak_bytes", "decode_steps"):
        assert s[key] == js[key], key
    if draft == "self":
        assert s["draft_accept_rate"] == 1.0
    # greedy-exact acceptance: the same tokens as plain greedy decode
    _, (_, plain) = _served("slot")[2:]
    assert out == plain
    assert s["kv_reserved_bytes"] == 0
    if inner == "paged":
        assert eng.pool.n_used == 0 and eng.pool.refcounts() == {}
        assert eng.ledger.kv_reserved_bytes == 0
        for key in ("kv_page_peak_bytes", "shared_block_hits",
                    "cow_copies", "kv_block_allocs"):
            assert s[key] == js[key], key


def _lanes_prefilled_alone(cfg, params, rng, plens):
    """Batch-1 states, each prefilled with its own random prompt."""
    states = []
    with torch.no_grad():
        for plen in plens:
            one = api.init_decode_state(cfg, 1, 32, "cpu")
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                 (1, plen)))
            states.append(api.decode_step(cfg, params, one, toks)[1])
    return states


def test_stacked_lanes_decode_as_if_alone():
    """One decode step over lanes stacked by ``stack_trees`` (each at its
    own write index) gives every lane the logits of its lone batch-1
    step, and advances each lane's index by one."""
    _, cfg = _configs()
    _, params = _params(1)
    rng = np.random.default_rng(8)
    plens = (3, 11, 6)
    alone = _lanes_prefilled_alone(cfg, params, rng, plens)
    state = stack_trees(alone)
    assert state["kv"]["index"].tolist() == list(plens)
    assert state["kv"]["k"].shape[1] == len(plens)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (len(plens), 1)))
    with torch.no_grad():
        logits, state = api.decode_step(cfg, params, state, toks)
        for lane, one in enumerate(alone):
            want, _ = api.decode_step(cfg, params, one, toks[lane:lane + 1])
            np.testing.assert_allclose(logits[lane].numpy(), want[0].numpy(),
                                       rtol=MM_TOL, atol=MM_TOL)
    assert state["kv"]["index"].tolist() == [p + 1 for p in plens]


def test_verify_logits_equal_single_decode_steps():
    """Position i of one k-token verify forward scores exactly what i
    single-token decode steps do, per lane, each lane at its own index."""
    _, cfg = _configs()
    _, params = _params(1)
    rng = np.random.default_rng(9)
    b, k, plens = 2, 4, (5, 9)
    state = stack_trees(_lanes_prefilled_alone(cfg, params, rng, plens))
    drafts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, k)))
    snap = {n: t.clone() for n, t in state["kv"].items()}
    with torch.no_grad():
        vlogits, vstate = api.verify_step(cfg, params, state, drafts)
        assert vstate["kv"]["index"].tolist() == [p + k for p in plens]
        step = {"kv": snap}
        for i in range(k):
            logits, step = api.decode_step(cfg, params, step,
                                           drafts[:, i:i + 1])
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       vlogits[:, i].numpy(),
                                       rtol=MM_TOL, atol=MM_TOL)
        back = api.rollback_decode_state(cfg, vstate, torch.tensor([1, 3]))
    assert back["kv"]["index"].tolist() == [plens[0] + k - 1,
                                            plens[1] + k - 3]


def test_int8_paged_engine_matches_jax():
    jeng, (jlanes, jout), eng, (lanes, out) = _served("paged",
                                                      kv_dtype="int8")
    assert out == jout
    assert lanes == jlanes
    s, js = eng.summary(), jeng.summary()
    assert s["kv_dtype"] == "int8"
    for key in ("block_bytes", "kv_page_peak_bytes", "n_blocks",
                "kv_peak_bytes", "shared_block_hits", "cow_copies"):
        assert s[key] == js[key], key
    _, cfg = _configs()
    assert s["block_bytes"] == 2 * cfg.n_layers * 8 * cfg.n_kv_heads * (
        cfg.head_dim + 4)
    assert eng.pool.pages["k"].dtype == torch.int8
    assert eng.pool.pages["k_scale"].dtype == torch.float32
    assert eng.pool.n_used == 0 and s["kv_reserved_bytes"] == 0


RESOLUTION = [
    {},
    {"backend": "slot"},
    {"backend": "paged"},
    {"paged": True},
    {"backend": "spec"},
    {"backend": "spec", "spec_inner": "paged"},
]


@pytest.mark.parametrize("kw", RESOLUTION,
                         ids=["default", "slot", "paged", "legacy-paged",
                              "spec", "spec-paged"])
def test_default_backend_resolution_matches_jax(kw):
    jcfg, cfg = _configs()
    jparams, params = _params(1)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("backend") == "spec":
        jkw.update(draft_cfg=jcfg, draft_params=jparams)
        tkw.update(draft_cfg=cfg, draft_params=params)
    jeng = JEngine(jcfg, jparams, capacity=2, max_seq=32, **jkw)
    eng = InferenceEngine(cfg, params, capacity=2, max_seq=32, device="cpu",
                          **tkw)
    js, s = jeng.summary(), eng.summary()
    for key in ("backend", "requested_backend", "inner_backend",
                "slot_bytes", "kv_budget_bytes", "preemptible"):
        assert s.get(key) == js.get(key), key


def test_conflicting_backend_arguments_raise_in_both():
    jcfg, cfg = _configs()
    jparams, params = _params(1)
    with pytest.raises(ValueError, match="conflicting"):
        JEngine(jcfg, jparams, backend="slot", paged=True)
    with pytest.raises(ValueError, match="conflicting"):
        InferenceEngine(cfg, params, backend="slot", paged=True,
                        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # dense needs no fallback
        InferenceEngine(cfg, params, backend="spec", spec_inner="paged",
                        draft_cfg=cfg, draft_params=params, device="cpu")
