"""The port's paged ``InferenceEngine`` against the JAX package's.

Both engines serve ``qwen3-0.6b`` smoke in float32 from the same bridged
parameters, with the same prompts submitted on the same ticks — two of
them share a block-aligned prefix and one shares a partial boundary
block, so aliasing and copy-on-write both run.  The port must give
identical token streams, the same lane assignment tick by tick (hence the
same admission order), and equal ``kv_page_peak_bytes``,
``shared_block_hits`` and ``cow_copies``.  Final pages agree within 2e-4
outside garbage block 0, which every inactive lane writes in an
unspecified order.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
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
from repro_torch.serving.engine import InferenceEngine

MM_TOL = 2e-4
GEN = 6


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


SCHEDULE = {0: ("a", "b"), 1: ("c", "d"), 3: ("e",)}   # tick -> arrivals


def _drive(engine, prompts):
    """Submit on the fixed schedule; record lane -> request id per tick."""
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


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, kv_cache_dtype="float32")
    cfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    prompts = _prompts(cfg.vocab_size)
    kw = dict(capacity=2, max_seq=48, block_size=8)
    jeng = JEngine(jcfg, jparams, backend="paged", **kw)
    eng = InferenceEngine(cfg, params, backend="paged", device="cpu", **kw)
    return jeng, _drive(jeng, prompts), eng, _drive(eng, prompts)


def test_token_streams_are_identical(served):
    _, (_, jout), _, (_, out) = served
    assert sorted(out) == ["a", "b", "c", "d", "e"]
    assert all(len(toks) == GEN for toks in out.values())
    assert out == jout


def test_admission_order_and_lanes_match_tick_by_tick(served):
    _, (jlanes, _), _, (lanes, _) = served
    assert lanes == jlanes


def test_page_accounting_matches(served):
    jeng, _, eng, _ = served
    js, s = jeng.summary(), eng.summary()
    for key in ("kv_page_peak_bytes", "shared_block_hits", "cow_copies",
                "kv_peak_bytes", "kv_block_allocs", "peak_concurrency",
                "decode_steps", "prefill_calls", "n_blocks", "block_bytes"):
        assert s[key] == js[key], key
    assert s["shared_block_hits"] > 0 and s["cow_copies"] > 0
    assert s["kv_reserved_bytes"] == 0 and eng.pool.refcounts() == {}


def test_pages_match_outside_the_garbage_block(served):
    jeng, _, eng, _ = served
    for name in ("k", "v"):
        np.testing.assert_allclose(
            eng.pool.pages[name][:, 1:].numpy(),
            np.asarray(jeng.pool.pages[name][:, 1:], np.float32),
            rtol=MM_TOL, atol=MM_TOL)


def test_engine_runs_through_the_plain_attention_on_cpu(served):
    _, _, eng, _ = served
    assert eng.paged_impl == "ref"
    assert eng.pool.pages["k"].device == torch.device("cpu")
