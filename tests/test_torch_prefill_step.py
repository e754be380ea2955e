"""The port's serving helpers and the plan dry run against the JAX
package's.

* ``training.make_prefill_step``: the last position's logits of a batch
  of prompts (``forward(..., last_only=True)``) equal JAX's with the same
  weights and tokens, at ``tests/test_kernel_oracles.py``'s tolerances
  (2e-4 in f32 for a chain ending in products, 2e-2 in bf16), for the
  dense, MoE, VLM (from embeddings) and recurrent families.
* ``training.decode_window_for`` equals JAX's for every config of
  ``ASSIGNED_ARCHS`` (full and smoke) at every ``INPUT_SHAPES`` entry,
  which needs ``ArchConfig.long_context_window`` (JAX's default, 8192).
* ``python -m repro_torch.launch.dryrun --plan --smoke`` writes the Plan
  JSON that ``python -m repro.launch.dryrun --plan --smoke`` writes for
  the same arguments (``make plan-smoke``'s), and its round trip holds;
  the lowering mode (``launch/dryrun.py``'s other mode) writes an ``ok``
  record for qwen3-0.6b smoke at ``decode_32k`` on the 256-rank fake
  mesh.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_weights import both_params
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JASSIGNED
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.training import decode_window_for as jdecode_window_for
from repro.training import make_prefill_step as jmake_prefill_step
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.training import decode_window_for, make_prefill_step

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b",
                                  "llava-next-mistral-7b", "xlstm-350m"])
def test_prefill_step_matches_jax(arch, dtype):
    jcfg = jget_config(arch, smoke=True).replace(dtype=getattr(jnp, dtype))
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    jparams, params = both_params(jcfg, cfg, 0)
    rng = np.random.default_rng(4)
    if cfg.takes_embeddings:
        emb = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
        batch = {"embeds": torch.from_numpy(emb).to(torch.bfloat16)}
        jbatch = {"embeds": jnp.asarray(emb).astype(jnp.bfloat16)}
    else:
        toks = rng.integers(0, cfg.vocab_size, (2, 12))
        batch = {"tokens": torch.from_numpy(toks)}
        jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    out = make_prefill_step(cfg)(params, batch)
    exp = np.asarray(jmake_prefill_step(jcfg)(jparams, jbatch), np.float32)
    assert tuple(out.shape) == exp.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(out.float().numpy(), exp, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_assigned_archs_and_shapes_are_jax_s():
    assert list(ASSIGNED_ARCHS) == list(JASSIGNED)
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in INPUT_SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.kind) for k, s in JSHAPES.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_window_for_equals_jax(arch, smoke):
    cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    assert cfg.long_context_window == jcfg.long_context_window
    got = {name: decode_window_for(cfg, shape)
           for name, shape in INPUT_SHAPES.items()}
    assert got == {name: jdecode_window_for(jcfg, shape)
                   for name, shape in JSHAPES.items()}
    assert got["long_500k"] == (None if cfg.family in ("ssm", "hybrid")
                                else cfg.window or 8192)


def test_plan_dryrun_writes_the_jax_plan(tmp_path, monkeypatch, capsys):
    """``make plan-smoke``'s arguments through both CLIs: the same Plan
    JSON, and the same printed summary."""
    # importing the JAX dry run sets XLA_FLAGS (512 host devices) for its
    # lowering mode: monkeypatch puts the variable back after the test, so
    # no later subprocess of this worker inherits it
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    from repro.launch import dryrun as jdryrun
    monkeypatch.chdir(tmp_path)
    argv = ["--plan", "--arch", "qwen3-0.6b,bert-large-1b", "--smoke",
            "--budget-mb", "18"]
    summary = dryrun.main(argv + ["--out", "port.json", "--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setattr(sys, "argv", ["dryrun"] + argv + ["--out",
                                                          "jax.json"])
    jdryrun.main()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    port, jax_ = (json.loads((tmp_path / f).read_text())
                  for f in ("port.json", "jax.json"))
    assert port == jax_
    assert [len(j["partition"]["shards"]) for j in port["jobs"]] == [2, 1]
    assert json.loads(port_lines[0]) == json.loads(jax_lines[0]) == summary
    assert port_lines[1].endswith("round-trip OK)")


def test_lowering_dryrun_writes_an_ok_record(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--smoke",
                 "--out", str(out)])
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) \
        == ("qwen3-0.6b", "decode_32k", "32x8", "ok")
    assert rec["smoke"] and rec["collectives"]["n_ops"] > 0
