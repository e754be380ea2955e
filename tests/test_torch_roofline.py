"""The port's roofline analysis and lowering dry run against the JAX
package's.

* ``roofline.analytic_step`` equals JAX's for every config x
  ``INPUT_SHAPES`` entry (relative 1e-12: the same formulas on the same
  integers and floats).
* ``roofline.analyze`` of one JAX-format dry-run record, under one
  facts JSON loaded by each package's ``load_facts``, gives equal terms
  and the same ``dominant``; the port's default constants are the H100's.
* ``dryrun.run_one`` returns ``status: "ok"`` on the 256-rank fake mesh
  for qwen3-0.6b at ``decode_32k`` (full size) and at ``train_4k``.  The
  full-size ``train_4k`` step takes about a minute to trace here, so the
  test runs qwen3-0.6b smoke for it (the record says ``smoke: true``).
  Each record counts one device: its arguments below the global param
  bytes, its peak too (``decode_32k``; a smoke model's activations
  outweigh its 1.2M params), its FLOPs at least 64 times under the
  analytic global count; its collectives are under JAX's kind names with
  ``n_ops > 0``, and it reads as a roofline row.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import json

import pytest

from repro.configs import ARCH_REGISTRY as JREGISTRY
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro.profiler.facts import load_facts as jload_facts
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.profiler.facts import hardware_constants, load_facts

JAX_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"}


@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_analytic_step_matches_jax(arch):
    for name in JSHAPES:
        exp = jroofline.analytic_step(jget_config(arch), JSHAPES[name])
        got = roofline.analytic_step(get_config(arch), INPUT_SHAPES[name])
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k] == pytest.approx(exp[k], rel=1e-12), (name, k)


def _jax_record():
    return {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16",
            "family": "dense", "kind": "train", "status": "ok",
            "bytes_per_device": {"arguments": 1, "output": 1, "temp": 1,
                                 "alias": 0, "peak": 3},
            "hlo_flops_per_device": 1.0e12,
            "collectives": {"all-gather": 3.0e9, "total": 3.0e9,
                            "n_ops": 10},
            "scan_trip": 28}


def test_analyze_matches_jax_under_one_facts_file(tmp_path):
    path = tmp_path / "facts.json"
    path.write_text(json.dumps({
        "schema_version": 1, "fingerprint": {}, "created_unix": 0.0,
        "hardware": {"peak_flops_bf16": 5e14, "hbm_bw": 2e12,
                     "ici_bw": 4e11, "h2d_bw": 16e9}}))
    rec = _jax_record()
    exp = jroofline.analyze(
        [rec], facts=jload_facts(str(path), require_fresh=False))[0]
    got = roofline.analyze(
        [rec], facts=load_facts(str(path), require_fresh=False))[0]
    for k in ("t_compute_s", "t_memory_s", "t_collective_s",
              "model_flops", "total_flops"):
        assert got["roofline"][k] == pytest.approx(exp["roofline"][k],
                                                   rel=1e-12), k
    assert got["roofline"]["dominant"] == exp["roofline"]["dominant"]
    assert got["roofline"]["hw_source"] == "measured"


def test_default_constants_are_h100():
    from repro_torch.launch import mesh
    hw = hardware_constants()
    assert (hw["peak_flops_bf16"], hw["hbm_bw"], hw["ici_bw"]) \
        == (989e12, 3.35e12, 900e9) \
        == (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW)
    assert hw["source"] == "analytic"
    assert roofline.CHIPS["32x8"] == 256 and roofline.CHIPS["2x32x8"] == 512


@pytest.mark.parametrize("shape,smoke", [("decode_32k", False),
                                         ("train_4k", True)])
def test_lowering_dryrun_record_reads_as_roofline_row(shape, smoke):
    from repro_torch.models import api
    rec = dryrun.run_one("qwen3-0.6b", shape, smoke=smoke)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "32x8"
    params = api.init_params(get_config("qwen3-0.6b", smoke=smoke), None,
                             "meta")
    global_bytes = sum(p.numel() * p.element_size() for p in
                       _leaves(params))
    per_dev = rec["bytes_per_device"]
    assert 0 < per_dev["arguments"] < global_bytes
    if not smoke:       # a smoke model's activations outweigh its params
        assert per_dev["peak"] < global_bytes
    # rank 0's FLOPs, not the step's: the analytic global count over 256
    # GPUs, within a factor of 4 for work the mesh repeats
    cfg = get_config("qwen3-0.6b", smoke=smoke)
    total = roofline.analytic_step(cfg, INPUT_SHAPES[shape])["flops"]
    assert 0 < rec["hlo_flops_per_device"] * 64 < total
    coll = rec["collectives"]
    assert coll["n_ops"] > 0 and coll["total"] > 0
    assert set(coll) - {"total", "n_ops"} <= JAX_KINDS
    assert rec["hlo_flops_per_device"] > 0
    row = roofline.analyze([json.loads(json.dumps(rec))])[0]
    assert row["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]
