"""Attention over a KV cache whose *sequence* is sharded over the mesh
(``decode_state_specs``'s batch-1 candidates: flash-decode context
parallelism), against the unmeshed step.

* Four gloo ranks on a (2, 2) mesh decode qwen3-0.6b smoke (f32) three
  steps from a cache of distinct random rows, for each case of
  ``SEQ_DECODE_CASES``: the sequence over ("data", "model"), with and
  without a window that leaves ranks with no live key; over 'data' with
  the heads over 'model'; and over 'model' with the batch over 'data' and
  one write index per lane.  Every step's logits equal the unmeshed
  step's within 2e-4 (the mesh tolerance of
  ``tests/test_torch_spmd_train.py``), the greedy tokens are the same,
  and each rank's shard holds the new rows exactly where it owns them
  and nothing else changed.
* The lowering dry run of full-size qwen3-0.6b on the 256-rank fake
  mesh: at ``long_500k`` no all-gather moves a K/V plane (the record's
  ``collective_shapes`` holds no 4-D all-gather as large as one rank's
  key rows of a layer) and the collectives stay under 1 GB per device;
  the heads-sharded ``decode_32k`` record is what it was before this
  path existed.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_mesh_ranks import (SEQ_DECODE_CASES, run_ranks,
                               seq_sharded_decode_rank)

import pytest
import torch

from repro_torch.launch import dryrun

MM_TOL = 2e-4
STEPS, MAX_SEQ = 3, 64


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_decode")
    run_ranks(seq_sharded_decode_rank, 4, tmp, timeout=300)
    return [torch.load(tmp / f"seq_decode_{r}.pt") for r in range(4)]


@pytest.mark.parametrize("case", sorted(SEQ_DECODE_CASES))
def test_four_rank_decode_over_sequence_shards_matches_unmeshed(ranks,
                                                                case):
    batch, _, per_lane, window = SEQ_DECODE_CASES[case]
    outs = [r[case] for r in ranks]
    assert all(any(p.startswith("S(2)") for p in o["placements"])
               for o in outs)          # the sequence of (L, b, s, h, hd)
    for o in outs:
        assert o["logit_diff"] <= MM_TOL, (case, o["logit_diff"])
        assert o["tokens"] == o["ref_tokens"]
    for name in ("k", "v"):
        offsets = {tuple(o[f"{name}_offset"][1:3]) for o in outs}
        copies = 4 // len(offsets)     # ranks holding the same rows
        assert sum(o[f"{name}_rows_owned"] for o in outs) \
            == batch * STEPS * copies
        assert all(o[f"{name}_others_unchanged"] for o in outs)
        assert max(o[f"{name}_new_rows_diff"] for o in outs) <= MM_TOL
    if case == "seq_data_model_window":
        # ranks 0 and 3 hold 16 rows each, all outside every step's window
        live = set(range(37 - window + 1, 37 + STEPS))
        assert sum(not set(range(o["k_offset"][2], o["k_offset"][2] + 16))
                   & live for o in outs) == 2


def test_long_500k_record_moves_no_kv_plane():
    rec = dryrun.run_one("qwen3-0.6b", "long_500k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert not dryrun.kv_plane_gathers(rec)
    # what gathering the cache moved before: each layer's K and V
    # gathered over 'model', then over 'data'
    planes = {"8x2048x8x128": 56, "32x16384x8x128": 56,
              "32x16384x1x128": 56}
    assert dryrun.kv_plane_gathers({**rec, "collective_shapes": {
        "all-gather": planes}}) == planes
    assert rec["collectives"]["total"] < 1e9
    assert rec["collective_shapes"]["all-reduce"]


def test_decode_32k_record_is_unchanged():
    rec = dryrun.run_one("qwen3-0.6b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["bytes_per_device"]["peak"] == 2_122_021_888
    assert rec["hlo_flops_per_device"] == 4_484_104_192
    assert rec["collectives"]["total"] == 379_484_608
