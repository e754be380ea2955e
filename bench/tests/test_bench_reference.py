"""The plain reference agrees with the port at the smoke configurations
on the CPU, and the control (the reference in float8 products) fails
that comparison where the port passes it."""

import pytest
import torch

from _bench_util import smoke_archs

from bench import gen
from bench.reference import dense_encoder as ref

CONFIGS = smoke_archs()
FAM = gen.family("dense_encoder")


def _port_logits(arch, weights, batch, dtype):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import api
    cfg = ArchConfig(**{**arch, "dtype": dtype})
    with torch.no_grad():
        return api.forward(cfg, weights, batch)


def _ref_logits(arch, weights, batch, precision):
    with torch.no_grad(), ref.exact_f32():
        return ref.forward_logits(arch, ref.unstack(weights), batch,
                                  ref._Ops(precision))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_port_and_control_does_not(name):
    """Largest logit gap over the logits' spread, three seeds."""
    arch = CONFIGS[name]
    gaps = {"f32": [], "bf16": [], "control": []}
    for seed in (1, 2, 3):
        w = gen.make_weights(FAM, arch, seed, 0, "cpu")
        batch = gen.make_batch(FAM, arch, 16, 8, seed, 0, 0, "cpu")
        want = _ref_logits(arch, w, batch, "f32")
        scale = float(want.std())

        def gap(got):
            return float((got.float() - want).abs().max()) / scale

        gaps["f32"].append(gap(_port_logits(arch, w, batch, "float32")))
        gaps["bf16"].append(gap(_port_logits(arch, w, batch, "bfloat16")))
        gaps["control"].append(gap(_ref_logits(arch, w, batch, "fp8")))
    # the port in f32 is the reference's own equations to round-off
    assert max(gaps["f32"]) < 1e-4, gaps
    # the float8 control lies far outside what bf16 compute reads
    assert min(gaps["control"]) > 3 * max(gaps["bf16"]), gaps


def test_training_reference_moves_every_leaf_and_half_batch_differs():
    arch = CONFIGS["bert-large-1b"]
    w = gen.make_weights(FAM, arch, 4, 0, "cpu")
    batches = [gen.make_batch(FAM, arch, 16, 4, 4, 0, k, "cpu") for k in range(3)]
    full = ref.train(arch, w, batches, lr=1e-3)
    assert len(full["losses"]) == 3
    assert set(full["grad"]) == set(full["change"])
    assert all(v > 0 for v in full["change"].values())
    half = ref.train(arch, w, batches, lr=1e-3, rows="half")
    assert half["losses"][0] != full["losses"][0]
    # 2 layers x (4 weights + 3 biases + 4 MLP + 4 norm) + table + 2
    assert len(full["grad"]) == 2 * 15 + 3
