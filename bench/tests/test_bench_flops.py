"""The FLOP count behind ``mfu.*`` against a hand count for a two-layer
smoke configuration, and against the products the reference forward
really runs."""

import json

from torch.utils.flop_counter import FlopCounterMode

from _bench_util import ROOT

from bench import gen
from bench.metrics import flops
from bench.reference import dense_encoder as ref

FAM = gen.family("dense_encoder")

BERT = json.loads((ROOT / "bench" / "configs" / "bert-large-1b.json")
                  .read_text())


def test_hand_count_two_layer_smoke():
    arch = BERT["smoke"]["arch"]        # L 2, d 128, 4 x 32, ff 256, V 512
    assert (arch["n_layers"], arch["d_model"], arch["d_ff"],
            arch["vocab_size"]) == (2, 128, 256, 512)
    # per layer 4 d^2 + 2 d ff = 65,536 + 65,536; unembedding 512 x 128
    assert FAM.matmul_params(arch) == 2 * (4 * 128 * 128
                                             + 2 * 128 * 256) + 512 * 128
    assert FAM.matmul_params(arch) == 327_680
    # attention: 12 L s d trained, 4 L s d forward, s = 16
    assert flops.per_token(FAM, arch, 16, train=True) == 6 * 327_680 \
        + 12 * 2 * 16 * 128 == 2_015_232
    assert flops.per_token(FAM, arch, 16, train=False) == 2 * 327_680 \
        + 4 * 2 * 16 * 128 == 671_744


def test_full_size_count():
    arch = BERT["arch"]
    assert FAM.matmul_params(arch) == 36 * (4 * 1536**2 + 2 * 1536 * 6144) \
        + 30522 * 1536


def test_forward_count_equals_the_reference_products():
    arch = BERT["smoke"]["arch"]
    seq, rows = 16, 3
    leaves = ref.unstack(gen.make_weights(FAM, arch, 1, 0, "cpu"))
    batch = gen.make_batch(FAM, arch, seq, rows, 1, 0, 0, "cpu")
    with FlopCounterMode(display=False) as fc:
        ref.forward_loss(arch, leaves, batch, ref._Ops("f32"))
    assert fc.get_total_flops() == rows * seq * flops.per_token(
        FAM, arch, seq, train=False)
