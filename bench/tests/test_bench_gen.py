"""The generator: the same seed gives the same weights and batches, a
leaf drawn again alone equals the one drawn with the tree, and seeds
beyond 32 bits work."""

import pytest
import torch

from _bench_util import smoke_archs

from bench import gen

ARCHS = smoke_archs()
FAM = gen.family("dense_encoder")
BIG = 2**31 + 12345678901


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_weights_repeat_per_seed(name):
    arch = ARCHS[name]
    a = gen.make_weights(FAM, arch, BIG, 1, "cpu")
    assert _same(a, gen.make_weights(FAM, arch, BIG, 1, "cpu"))
    assert not _same(a, gen.make_weights(FAM, arch, BIG + 1, 1, "cpu"))
    assert not _same(a, gen.make_weights(FAM, arch, BIG, 2, "cpu"))
    assert torch.equal(a["layers"]["attn"]["wq"],
                       gen.make_leaf(FAM, arch, BIG, 1, "layers.attn.wq", "cpu"))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batches_repeat_per_seed_and_differ_per_step(name):
    arch = ARCHS[name]
    b = gen.make_batch(FAM, arch, 16, 4, BIG, 0, 5, "cpu")
    assert _same(b, gen.make_batch(FAM, arch, 16, 4, BIG, 0, 5, "cpu"))
    assert not _same(b, gen.make_batch(FAM, arch, 16, 4, BIG, 0, 6, "cpu"))
    assert not _same(b, gen.make_batch(FAM, arch, 16, 4, 7, 0, 5, "cpu"))
    assert b["labels"].shape == (4, 16)
    assert int(b["labels"].max()) < arch["vocab_size"]
    key = "embeds" if arch["takes_embeddings"] else "tokens"
    assert b[key].shape[:2] == (4, 16)


def test_feed_draws_in_order_and_can_end():
    arch = ARCHS["bert-large-1b"]

    def stop_at_two(k):
        if k == 2:
            raise StopIteration

    feed = gen.Batches(FAM, arch, 8, 2, 9, 0, "cpu", stop_at_two)
    got = list(feed)
    assert len(got) == 2
    assert _same(got[1], gen.make_batch(FAM, arch, 8, 2, 9, 0, 1, "cpu"))
