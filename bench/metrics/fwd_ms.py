"""Median over the evaluation batches started in the traced window of
the device time of their shards' forwards (the ``hydra.fwd`` spans in
one ``hydra.eval_batch``), in ms: the forward without its promotions,
the feed or the loss."""

from collections import defaultdict

from bench.metrics.spans import in_window, median_ms, named, nearest


def read(ctx):
    spans = in_window(ctx)
    by_id = {s.id: s for s in spans}
    per_batch = defaultdict(int)
    for s in named(spans, "hydra.fwd"):
        batch = nearest(s, by_id, "hydra.eval_batch")
        if batch is not None:
            per_batch[batch.id] += s.device_ns
    return median_ms(per_batch.values())
