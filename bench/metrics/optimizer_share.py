"""Device time of the optimizer steps (the outermost ``hydra.opt_step``
spans started in the traced window: each shard's step and the shared
leaves' step at a minibatch's end) over the window, in %."""

from bench.metrics.spans import in_window, named, nearest


def read(ctx):
    spans = in_window(ctx)
    by_id = {s.id: s for s in spans}
    steps = [s for s in named(spans, "hydra.opt_step")
             if nearest(s, by_id, "hydra.opt_step") is None]
    if not steps:
        return None
    return 100.0 * sum(s.device_ns for s in steps) / 1e9 / ctx["window_s"]
