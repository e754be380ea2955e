"""Kernels the card ran in the traced window (device trace) over the
evaluation batches completed in it."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["kind"] != "eval" or ctx["steps"] <= 0:
        return None
    return tr["kernels"] / ctx["steps"]
