"""Kernels the card ran in the traced window (device trace) over the
training minibatches completed in it."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx["kind"] != "train" or ctx["steps"] <= 0:
        return None
    return tr["kernels"] / ctx["steps"]
