"""Tokens of every grid minibatch completed in the window, over the
window (host clock)."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["window_s"] <= 0:
        return None
    return ctx["tokens"] / ctx["window_s"]
