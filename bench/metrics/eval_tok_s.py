"""Tokens of every evaluation batch completed in the window, over the
window (host clock)."""


def read(ctx):
    if ctx["kind"] != "eval" or ctx["window_s"] <= 0:
        return None
    return ctx["tokens"] / ctx["window_s"]
