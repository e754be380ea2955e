"""Bytes of the host stores (weights, and for training the AdamW
moments) over the seconds of the set-up span that builds them (host
clock), in GB/s."""


def read(ctx):
    if ctx["pin_s"] <= 0 or ctx["pin_bytes"] <= 0:
        return None
    return ctx["pin_bytes"] / ctx["pin_s"] / 1e9
