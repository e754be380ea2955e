"""Share of the traced window in which a host-to-device or
device-to-host copy ran on the card (device trace), in %: the spilling
layer's promotions and demotions."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["window_s"] <= 0 or tr["copy_s"] <= 0:
        return None
    return 100.0 * tr["copy_s"] / tr["window_s"]
