"""Process start to the first timed unit (host clock): imports, weights,
the host stores, the pilot and the checked first steps or warm batches."""


def read(ctx):
    return ctx["setup_s"]
