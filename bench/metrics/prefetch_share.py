"""Share of the shard units started in the traced window whose shard the
executor had prefetched while the unit before it ran (``hydra.unit``
spans whose ``prefetched`` attribute is true), in %.  A program whose
units carry no ``prefetched`` attribute gives ``None``."""

from bench.metrics.spans import in_window, named


def read(ctx):
    units = named(in_window(ctx), "hydra.unit")
    if not any("prefetched" in s.attrs for s in units):
        return None
    return 100.0 * sum(1 for s in units if s.attrs.get("prefetched")) \
        / len(units)
