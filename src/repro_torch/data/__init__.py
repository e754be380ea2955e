"""Token data sources and host-side prefetch (port of ``repro.data``)."""
