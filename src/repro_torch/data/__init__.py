"""Token data sources and host-side prefetch (port of ``repro.data``)."""

from repro_torch.data.pipeline import (DataConfig, FileTokens, Prefetcher,
                                       SyntheticTokens, make_dataset)

__all__ = ["DataConfig", "SyntheticTokens", "FileTokens", "make_dataset",
           "Prefetcher"]
