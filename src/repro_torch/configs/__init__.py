"""Config registry — importing this package registers every ported
architecture (``qwen3-0.6b``, ``bert-large-1b``, ``zamba2-1.2b`` and
``xlstm-350m`` so far)."""

from repro_torch.configs.base import (ARCH_REGISTRY, INPUT_SHAPES,
                                      SMOKE_REGISTRY, ArchConfig, InputShape,
                                      get_config, torch_dtype)

from repro_torch.configs import paper_workloads  # noqa: F401  (registration)
from repro_torch.configs import qwen3_0_6b  # noqa: F401  (registration)
from repro_torch.configs import xlstm_350m  # noqa: F401  (registration)
from repro_torch.configs import zamba2_1_2b  # noqa: F401  (registration)

__all__ = ["ArchConfig", "InputShape", "ARCH_REGISTRY", "SMOKE_REGISTRY",
           "INPUT_SHAPES", "get_config", "torch_dtype"]
