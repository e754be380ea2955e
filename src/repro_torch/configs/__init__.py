"""Config registry — importing this package registers every ported
architecture (only ``qwen3-0.6b`` so far)."""

from repro_torch.configs.base import (ARCH_REGISTRY, SMOKE_REGISTRY,
                                      ArchConfig, get_config, torch_dtype)

from repro_torch.configs import qwen3_0_6b  # noqa: F401  (registration)

__all__ = ["ArchConfig", "ARCH_REGISTRY", "SMOKE_REGISTRY", "get_config",
           "torch_dtype"]
