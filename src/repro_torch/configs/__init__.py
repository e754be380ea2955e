"""Config registry — importing this package registers every architecture:
the assigned ones in ``ASSIGNED_ARCHS`` and the paper's own workloads
(``bert-large-1b``, ``vit-300m``)."""

from repro_torch.configs.base import (ARCH_REGISTRY, INPUT_SHAPES,
                                      SMOKE_REGISTRY, ArchConfig, InputShape,
                                      get_config, torch_dtype)

# assigned architectures (registration side effects)
from repro_torch.configs import qwen2_5_32b            # noqa: F401
from repro_torch.configs import llava_next_mistral_7b  # noqa: F401
from repro_torch.configs import qwen3_0_6b             # noqa: F401
from repro_torch.configs import mixtral_8x22b          # noqa: F401
from repro_torch.configs import dbrx_132b              # noqa: F401
from repro_torch.configs import xlstm_350m             # noqa: F401
from repro_torch.configs import yi_34b                 # noqa: F401
from repro_torch.configs import command_r_plus_104b    # noqa: F401
from repro_torch.configs import zamba2_1_2b            # noqa: F401
from repro_torch.configs import whisper_medium         # noqa: F401
# the paper's own workloads
from repro_torch.configs import paper_workloads        # noqa: F401

ASSIGNED_ARCHS = [
    "qwen2.5-32b", "llava-next-mistral-7b", "qwen3-0.6b", "mixtral-8x22b",
    "dbrx-132b", "xlstm-350m", "yi-34b", "command-r-plus-104b",
    "zamba2-1.2b", "whisper-medium",
]

__all__ = ["ArchConfig", "InputShape", "ARCH_REGISTRY", "SMOKE_REGISTRY",
           "INPUT_SHAPES", "ASSIGNED_ARCHS", "get_config", "torch_dtype"]
