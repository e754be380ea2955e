"""Optimizers with per-subtree updates (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (OptimizerConfig,
                                          clip_by_global_norm, global_norm,
                                          init_state, schedule_lr, update)

__all__ = ["OptimizerConfig", "init_state", "update", "schedule_lr",
           "global_norm", "clip_by_global_norm"]
