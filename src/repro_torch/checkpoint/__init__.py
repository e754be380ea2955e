"""Checkpoints in the JAX package's format (``save`` / ``restore`` /
``latest_step``) and parameter conversion between numpy trees and the
port's tensor trees."""

from repro_torch.checkpoint.checkpoint import latest_step, restore, save
from repro_torch.checkpoint.convert import (params_from_numpy,
                                            params_to_numpy)

__all__ = ["save", "restore", "latest_step", "params_from_numpy",
           "params_to_numpy"]
