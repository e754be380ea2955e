"""Parameter conversion between numpy trees and the port's tensor trees.
The JAX package's ``save`` / ``restore`` / ``latest_step`` come with
``checkpoint/checkpoint.py`` (ROADMAP Queue 1 item 9)."""

from repro_torch.checkpoint.convert import (params_from_numpy,
                                            params_to_numpy)

__all__ = ["params_from_numpy", "params_to_numpy"]
