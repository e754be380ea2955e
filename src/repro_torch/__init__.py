"""PyTorch/CUDA port of the ``repro`` package (Hydra multi-model serving
and training), mirroring its module paths.

The port imports ``torch``, numpy and the standard library only.  Entry
points take an explicit ``device`` that defaults to ``"cuda"``; a caller
that wants the CPU asks for it, and a CUDA request on a machine without a
card raises instead of quietly running on the CPU (``resolve_device``).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` an entry point runs on.  Raises when a CUDA
    device is asked for and none is available: nothing in the port falls
    back to the CPU on its own.  ``"meta"`` builds shapes without memory
    (the registry prices a decode state that way)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device={str(device)!r}: expected 'cuda', 'cpu' "
                         "or 'meta'")
    return dev
