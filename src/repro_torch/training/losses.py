"""Loss functions (port of ``repro.training.losses``)."""

from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (b, s, V) f32; labels: (b, s)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
