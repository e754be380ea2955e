"""Loss functions (port of ``repro.training.losses``)."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


class _MeanXent(torch.autograd.Function):
    """``mean(logsumexp(logits) - logits[label])`` whose backward makes
    one ``logits``-sized tensor: the gradient, built in place.  Autograd
    over the same forward makes four (the exponentials, their product
    with the incoming gradient, the gather's scatter into zeros, and the
    sum of the two), which sets the peak of a language model's last
    shard.  The values are autograd's: the same operations on the same
    numbers."""

    @staticmethod
    def forward(ctx, logits, labels):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, logz)
        return (logz - gold).mean()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        # mean: g / numel at every position; logsumexp: that times
        # exp(logits - logz); gather: minus it added at each label
        gn = (g.expand(logz.shape) / logz.numel())[..., None]
        grad = torch.sub(logits, logz[..., None]).exp_()
        grad.mul_(gn)
        grad.scatter_add_(-1, labels[..., None], -gn)
        return grad, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (b, s, V) f32; labels: (b, s)."""
    if mask is None:
        return _MeanXent.apply(logits, labels.long())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def moe_total_loss(xent: torch.Tensor, aux: dict, *, lb_coef: float = 0.01,
                   z_coef: float = 1e-3) -> torch.Tensor:
    """Cross-entropy plus the MoE load-balance and router z-loss terms."""
    return xent + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
