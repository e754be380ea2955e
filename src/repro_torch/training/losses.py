"""Loss functions (port of ``repro.training.losses``)."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.sharding.context import is_dtensor


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


def vocab_whole(logits):
    """A DTensor's (b, s, V) logits with the vocab whole: the batch over
    the data axes and the sequence over 'model' where they divide."""
    from repro_torch.sharding import specs as sh
    mesh = logits.device_mesh
    B, rest = sh.batch_axes(mesh), [None] * (logits.dim() - 2)
    cands = [sh.P(B, "model", *rest), sh.P(B, None, *rest),
             sh.P(None, "model", *rest)]
    spec = sh.pick_spec(mesh, cands if "model" in sh.axis_names(mesh)
                        else cands[1:2], logits.shape)
    return logits.redistribute(mesh, sh.spec_placements(mesh, spec))


def _xent_over_mesh(logits, labels, mask):
    """``softmax_xent`` of DTensor logits, computed on each rank's rows:
    the logits laid out with the vocab whole (``vocab_whole``), the
    labels (and mask) in the same rows, each rank's sum of losses (and of
    the mask) reduced as a Partial sum over the mesh dims that split the
    rows.  The gold logit is then a local gather, and the backward the
    one ``_MeanXent`` builds in place."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    logits = vocab_whole(logits)
    mesh, rows = logits.device_mesh, logits.placements

    def same_rows(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, rows).to_local()

    def total(local):
        sums = [Partial() if isinstance(p, Shard) else Replicate()
                for p in rows]
        return DTensor.from_local(local, mesh, sums,
                                  run_check=False).full_tensor()

    ll, lab = logits.to_local(), same_rows(labels).long()
    if mask is None:
        return total(_MeanXent.apply(ll, lab) * lab.numel()) / labels.numel()
    m = same_rows(mask)
    logz = torch.logsumexp(ll, dim=-1)
    nll = logz - torch.gather(ll, -1, lab[..., None])[..., 0]
    return total((nll * m).sum()) / torch.clamp(total(m.sum()), min=1.0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits: (b, s, V) f32; labels: (b, s).

    DTensor logits (training over a mesh) take ``_xent_over_mesh``; the
    loss is then a plain tensor, the same on every rank."""
    if is_dtensor(logits):
        return _xent_over_mesh(logits, labels, mask)
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
