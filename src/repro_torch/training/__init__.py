"""Train and serve step factories, and the loss."""

from repro_torch.training.losses import moe_total_loss, softmax_xent
from repro_torch.training.train_loop import (decode_window_for,
                                             make_decode_step, make_grad_step,
                                             make_loss_fn,
                                             make_padded_prefill_into_cache,
                                             make_prefill_into_cache,
                                             make_prefill_step,
                                             make_train_step)

__all__ = ["softmax_xent", "moe_total_loss", "make_loss_fn", "make_train_step",
           "make_grad_step", "make_prefill_step", "make_prefill_into_cache",
           "make_padded_prefill_into_cache", "make_decode_step",
           "decode_window_for"]
