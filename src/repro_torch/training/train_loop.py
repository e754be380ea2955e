"""Serving-step factories (port of ``repro.training.train_loop``, serving
half; the train step comes with the SHARP slice)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import api, registry


def make_prefill_into_cache(cfg, *, window: Optional[int] = None):
    """Fill the decode cache with a whole prompt, returning the logits the
    first generated token is sampled from.

    Attention families consume the full ``(b, plen)`` prompt in ONE
    ``decode_step``: the KV write is one slice assignment of ``plen`` rows
    and the causal chunk mask keeps intra-prompt attention correct.
    Returns ``prefill(params, state, tokens) -> (last_logits (b, V),
    state)``; the state's cache planes are written in place."""
    spec = registry.spec(cfg)
    if not spec.batched_prefill:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): token-by-token prefill of recurrent "
            "families is ported in a later slice")

    @torch.no_grad()
    def prefill(params, state, tokens):
        logits, state = api.decode_step(cfg, params, state, tokens,
                                        window=window)
        return logits[:, -1, :], state

    return prefill


def make_paged_decode_step(cfg, *, window: Optional[int] = None, impl=None):
    """One-token greedy decode through per-lane KV block tables.

    Returns ``step(params, pages, tables, lengths, tokens) -> next_tokens
    (n, 1) int32``; the pages are written in place (the JAX package
    donates them and gets an updated copy back)."""

    @torch.no_grad()
    def paged_step(params, pages, tables, lengths, tokens):
        logits = api.paged_decode_step(cfg, params, pages, tables, lengths,
                                       tokens, window=window, impl=impl)
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)

    return paged_step


def make_decode_step(cfg, *, window: Optional[int] = None):
    """One-token greedy decode against a contiguous KV cache.  Returns
    ``step(params, state, tokens (b, 1)) -> (next_tokens (b, 1) int32,
    state)``; the cache planes are written in place."""

    @torch.no_grad()
    def decode_step(params, state, tokens):
        logits, state = api.decode_step(cfg, params, state, tokens,
                                        window=window)
        return (torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                .to(torch.int32), state)

    return decode_step


def make_verify_step(cfg, *, window: Optional[int] = None):
    """Speculative verify over the contiguous cache: tokens ``(b, k)`` (the
    last committed token + k-1 drafts) -> ``(greedy (b, k) int32, state)``,
    the target's greedy continuation at every draft position in ONE
    forward.  The cache advances k rows; the caller rewinds past the
    accept point (``api.rollback_decode_state``)."""

    @torch.no_grad()
    def verify(params, state, tokens):
        logits, state = api.verify_step(cfg, params, state, tokens,
                                        window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return verify


def make_paged_verify_step(cfg, *, window: Optional[int] = None, impl=None):
    """The paged twin of ``make_verify_step``: k positions per lane scored
    through block tables.  Returns ``step(params, pages, tables, lengths,
    tokens (n, k)) -> greedy (n, k) int32``; the pages are written in
    place."""

    @torch.no_grad()
    def verify(params, pages, tables, lengths, tokens):
        logits = api.paged_verify_step(cfg, params, pages, tables, lengths,
                                       tokens, window=window, impl=impl)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return verify
