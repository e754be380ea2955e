"""Optimizers with per-subtree updates (port of ``repro.optim``)."""
