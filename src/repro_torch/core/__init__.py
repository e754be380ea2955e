"""Hydra core: spilling, partitioning, SHARP scheduling and execution."""
