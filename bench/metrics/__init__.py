"""Readers of the benchmark's metrics, one file a metric, found by name."""
