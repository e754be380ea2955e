"""The plain references of the benchmark's configurations."""
