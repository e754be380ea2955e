"""Step factories (serving half so far)."""
