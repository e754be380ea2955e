"""Model families of the port (the dense family so far)."""
