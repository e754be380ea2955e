"""Train and serve step factories, and the loss."""
