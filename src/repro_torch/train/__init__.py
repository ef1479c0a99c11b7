"""Training utilities of the port (``repro/train``): the optimizers."""
