"""Atomic on-disk checkpoints of tensor / numpy trees."""
