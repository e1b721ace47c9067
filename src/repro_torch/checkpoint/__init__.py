"""Checkpoints of the port's state, in the reference's on-disk layout."""
