"""Checkpointing of tensor trees, in the reference's on-disk format."""
