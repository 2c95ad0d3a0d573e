"""Checkpoints: atomic, asynchronous, in the reference's format."""
