"""Data: the deterministic synthetic token pipeline."""
