"""Vectorized environments (the in-process dummy env)."""
