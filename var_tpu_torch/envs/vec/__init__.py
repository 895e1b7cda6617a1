"""Vectorized environments: the in-process DummyVecEnv and the
shared-memory ShmemVecEnv (one worker process per env)."""
