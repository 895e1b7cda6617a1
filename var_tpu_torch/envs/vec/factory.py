"""Vec-env factory (port of var_tpu/envs/vec/factory.py), dummy env only."""
from __future__ import annotations

from typing import Optional

from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs.core import TimeLimitMask, resolve
from var_tpu_torch.envs.vec.dummy import DummyVecEnv


def make_env_thunk(env_id: str, seed: int, rank: int):
    """Per-rank seeding (seed + rank) and time-limit masking."""
    entry_point, default_kwargs = resolve(env_id)

    def _thunk():
        env = entry_point(**default_kwargs)
        env.seed(seed + rank)
        return TimeLimitMask(env)

    return _thunk


def make_vec_envs(env_name: str, seed: int, num_processes: int, gamma,
                  randomCollect: bool, config,
                  audio: Optional[AudioStore] = None):
    """Build the vectorized env stack.

    vecEnvBackend 'auto' and 'dummy' both give the in-process DummyVecEnv:
    the shared-memory worker env is not ported, so 'auto' does not switch
    to it for num_processes > 1. Each env is still seeded seed + rank, so
    the observations are those the JAX package's shmem workers give; only
    the parallelism is missing. 'shmem' raises. randomCollect=False needs
    the frozen-VAR reward wrapper and raises too; the fused RL path builds
    its envs with randomCollect=True and computes the reward on the device
    (rl/rollout_device.py)."""
    backend = getattr(config, "vecEnvBackend", "auto")
    if backend == "shmem":
        raise NotImplementedError(
            "vecEnvBackend='shmem' is not ported; use 'dummy' or 'auto'")
    if backend not in ("auto", "dummy"):
        raise ValueError(f"unknown vecEnvBackend {backend!r}")
    if not randomCollect:
        raise NotImplementedError(
            "make_vec_envs(randomCollect=False) needs the VAR reward "
            "wrapper, which is not ported yet (ROADMAP 'Modules left to "
            "port', item 2: the reward-wrapper path)")
    del gamma  # used only by the VAR reward wrapper
    thunks = [make_env_thunk(env_name, seed, i) for i in range(num_processes)]
    if audio is None:
        audio = AudioStore(config)
        audio.loadData()
    return DummyVecEnv(thunks, audio=audio)
