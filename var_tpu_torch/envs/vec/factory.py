"""Vec-env factory (port of var_tpu/envs/vec/factory.py): the dummy or the
shared-memory vec env, with the frozen-VAR reward wrapper (rl/reward.py)
outside random collection."""
from __future__ import annotations

from typing import Optional

from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs.core import TimeLimitMask, resolve
from var_tpu_torch.envs.vec.dummy import DummyVecEnv
from var_tpu_torch.envs.vec.shmem import ShmemVecEnv


class EnvThunk:
    """One env's constructor: per-rank seeding (seed + rank) and time-limit
    masking. It pickles with plain pickle, so forkserver and spawn workers
    can receive it: the env id is resolved here, in the parent, because
    the registry is process-local and a worker's is empty, and the thunk
    carries the registered constructor (a module-level class, pickled by
    reference) and its keyword arguments (the config)."""

    def __init__(self, env_id: str, seed: int, rank: int):
        self.seed, self.rank = seed, rank
        self.entry_point, self.kwargs = resolve(env_id)

    def __call__(self):
        env = self.entry_point(**self.kwargs)
        env.seed(self.seed + self.rank)
        return TimeLimitMask(env)


def make_vec_envs(env_name: str, seed: int, num_processes: int, gamma,
                  randomCollect: bool, config, pretext_model=None,
                  audio: Optional[AudioStore] = None, device="cpu"):
    """Build the vectorized env stack, as the JAX package's factory does.

    vecEnvBackend 'auto' gives ShmemVecEnv (one worker process per env,
    started from config.vecEnvContext, 'forkserver' by default) when
    num_processes > 1 and DummyVecEnv (in-process) for one env; 'shmem'
    always gives ShmemVecEnv and 'dummy' always DummyVecEnv. Env i is
    seeded seed + i either way, so both backends give the same
    observations. Unless randomCollect, the frozen-VAR reward wrapper
    (rl/reward.py::VecVARReward) goes on top, running `pretext_model` on
    `device`, with return normalisation when `gamma` is given; the fused
    RL paths build their envs with randomCollect=True and compute the
    reward on the device (rl/rollout_device.py)."""
    backend = getattr(config, "vecEnvBackend", "auto")
    if backend not in ("auto", "dummy", "shmem"):
        raise ValueError(f"unknown vecEnvBackend {backend!r}")
    if not randomCollect and pretext_model is None:
        raise ValueError("make_vec_envs(randomCollect=False) needs the "
                         "frozen VAR (pretext_model)")
    thunks = [EnvThunk(env_name, seed, i) for i in range(num_processes)]
    if audio is None:
        audio = AudioStore(config)
        audio.loadData()
    if backend == "shmem" or (backend == "auto" and num_processes > 1):
        envs = ShmemVecEnv(
            thunks, context=getattr(config, "vecEnvContext", "forkserver"),
            audio=audio)
    else:
        envs = DummyVecEnv(thunks, audio=audio)
    if randomCollect:
        return envs
    from var_tpu_torch.rl.reward import VecVARReward

    if gamma is None:
        return VecVARReward(envs, pretext_model, config, ob=False, ret=False,
                            device=device)
    return VecVARReward(envs, pretext_model, config, ob=False, ret=True,
                        gamma=gamma, device=device)
