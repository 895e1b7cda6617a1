"""In-process sequential vec env (port of var_tpu/envs/vec/dummy.py).

Keeps per-env raw obs dicts in `obs_list` for the triplet collector and
auto-resets on done.
"""
from __future__ import annotations

import numpy as np

from .base import VecEnv, stack_obs


class DummyVecEnv(VecEnv):
    def __init__(self, env_fns, audio=None):
        self.envs = [fn() for fn in env_fns]
        env = self.envs[0]
        super().__init__(len(env_fns), env.observation_space, env.action_space)
        if audio is not None:
            # every env shares one audio store
            for e in self.envs:
                e.unwrapped.audio = audio
        self.actions = None
        self.obs_list = [None] * self.num_envs

    def reset(self):
        self.obs_list = [env.reset() for env in self.envs]
        return stack_obs(self.obs_list, self.observation_space)

    def step_async(self, actions):
        self.actions = actions

    def step_wait(self):
        obs, rews, dones, infos = [], [], [], []
        for i, env in enumerate(self.envs):
            o, r, d, info = env.step(self.actions[i])
            if d:
                o = env.reset()
            obs.append(o)
            rews.append(r)
            dones.append(d)
            infos.append(info)
        self.obs_list = obs
        return (
            stack_obs(obs, self.observation_space),
            np.asarray(rews, dtype=np.float32),
            np.asarray(dones, dtype=bool),
            tuple(infos),
        )

    def close_extras(self):
        for env in self.envs:
            env.close()
