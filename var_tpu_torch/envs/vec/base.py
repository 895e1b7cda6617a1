"""Vectorized-environment protocol (port of var_tpu/envs/vec/base.py):
batched reset / step_async / step_wait over N environments with dict
observations."""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections import OrderedDict

import numpy as np


class VecEnv(ABC):
    closed = False

    def __init__(self, num_envs, observation_space, action_space):
        self.num_envs = num_envs
        self.observation_space = observation_space
        self.action_space = action_space

    @abstractmethod
    def reset(self):
        ...

    @abstractmethod
    def step_async(self, actions):
        ...

    @abstractmethod
    def step_wait(self):
        ...

    def close_extras(self):
        pass

    def close(self):
        if self.closed:
            return
        self.close_extras()
        self.closed = True

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    @property
    def unwrapped(self):
        return self


def stack_obs(obs_list, observation_space) -> "OrderedDict[str, np.ndarray]":
    """Stack a list of dict observations into batched arrays with the
    space's dtypes."""
    out = OrderedDict()
    for key, space in observation_space.items():
        out[key] = np.stack(
            [np.asarray(o[key]).reshape(space.shape) for o in obs_list]
        ).astype(space.dtype)
    return out
