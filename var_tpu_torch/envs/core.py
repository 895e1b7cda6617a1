"""Environment protocol and registry.

The reference registers envs into the gym registry via cfg.gym_register
(reference: cfg.py:46-73) and drives them with the classic
reset/step/render/seed/close API. We carry the same protocol without a gym
dependency: Env is an abstract base, and a tiny registry maps string ids
("arms-RL-v2", "ai2thor-pretext-v2", ...) to constructors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


class Env:
    """Single environment protocol (host-side, numpy observations).

    Matches the reference gym.Env usage: dict observations, scalar reward,
    bool done, info dict; `seed` installs a np.random.RandomState
    (reference: Envs/ai2thor/RL_env_VAR.py:671-678).
    """

    observation_space = None
    action_space = None
    metadata: dict = {}

    # Reference env attributes used by drivers (fourInARow.py:98-100).
    episodeCounter: int = 0
    envStepCounter: int = 0

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def render(self, mode: str = "human"):
        pass

    def seed(self, seed: Optional[int] = None):
        seed = np.random.SeedSequence().entropy % (2**32) if seed is None else seed
        self.np_random = np.random.RandomState(seed)
        self.givenSeed = seed
        return [seed]

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self


_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(env_id: str, entry_point: Callable[..., Env], **default_kwargs):
    """Register a constructor under a string id (replaces gym.register)."""
    _REGISTRY[env_id] = (entry_point, default_kwargs)


def resolve(env_id: str):
    """(entry_point, default_kwargs) for an id. Resolve in the PARENT
    before shipping construction to worker processes: the registry is
    process-local runtime state, so spawn/forkserver children have an
    empty one (see vec/factory.py::make_env_thunk)."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}. Registered: {sorted(_REGISTRY)}. "
            "Call var_tpu_torch.config.gym_register(config) first."
        )
    return _REGISTRY[env_id]


def make(env_id: str, **kwargs) -> Env:
    entry_point, defaults = resolve(env_id)
    merged = {**defaults, **kwargs}
    return entry_point(**merged)


class TimeLimitMask:
    """Flags episode ends caused purely by the step budget.

    The reference wraps TimeLimit'd gym envs so PPO can distinguish true
    terminals from time-limit truncation via info['bad_transition']
    (reference: Envs/vec_env/envs.py:56-65). Our envs expose `maxSteps` and
    `envStepCounter` directly, so the check reads those counters.
    """

    def __init__(self, env: Env):
        self.env = env

    def step(self, action):
        obs, rew, done, info = self.env.step(action)
        if done and getattr(self.env, "envStepCounter", 0) >= getattr(
            self.env, "maxSteps", np.inf
        ):
            info["bad_transition"] = True
        return obs, rew, done, info

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    @property
    def unwrapped(self):
        return self.env

    def __getattr__(self, name):
        return getattr(self.env, name)
