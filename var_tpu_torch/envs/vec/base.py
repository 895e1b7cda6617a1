"""Vectorized-environment protocol (port of var_tpu/envs/vec/base.py):
batched reset / step_async / step_wait over N environments with dict
observations, and the delegating wrappers (reference:
Envs/vec_env/vec_env.py:31-190)."""
from __future__ import annotations

import contextlib
import os
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

    def get_images(self):
        """One RGB frame per environment (reference: vec_env.py:123-127)."""
        raise NotImplementedError

    def render(self, mode="human"):
        """Every env's frame tiled into one roughly square image
        (reference: vec_env.py:112-121); both modes return the array."""
        from .wrappers import tile_images

        try:
            imgs = [im for im in self.get_images() if im is not None]
        except NotImplementedError:
            return None
        return tile_images(imgs) if imgs else None

    @property
    def unwrapped(self):
        return self


class VecEnvWrapper(VecEnv):
    """Delegating wrapper (reference: vec_env.py:140-190)."""

    def __init__(self, venv, observation_space=None, action_space=None):
        self.venv = venv
        super().__init__(
            num_envs=venv.num_envs,
            observation_space=observation_space or venv.observation_space,
            action_space=action_space or venv.action_space,
        )

    def step_async(self, actions):
        self.venv.step_async(actions)

    @abstractmethod
    def reset(self):
        ...

    @abstractmethod
    def step_wait(self):
        ...

    def close(self):
        return self.venv.close()

    def render(self, mode="human"):
        return self.venv.render(mode)

    def get_images(self):
        return self.venv.get_images()

    @property
    def unwrapped(self):
        return self.venv.unwrapped

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.venv, name)


class VecEnvObservationWrapper(VecEnvWrapper):
    """A wrapper that transforms only observations, through `process()`
    (reference: vec_env.py:155-190)."""

    def process(self, obs):
        raise NotImplementedError

    def reset(self):
        return self.process(self.venv.reset())

    def step_wait(self):
        obs, rews, news, infos = self.venv.step_wait()
        return self.process(obs), rews, news, infos


def stack_obs(obs_list, observation_space) -> "OrderedDict[str, np.ndarray]":
    """Stack a list of dict observations into batched arrays with the
    space's dtypes."""
    out = OrderedDict()
    for key, space in observation_space.items():
        out[key] = np.stack(
            [np.asarray(o[key]).reshape(space.shape) for o in obs_list]
        ).astype(space.dtype)
    return out


# the thread pools a worker process would start; one worker per env, each
# with a pool as wide as the host, would oversubscribe the host's cores
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@contextlib.contextmanager
def worker_environment():
    """The environment worker processes start in: OMPI_/PMI_ variables
    stripped, so that a child that imports mpi4py does not MPI_Init itself
    as a rank and hang (reference: Envs/vec_env/vec_env.py:209-225), and
    each thread pool set to one thread. A forkserver or spawned child
    reads these at its start, before numpy or torch loads; the parent's
    own variables come back on exit."""
    saved = {k: v for k, v in os.environ.items()
             if k.startswith(("OMPI_", "PMI_")) or k in THREAD_VARS}
    for k in saved:
        del os.environ[k]
    os.environ.update({k: "1" for k in THREAD_VARS})
    try:
        yield
    finally:
        for k in THREAD_VARS:
            del os.environ[k]
        os.environ.update(saved)
