"""Auxiliary vec-env wrappers (port of var_tpu/envs/vec/wrappers.py, numpy
on the host): observation and return normalisation, frame stacking, one
key of a dict observation, image tiling (reference: Envs/vec_env/
vec_normalize.py, vec_frame_stack.py, vec_extract_dict_obs.py, util.py).
None of them is on the RL main path.
"""
from __future__ import annotations

import numpy as np

from var_tpu_torch.ops.running_stats import RunningMeanStd, rms_update

from .base import VecEnvObservationWrapper, VecEnvWrapper


class VecNormalize(VecEnvWrapper):
    """Observation/return normalization for flat (non-dict) observations
    (reference: vec_normalize.py — repaired: uses our RunningMeanStd)."""

    def __init__(self, venv, ob=True, ret=True, clipob=10.0, cliprew=10.0,
                 gamma=0.99, epsilon=1e-8):
        super().__init__(venv)
        shape = self.observation_space.shape
        self.ob_rms = RunningMeanStd.create(shape) if ob else None
        self.ret_rms = RunningMeanStd.create(()) if ret else None
        self.clipob = clipob
        self.cliprew = cliprew
        self.gamma = gamma
        self.epsilon = epsilon
        self.ret = np.zeros(self.num_envs)

    def _obfilt(self, obs):
        if self.ob_rms is None:
            return obs
        self.ob_rms = rms_update(self.ob_rms, obs)
        return np.clip(
            (obs - self.ob_rms.mean) / np.sqrt(self.ob_rms.var + self.epsilon),
            -self.clipob, self.clipob)

    def step_wait(self):
        obs, rews, news, infos = self.venv.step_wait()
        self.ret = self.ret * self.gamma + rews
        obs = self._obfilt(obs)
        if self.ret_rms is not None:
            self.ret_rms = rms_update(self.ret_rms, self.ret)
            rews = np.clip(rews / np.sqrt(self.ret_rms.var + self.epsilon),
                           -self.cliprew, self.cliprew)
        self.ret[news] = 0.0
        return obs, rews, news, infos

    def reset(self):
        self.ret = np.zeros(self.num_envs)
        return self._obfilt(self.venv.reset())


class VecFrameStack(VecEnvWrapper):
    """Stack the last k frames along the channel axis
    (reference: vec_frame_stack.py)."""

    def __init__(self, venv, nstack: int):
        super().__init__(venv)
        self.nstack = nstack
        space = venv.observation_space
        low = np.repeat(space.low, nstack, axis=-1)
        high = np.repeat(space.high, nstack, axis=-1)
        self.stacked = np.zeros((venv.num_envs,) + low.shape, space.dtype)
        from var_tpu_torch.envs.spaces import Box

        self.observation_space = Box(low=low, high=high, dtype=space.dtype)

    def step_wait(self):
        obs, rews, news, infos = self.venv.step_wait()
        last = obs.shape[-1]
        self.stacked = np.roll(self.stacked, shift=-last, axis=-1)
        self.stacked[news] = 0
        self.stacked[..., -last:] = obs
        return self.stacked.copy(), rews, news, infos

    def reset(self):
        obs = self.venv.reset()
        self.stacked[...] = 0
        self.stacked[..., -obs.shape[-1]:] = obs
        return self.stacked.copy()


class VecExtractDictObs(VecEnvObservationWrapper):
    """Select one key of a dict observation space
    (reference: vec_extract_dict_obs.py, built on the
    VecEnvObservationWrapper seam exactly as the reference's is,
    vec_env.py:155-190)."""

    def __init__(self, venv, key: str):
        super().__init__(
            venv, observation_space=venv.observation_space.spaces[key])
        self.key = key

    def process(self, obs):
        return obs[self.key]


def tile_images(img_nhwc) -> np.ndarray:
    """Tile a batch of images into one roughly-square grid image
    (reference: Envs/vec_env/util.py tile_images)."""
    img_nhwc = np.asarray(img_nhwc)
    n, h, w, c = img_nhwc.shape
    H = int(np.ceil(np.sqrt(n)))
    W = int(np.ceil(n / H))
    pad = np.zeros((H * W - n, h, w, c), img_nhwc.dtype)
    img = np.concatenate([img_nhwc, pad], axis=0)
    img = img.reshape(H, W, h, w, c).transpose(0, 2, 1, 3, 4)
    return img.reshape(H * h, W * w, c)
