"""Deterministic FakeEnv for testing the vec/RL stack without simulators
(port of var_tpu/envs/fake.py).

A pure-numpy env with the arm's observation schema, fully determined by
(seed, step count): the cheap env of the vec-env tests.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from var_tpu_torch.envs import spaces
from var_tpu_torch.envs.core import Env


class FakeArmEnv(Env):
    """Arm-schema observations; reward = -|action|; done at maxSteps."""

    def __init__(self, config=None, max_steps: int = 5, sound_dim=(1, 100, 40),
                 rep_dim: int = 3, **_):
        self.maxSteps = max_steps
        self.sound_dim = sound_dim
        self.rep_dim = rep_dim
        d = OrderedDict(
            [
                ("image", spaces.Box(0, 255, shape=(3, 96, 96), dtype=np.uint8)),
                ("goal_sound", spaces.Box(-np.inf, np.inf, shape=sound_dim)),
                ("current_sound", spaces.Box(-np.inf, np.inf, shape=sound_dim)),
                ("robot_pose", spaces.Box(-np.inf, np.inf, shape=(2,))),
                ("goal_sound_label", spaces.Box(0, 5, shape=(1,), dtype=np.int32)),
                ("goal_sound_feat", spaces.Box(-np.inf, np.inf, shape=(rep_dim,))),
                ("image_feat", spaces.Box(-np.inf, np.inf, shape=(rep_dim,))),
            ]
        )
        self.observation_space = spaces.DictSpace(d)
        self.action_space = spaces.Box(low=-np.ones(2), high=np.ones(2))
        self.np_random = np.random.RandomState(0)
        self.envStepCounter = 0
        self.episodeCounter = -1

    def _obs(self):
        r = np.random.RandomState(self.envStepCounter + 1000 * self.givenSeed)
        return OrderedDict(
            [
                ("image", (r.rand(3, 96, 96) * 255).astype(np.uint8)),
                ("goal_sound", r.randn(*self.sound_dim).astype(np.float32)),
                ("current_sound", r.randn(*self.sound_dim).astype(np.float32)),
                ("robot_pose", r.randn(2).astype(np.float32)),
                ("goal_sound_label", np.asarray([self.envStepCounter % 5], np.int32)),
                ("goal_sound_feat", np.zeros(self.rep_dim, np.float32)),
                ("image_feat", np.zeros(self.rep_dim, np.float32)),
            ]
        )

    def seed(self, seed=None):
        self.givenSeed = 0 if seed is None else seed
        self.np_random = np.random.RandomState(self.givenSeed)
        return [self.givenSeed]

    def reset(self):
        if not hasattr(self, "givenSeed"):
            self.seed(0)
        self.episodeCounter += 1
        self.envStepCounter = 0
        return self._obs()

    def step(self, action):
        self.envStepCounter += 1
        reward = -float(np.abs(np.asarray(action)).sum())
        done = self.envStepCounter >= self.maxSteps
        return self._obs(), reward, done, {}

    def render(self, mode="human"):
        # deterministic HWC frame keyed on (seed, step) so vec-env
        # get_images/tiling tests can check per-env frames end up in
        # the right tile
        frame = np.full((8, 8, 3), self.givenSeed % 256, np.uint8)
        frame[0, 0, 0] = self.envStepCounter % 256
        return frame
