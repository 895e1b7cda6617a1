"""Rollout storage for the reward-wrapper path (port of
var_tpu/rl/storage.py; reference: models/ppo/storage.py:13-128).

(T+1, N, ...) host numpy buffers: dict observations (keys in
config.RLObsIgnore dropped), recurrent states, rewards, value predictions,
returns, log-probs, actions, masks and bad masks, with insert and
after_update. The simulators are host-side, so the rollout fills host
arrays; compute_returns runs the GAE of ops/gae.py, and device_batch moves
the rollout to the device once per update, in the layout PPO.update takes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from var_tpu_torch.envs import spaces
from var_tpu_torch.ops.gae import compute_returns as gae_compute_returns


class RolloutStorage:
    def __init__(self, num_steps: int, num_processes: int, obs_space,
                 action_space, recurrent_hidden_state_size: int, config,
                 device="cpu"):
        self.num_steps = num_steps
        self.num_processes = num_processes
        self.config = config
        self.device = torch.device(device)

        self.obs: Dict[str, np.ndarray] = OrderedDict()
        ignore = set(getattr(config, "RLObsIgnore", ()))
        for key, space in obs_space.items():
            if key in ignore:
                continue
            self.obs[key] = np.zeros(
                (num_steps + 1, num_processes) + tuple(space.shape),
                space.dtype)

        self.recurrent_hidden_states = np.zeros(
            (num_steps + 1, num_processes, recurrent_hidden_state_size),
            np.float32)
        self.rewards = np.zeros((num_steps, num_processes, 1), np.float32)
        self.value_preds = np.zeros((num_steps + 1, num_processes, 1),
                                    np.float32)
        self.returns = np.zeros((num_steps + 1, num_processes, 1), np.float32)
        self.action_log_probs = np.zeros((num_steps, num_processes, 1),
                                         np.float32)
        if isinstance(action_space, spaces.Discrete):
            self.actions = np.zeros((num_steps, num_processes, 1), np.int32)
        else:
            self.actions = np.zeros(
                (num_steps, num_processes, action_space.shape[0]), np.float32)
        self.masks = np.ones((num_steps + 1, num_processes, 1), np.float32)
        self.bad_masks = np.ones((num_steps + 1, num_processes, 1),
                                 np.float32)
        self.step = 0

    def set_first_obs(self, obs: Dict[str, np.ndarray]):
        for key in self.obs:
            self.obs[key][0] = obs[key]

    def insert(self, obs, recurrent_hidden_states, actions, action_log_probs,
               value_preds, rewards, masks, bad_masks):
        s = self.step
        for key in self.obs:
            self.obs[key][s + 1] = obs[key]
        self.recurrent_hidden_states[s + 1] = recurrent_hidden_states
        self.actions[s] = actions
        self.action_log_probs[s] = action_log_probs
        self.value_preds[s] = value_preds
        self.rewards[s] = np.asarray(rewards).reshape(self.num_processes, 1)
        self.masks[s + 1] = masks
        self.bad_masks[s + 1] = bad_masks
        self.step = (self.step + 1) % self.num_steps

    def after_update(self):
        for key in self.obs:
            self.obs[key][0] = self.obs[key][-1]
        self.recurrent_hidden_states[0] = self.recurrent_hidden_states[-1]
        self.masks[0] = self.masks[-1]
        self.bad_masks[0] = self.bad_masks[-1]

    def compute_returns(self, next_value, use_gae, gamma, gae_lambda,
                        use_proper_time_limits=False):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        returns, value_preds = gae_compute_returns(
            t(self.rewards[..., 0]), t(self.value_preds[..., 0]),
            t(self.masks[..., 0]), t(self.bad_masks[..., 0]),
            t(np.asarray(next_value, np.float32).reshape(-1)),
            gamma, gae_lambda, use_gae, use_proper_time_limits)
        self.returns[:-1] = returns.numpy()[..., None]
        self.value_preds[-1] = value_preds.numpy()[-1][..., None]

    def device_batch(self):
        """The rollout as PPO.update's batch, on the device (one upload per
        update)."""
        def d(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return {
            "obs": {k: d(v[:-1]) for k, v in self.obs.items()},
            "rnn_hx0": d(self.recurrent_hidden_states[0]),
            "actions": d(self.actions),
            "value_preds": d(self.value_preds[:-1, :, 0]),
            "returns": d(self.returns[:-1, :, 0]),
            "masks": d(self.masks[:-1, :, 0]),
            "old_log_probs": d(self.action_log_probs[:, :, 0]),
        }
