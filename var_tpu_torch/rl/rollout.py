"""The fused rollout step with host storage (port of var_tpu/rl/rollout.py).

One device call per env step: given the raw env batch (uint8 images, the
arm's gripper pose or the grid's uint8 occupancy crop, the goal-sound
sentinel state), one function computes

    image embeddings -> goal-embedding cache select -> VAR reward
    -> processed policy obs -> value / action / log-prob -> next GRU state

and the return-RMS normalisation stays on the host (numpy,
ops/running_stats.py, as the reward wrapper). It is the middle of the three
rollout tiers that share these semantics: the wrapper (rl/reward.py), this
engine, and the device-resident engine the trainer's fusedRollout path
uses (rl/rollout_device.py), which keeps the rollout in device buffers.
No trainer path runs this engine, in either package: it is kept as the
twin of the JAX package's module, for callers that step envs themselves.

JAX's and torch's random streams differ, so a sampled step takes its draw
as `noise` (Gaussian noise for the arm, Gumbel noise on the logits for the
grid; models/distributions.py::draw_noise); without one it draws from
torch's default generator.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from var_tpu_torch.models.distributions import log_probs, mode, sample
from var_tpu_torch.ops.running_stats import ReturnNormalizer, normalize_rewards


class FusedStep(NamedTuple):
    value: torch.Tensor
    action: torch.Tensor
    action_log_prob: torch.Tensor
    rnn_hx: torch.Tensor
    image_feat: torch.Tensor
    goal_feat: torch.Tensor
    reward: torch.Tensor  # raw VAR reward (before normalisation)


class FusedRolloutEngine:
    def __init__(self, var_model, policy, config, num_envs: int,
                 device="cpu"):
        self.var_model = var_model
        self.policy = policy
        self.config = config
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.cached_goal = np.zeros(
            (num_envs, config.representationDim), np.float32)
        self.ret_norm = ReturnNormalizer.create(num_envs, config.RLGamma)
        self.is_arm = config.name == "ArmConfig"
        # the sound-sound reward coefficient (vec_pretext_normalize.py:
        # 96-101); 0 skips the current sound's encode
        self.sound_sound = float(
            getattr(config, "RLRewardSoundSound", 0.0) or 0.0)

    def _put(self, x, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            dtype=dtype)

    @torch.no_grad()
    def step(self, image_u8, goal_sound, fresh, cached_goal, extra,
             current_sound, env_reward, rnn_hx, masks, deterministic=False,
             noise=None) -> FusedStep:
        """The fused device step; `goal_sound` None when every row reuses
        its cached goal (the sound branch is then skipped)."""
        image = image_u8.to(torch.float32) * (1.0 / 255.0)
        _, image_feat = self.var_model.encode_image(image)
        if goal_sound is None:
            goal_feat = cached_goal
        else:
            safe = torch.where(torch.isfinite(goal_sound), goal_sound,
                               torch.zeros_like(goal_sound))
            _, sound_feat = self.var_model.encode_sound(safe)
            goal_feat = torch.where(fresh[:, None], sound_feat, cached_goal)
        D = self.config.representationDim
        reward = torch.sum(image_feat[:, :D] * goal_feat, dim=1) + env_reward
        if self.sound_sound:
            _, cur_feat = self.var_model.encode_sound(current_sound)
            reward = reward + self.sound_sound * torch.sum(
                cur_feat * goal_feat, dim=1)
        extra_key = "robot_pose" if self.is_arm else "occupancy"
        obs = OrderedDict([(extra_key, extra), ("goal_sound_feat", goal_feat),
                           ("image", image_u8), ("image_feat", image_feat)])
        value, dist, new_hx = self.policy(obs, rnn_hx, masks, 1)
        action = mode(dist) if deterministic else sample(dist, noise=noise)
        return FusedStep(value, action, log_probs(dist, action), new_hx,
                         image_feat, goal_feat, reward)

    def process_and_act(self, raw_obs, env_reward, news, rnn_hx, masks,
                        noise=None, deterministic=False):
        """One fused step over the raw env batch. Returns (the processed
        observation dict for storage, the normalised reward, the raw
        reward, the FusedStep)."""
        goal = np.asarray(raw_obs["goal_sound"], dtype=np.float32)
        fresh = np.isfinite(goal.reshape(self.num_envs, -1)[:, 0])
        extra_key = "robot_pose" if self.is_arm else "occupancy"
        extra = (self._put(np.asarray(raw_obs[extra_key], np.float32))
                 if self.is_arm else self._put(raw_obs[extra_key]))
        current = (self._put(np.asarray(raw_obs["current_sound"], np.float32))
                   if self.sound_sound else None)
        out = self.step(
            self._put(raw_obs["image"]),
            self._put(goal) if fresh.any() else None, self._put(fresh),
            self._put(self.cached_goal), extra, current,
            self._put(np.asarray(env_reward, np.float32)),
            rnn_hx.to(self.device), masks.to(self.device), deterministic,
            None if noise is None else noise.to(self.device))
        self.cached_goal = out.goal_feat.cpu().numpy()

        reward = out.reward.cpu().numpy()
        self.ret_norm, norm_reward = normalize_rewards(self.ret_norm, reward,
                                                       news)

        processed = OrderedDict()
        if self.is_arm:
            processed["robot_pose"] = np.asarray(raw_obs["robot_pose"],
                                                 np.float32)
        else:
            processed["occupancy"] = np.asarray(raw_obs["occupancy"])
        processed["goal_sound_feat"] = self.cached_goal.copy()
        processed["image"] = np.asarray(raw_obs["image"])
        processed["image_feat"] = out.image_feat.cpu().numpy()
        return processed, norm_reward.astype(np.float32), reward, out
