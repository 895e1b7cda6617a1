"""The frozen-VAR reward wrapper (port of var_tpu/rl/reward.py::VecVARReward;
reference: Envs/vec_env/vec_pretext_normalize.py:8-146), the path of
fusedRollout=False.

Every env step it runs the frozen VAR over the env batch on the device and
rewrites the observation and the reward:

    reward = dot(image_feat[:, :D], goal_sound_feat)
             + RLRewardSoundSound * dot(current_sound_feat, goal_sound_feat)
             + env reward                    (vec_pretext_normalize.py:96-101)

The policy's observation dict is rebuilt per profile (arm: robot_pose,
goal_sound_feat, image, image_feat; ai2thor: occupancy, goal_sound_feat,
image, image_feat; pixels as float32 in [0, 1]), and the reward goes
through the discounted-return RMS normalisation, clipped at +-10
(ops/running_stats.py), with the raw reward kept as origStepReward.

The goal embedding is cached per env: a row whose goal_sound holds the
env's inf sentinel (every step after an episode's first) reuses
cached_goal_feat; the sound branch runs only on steps where some row is
fresh. One upload of the images (and of the fresh goal sounds) and one
read of the features per step. The fused engines (rl/rollout_device.py,
rl/device_sim.py) do the same arithmetic without the per-step round trip
and are the training paths; this one keeps the reference's protocol.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from var_tpu_torch.envs.vec.base import VecEnvWrapper
from var_tpu_torch.ops.running_stats import ReturnNormalizer, normalize_rewards
from var_tpu_torch.utils.profiling import PhaseTimer


class VecVARReward(VecEnvWrapper):
    def __init__(self, venv, model, config, ob=False, ret=True, gamma=0.99,
                 cliprew=10.0, epsilon=1e-8, device="cpu"):
        super().__init__(venv)
        self.config = config
        self.model = model
        self.device = torch.device(device)
        self.ret_norm = (
            ReturnNormalizer.create(venv.num_envs, gamma, cliprew, epsilon)
            if ret else None)
        self.origStepReward = np.zeros(venv.num_envs)
        self.cached_goal_feat = np.zeros(
            (venv.num_envs, config.representationDim), dtype=np.float32)
        self.timer = PhaseTimer()  # 'var_reward' per step
        self._rt_plot = None  # realTimeVec's live view, made at first use
        # the policy's extra observation: the arm's gripper pose, or the
        # grid's uint8 occupancy crop (scaled to [0, 1] like the image)
        self.extra_key = {"ArmConfig": "robot_pose",
                          "AI2ThorConfig": "occupancy"}[config.name]

    def _upload(self, x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, dtype=dtype)

    @torch.no_grad()
    def _get_embeddings(self, obs):
        image = self._upload(obs["image"]).to(torch.float32) * (1.0 / 255.0)
        _, image_feat = self.model.encode_image(image)
        goal = np.asarray(obs["goal_sound"])
        # the sentinel check on the host: one value per env row
        fresh = np.isfinite(goal.reshape(self.num_envs, -1)[:, 0])
        if fresh.any():
            safe = np.where(np.isfinite(goal), goal, 0.0).astype(np.float32)
            _, sound_feat = self.model.encode_sound(self._upload(safe))
            cached = self._upload(self.cached_goal_feat)
            goal_feat = torch.where(self._upload(fresh)[:, None], sound_feat,
                                    cached)
            goal_feat, image_feat = (
                t.cpu().numpy() for t in (goal_feat, image_feat))
            self.cached_goal_feat = goal_feat
        else:
            image_feat = image_feat.cpu().numpy()
            goal_feat = self.cached_goal_feat
        current_feat = 0.0
        if self.config.RLRewardSoundSound:
            _, cur = self.model.encode_sound(self._upload(
                obs["current_sound"], torch.float32))
            current_feat = cur.cpu().numpy()
        return image_feat, goal_feat, current_feat

    def _calc_reward(self, env_reward, image_feat, goal_feat, current_feat):
        D = self.config.representationDim
        img_sound = np.sum(image_feat[:, :D] * goal_feat, axis=1)
        snd_snd = (np.sum(np.asarray(current_feat) * goal_feat, axis=1)
                   if self.config.RLRewardSoundSound else 0.0)
        return (img_sound + snd_snd * self.config.RLRewardSoundSound
                + env_reward)

    def _maybe_draw_realtime(self, image_feat, goal_feat):
        """realTimeVec: env 0's image and goal embeddings as quivers on the
        unit sphere, every step (vec_pretext_normalize.py:116-119,
        138-141 drawArrows): the frame <RLModelSaveDir>/realtime_vec.png,
        rewritten atomically (utils/plotting.py, headless)."""
        if not getattr(self.config, "realTimeVec", False):
            return
        if self._rt_plot is None:
            from var_tpu_torch.utils.plotting import RealTimeEmbeddingPlot

            self._rt_plot = RealTimeEmbeddingPlot(
                None, self.config.representationDim)
        self._rt_plot.draw_arrows(image_feat, goal_feat)
        save_dir = getattr(self.config, "RLModelSaveDir", None)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._rt_plot.save(os.path.join(save_dir, "realtime_vec.png"))

    def processing_func(self, obs, env_reward):
        """(the policy's observation dict, the VAR reward) of one step."""
        image_feat, goal_feat, current_feat = self._get_embeddings(obs)
        reward = self._calc_reward(env_reward, image_feat, goal_feat,
                                   current_feat)
        self._maybe_draw_realtime(image_feat, goal_feat)
        extra = obs[self.extra_key].astype(np.float32)
        if self.extra_key == "occupancy":
            extra = extra / 255.0
        s = OrderedDict([
            (self.extra_key, extra),
            ("goal_sound_feat", goal_feat),
            ("image", obs["image"].astype(np.float32) / 255.0),
            ("image_feat", image_feat),
        ])
        return s, reward

    # -- VecEnv API -------------------------------------------------------------

    def step_wait(self):
        obs, env_rews, news, infos = self.venv.step_wait()
        with self.timer.phase("var_reward"):
            obs, rews = self.processing_func(obs, env_rews)
        self.origStepReward = np.asarray(rews).copy()
        if self.ret_norm is not None:
            self.ret_norm, rews = normalize_rewards(self.ret_norm, rews, news)
        return obs, np.asarray(rews, dtype=np.float32), news, infos

    def reset(self):
        if self.ret_norm is not None:
            self.ret_norm = self.ret_norm._replace(
                ret=np.zeros(self.num_envs))
        obs = self.venv.reset()
        obs, _ = self.processing_func(obs, np.zeros((self.num_envs,)))
        return obs
