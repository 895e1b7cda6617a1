"""Device-resident rollout collection (port of var_tpu/rl/rollout_device.py).

The whole rollout lives in device tensors allocated once and written in
place:
- each fused step (frozen-VAR embeddings -> reward -> return-RMS
  normalisation on the device -> policy act) writes the obs, features,
  action, value, log-prob and mask slices at the current index;
- per env step the host makes ONE device->host copy: the packed (N, A+1)
  array of the action the host env needs and the raw reward for episode
  logging. Nothing else in the step reads the device;
- GAE and the PPO update read the buffers where they lie, and
  after_update copies the tail to the head.

The packed array's copy starts at dispatch (step_async): on CUDA it goes
into one of two pinned host buffers, non-blocking, with an event that
read_packed waits on. Two buffers alternate, so in the pipelined protocol
(RLPipelinedRollout: the host reads step t after dispatching step t+1) the
in-flight step's copy never lands in a buffer not yet read.

Per step the host uploads the uint8 image, the robot pose (arm) or the
uint8 occupancy crop (ai2thor; the policy scales it by 1/255), a small
packed (N, 4) array [fresh, done, bad_mask, env_reward], and, only when
some row starts an episode, the goal MFCC. The return-RMS runs in float32
on the device with the JAX engine's arithmetic: the batch variance is the
biased one (jnp.var).

Under a mesh (meshShape, parallel/mesh.py; one process per rank) the
engine runs this rank's contiguous block of the N envs, over host envs
built for those env indices only. The return-RMS takes its moments over
all N envs (rl/device_sim.py::batch_moments), and the action noise is
drawn for all N envs from generators seeded alike, this rank taking its
block, so the run draws what dp=1 draws. The JAX engine's tunnel reader
thread and cost_report have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

import numpy as np
import torch

from var_tpu_torch.models.distributions import (
    draw_noise,
    log_probs,
    mode,
    sample,
)
from var_tpu_torch.ops.gae import compute_returns
from var_tpu_torch.rl.device_sim import batch_moments


@dataclass
class DeviceRollout:
    """All-device rollout state. Leading axis T+1 for boundary tensors."""

    obs_image: torch.Tensor       # (T+1, N, 3, H, W) uint8
    obs_extra: torch.Tensor       # (T+1, N, ...) robot_pose f32 (arm) |
    #                               occupancy u8 (ai2thor)
    obs_image_feat: torch.Tensor  # (T+1, N, D)
    obs_goal_feat: torch.Tensor   # (T+1, N, D)
    rnn_hx: torch.Tensor          # (T+1, N, H)
    actions: torch.Tensor         # (T, N, A) f32 | (T, N, 1) i32
    action_log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor          # (T, N)
    rewards: torch.Tensor         # (T, N) normalised
    masks: torch.Tensor           # (T+1, N)
    bad_masks: torch.Tensor       # (T+1, N)
    # carried step state
    cached_goal: torch.Tensor     # (N, D)
    prev_value: torch.Tensor      # (N,)
    prev_log_prob: torch.Tensor   # (N,)
    prev_action: torch.Tensor     # (N, A)
    prev_hx: torch.Tensor         # (N, H) hx produced by the last act
    # return normaliser (float32)
    ret: torch.Tensor             # (N,)
    rms_mean: torch.Tensor        # ()
    rms_var: torch.Tensor         # ()
    rms_count: torch.Tensor       # ()

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class DeviceRolloutEngine:
    """Fused rollout steps over host envs. `var_model` is the frozen VAR
    (VARPretextNet) and `policy` the Policy, both on `device`; PPO updates
    the policy in place, so the engine always acts with its newest
    parameters. `generator` (on `device`) draws the action noise."""

    def __init__(self, var_model, policy, config, num_steps: int,
                 num_envs: int, extra_key: str, extra_shape, extra_dtype,
                 action_shape, action_dtype, gamma: float = 0.99,
                 cliprew: float = 10.0, epsilon: float = 1e-8,
                 deterministic: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: Any = "cpu", mesh=None):
        if extra_key not in ("robot_pose", "occupancy"):
            raise ValueError(f"unknown policy observation {extra_key!r}")
        self.var_model = var_model
        self.policy = policy
        self.config = config
        self.mesh = mesh
        # num_envs counts every rank's envs; self.N this rank's block
        self.T, self.N_global = num_steps, num_envs
        self.N = (mesh.local(num_envs, "RLNumEnvs") if mesh is not None
                  else num_envs)
        self.extra_key = extra_key
        self.gamma, self.cliprew, self.epsilon = gamma, cliprew, epsilon
        # the distribution's mode instead of a sample in every act: the
        # fused EVAL path (reference: RL.py act(deterministic=...))
        self.deterministic = bool(deterministic)
        # sound-sound reward coefficient (reference:
        # vec_pretext_normalize.py:96-101); 0 skips the current-sound encode
        self.sound_sound = float(
            getattr(config, "RLRewardSoundSound", 0.0) or 0.0)
        self.device = torch.device(device)
        self.generator = generator
        self._returns = None
        self._pinned = None  # two pinned (N, A+1) readback buffers (CUDA)
        self._slot = 0

        D = config.representationDim
        H = policy.recurrent_hidden_state_size
        T, N = num_steps, self.N
        img_dim = tuple(config.img_dim)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.buffers = DeviceRollout(
            obs_image=zeros((T + 1, N) + img_dim, torch.uint8),
            obs_extra=zeros((T + 1, N) + tuple(extra_shape), extra_dtype),
            obs_image_feat=zeros((T + 1, N, D)),
            obs_goal_feat=zeros((T + 1, N, D)),
            rnn_hx=zeros((T + 1, N, H)),
            actions=zeros((T, N) + tuple(action_shape), action_dtype),
            action_log_probs=zeros((T, N)),
            values=zeros((T, N)),
            rewards=zeros((T, N)),
            masks=zeros((T + 1, N)) + 1.0,
            bad_masks=zeros((T + 1, N)) + 1.0,
            cached_goal=zeros((N, D)),
            prev_value=zeros((N,)),
            prev_log_prob=zeros((N,)),
            prev_action=zeros((N,) + tuple(action_shape), action_dtype),
            prev_hx=zeros((N, H)),
            ret=zeros((N,)),
            rms_mean=zeros(()),
            rms_var=zeros(()) + 1.0,
            rms_count=zeros(()) + 1e-4,
        )

    # -- device work -----------------------------------------------------

    def _put(self, x, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(self.device, dtype=dtype, non_blocking=True)

    def _embed_and_act(self, image_u8, extra, goal_feat, image_feat, hx,
                       masks, noise):
        obs = {self.extra_key: extra, "goal_sound_feat": goal_feat,
               "image": image_u8, "image_feat": image_feat}
        value, dist, new_hx = self.policy(obs, hx, masks, 1)
        if self.deterministic:
            action = mode(dist)
        else:
            if noise is None and self.mesh is not None:
                noise = self.mesh.shard(
                    draw_noise(dist, self.generator, self.N_global), 0)
            action = sample(dist, self.generator, noise)
        return value[:, 0], action, log_probs(dist, action)[:, 0], new_hx

    def _encode(self, image_u8, goal_sound, fresh, use_sound: bool):
        image = image_u8.to(torch.float32) * (1.0 / 255.0)
        _, image_feat = self.var_model.encode_image(image)
        if not use_sound:
            return image_feat, self.buffers.cached_goal
        safe = torch.where(torch.isfinite(goal_sound), goal_sound,
                           torch.zeros_like(goal_sound))
        _, sound_feat = self.var_model.encode_sound(safe)
        return image_feat, torch.where(fresh[:, None], sound_feat,
                                       self.buffers.cached_goal)

    @torch.no_grad()
    def _collect_step(self, t: int, image_u8, extra, goal_sound,
                      current_sound, packed_host, use_sound: bool, noise):
        """One env transition. packed_host: (N, 4) [fresh, done, bad_mask,
        env_reward]. Writes index t (transition) and t+1 (boundary), acts
        at obs_{t+1} and returns packed_out (N, A+1) = [action, raw_reward]
        on the device."""
        b = self.buffers
        fresh = packed_host[:, 0] > 0.5
        done = packed_host[:, 1]
        bad = packed_host[:, 2]
        env_reward = packed_host[:, 3]

        image_feat, goal_feat = self._encode(image_u8, goal_sound, fresh,
                                             use_sound)
        D = self.config.representationDim
        raw_reward = torch.sum(image_feat[:, :D] * goal_feat, dim=1) + env_reward
        if self.sound_sound:
            # current_sound through the same sound branch (the reference
            # routes it through the negative slot, vec_pretext_normalize.py:90-93)
            _, cur_feat = self.var_model.encode_sound(current_sound)
            raw_reward = raw_reward + self.sound_sound * torch.sum(
                cur_feat * goal_feat, dim=1)

        # return-RMS: parallel moments over the N running returns
        ret = b.ret * self.gamma + raw_reward
        b_mean, b_var, N = batch_moments(ret, self.mesh)
        delta = b_mean - b.rms_mean
        tot = b.rms_count + N
        new_mean = b.rms_mean + delta * N / tot
        m2 = (b.rms_var * b.rms_count + b_var * N
              + delta ** 2 * b.rms_count * N / tot)
        new_var = m2 / tot
        norm_reward = torch.clamp(
            raw_reward / torch.sqrt(new_var + self.epsilon),
            -self.cliprew, self.cliprew)
        ret = torch.where(done > 0.5, torch.zeros_like(ret), ret)

        mask_next = 1.0 - done
        # act at obs_{t+1}; the hidden state is reset by the mask in the GRU
        value, action, logp, new_hx = self._embed_and_act(
            image_u8, extra, goal_feat, image_feat, b.prev_hx,
            mask_next[:, None], noise)

        # the stores of the previous act's outputs come before the carried
        # state is overwritten
        b.obs_image[t + 1].copy_(image_u8)
        b.obs_extra[t + 1].copy_(extra)
        b.obs_image_feat[t + 1].copy_(image_feat)
        b.obs_goal_feat[t + 1].copy_(goal_feat)
        b.rnn_hx[t + 1].copy_(b.prev_hx)
        b.actions[t].copy_(b.prev_action)
        b.action_log_probs[t].copy_(b.prev_log_prob)
        b.values[t].copy_(b.prev_value)
        b.rewards[t].copy_(norm_reward)
        b.masks[t + 1].copy_(mask_next)
        b.bad_masks[t + 1].copy_(bad)
        b.cached_goal.copy_(goal_feat)
        b.prev_value.copy_(value)
        b.prev_log_prob.copy_(logp)
        b.prev_action.copy_(action)
        b.prev_hx.copy_(new_hx)
        b.ret.copy_(ret)
        b.rms_mean.copy_(new_mean)
        b.rms_var.copy_(new_var)
        b.rms_count.copy_(tot)
        return torch.cat([action.to(torch.float32), raw_reward[:, None]], 1)

    @torch.no_grad()
    def _init_step(self, image_u8, extra, goal_sound, fresh, noise):
        """Reset boundary: store obs_0, act at obs_0."""
        b = self.buffers
        image_feat, goal_feat = self._encode(image_u8, goal_sound, fresh, True)
        masks0 = torch.ones((self.N, 1), device=self.device)
        value, action, logp, new_hx = self._embed_and_act(
            image_u8, extra, goal_feat, image_feat,
            torch.zeros_like(b.prev_hx), masks0, noise)
        b.obs_image[0].copy_(image_u8)
        b.obs_extra[0].copy_(extra)
        b.obs_image_feat[0].copy_(image_feat)
        b.obs_goal_feat[0].copy_(goal_feat)
        b.cached_goal.copy_(goal_feat)
        b.prev_value.copy_(value)
        b.prev_log_prob.copy_(logp)
        b.prev_action.copy_(action)
        b.prev_hx.copy_(new_hx)
        return action

    # -- host API ----------------------------------------------------------

    def _fresh(self, goal: np.ndarray) -> np.ndarray:
        return np.isfinite(goal.reshape(self.N, -1)[:, 0])

    def init(self, raw_obs, noise: Optional[torch.Tensor] = None):
        """Store obs_0 and act at it; returns the first action (host)."""
        goal = np.asarray(raw_obs["goal_sound"], np.float32)
        action = self._init_step(
            self._put(raw_obs["image"]), self._extra(raw_obs),
            self._put(goal), self._put(self._fresh(goal)), noise)
        return action.cpu().numpy()

    def step_async(self, t: int, raw_obs, env_reward, done, bad_masks,
                   noise: Optional[torch.Tensor] = None):
        """Dispatch one fused step and the copy of its packed output to the
        host; returns a handle for read_packed without waiting."""
        goal = np.asarray(raw_obs["goal_sound"], np.float32)
        fresh = self._fresh(goal)
        # a step where every row reuses its cached goal skips the sound
        # encode and the (N, 1, T, 40) upload
        use_sound = bool(fresh.any())
        packed_host = np.stack(
            [fresh.astype(np.float32), np.asarray(done, np.float32),
             np.asarray(bad_masks, np.float32).reshape(self.N),
             np.asarray(env_reward, np.float32)], axis=1)
        cur = (self._put(np.asarray(raw_obs["current_sound"], np.float32))
               if self.sound_sound else None)
        return self._readback_async(self._collect_step(
            t, self._put(raw_obs["image"]), self._extra(raw_obs),
            self._put(goal) if use_sound else None, cur,
            self._put(packed_host), use_sound, noise))

    def _readback_async(self, packed: torch.Tensor):
        """Start THE one device->host copy of a step: on CUDA into the next
        pinned buffer, with an event after it; on the CPU the tensor is
        already on the host."""
        if packed.device.type != "cuda":
            return packed
        if self._pinned is None:
            self._pinned = [torch.empty(packed.shape, dtype=packed.dtype,
                                        pin_memory=True) for _ in range(2)]
        host = self._pinned[self._slot]
        self._slot ^= 1
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def read_packed(self, handle):
        """Wait for a step's readback: (action, raw_reward) on the host."""
        if isinstance(handle, tuple):
            pinned, done = handle
            done.synchronize()
            host = pinned.numpy().copy()  # the buffer is reused in 2 steps
        else:
            host = handle.cpu().numpy()
        action = host[:, :-1]
        if self.buffers.actions.dtype == torch.int32:
            action = action.astype(np.int32)
        return action, host[:, -1]

    def step(self, t: int, raw_obs, env_reward, done, bad_masks,
             noise: Optional[torch.Tensor] = None):
        """Returns (action_next (host), raw_reward (host))."""
        return self.read_packed(
            self.step_async(t, raw_obs, env_reward, done, bad_masks, noise))

    def _extra(self, raw_obs) -> torch.Tensor:
        return self._put(raw_obs[self.extra_key], self.buffers.obs_extra.dtype)

    def set_policy_params(self, params):
        """Load a state_dict (a checkpoint's params) into the policy."""
        self.policy.load_state_dict(params)

    def device_batch(self) -> Dict[str, Any]:
        """Rollout view for PPO.update: everything already on the device."""
        b = self.buffers
        return {
            "obs": {
                "image": b.obs_image[:-1],
                self.extra_key: b.obs_extra[:-1],
                "image_feat": b.obs_image_feat[:-1],
                "goal_sound_feat": b.obs_goal_feat[:-1],
            },
            "rnn_hx0": b.rnn_hx[0],
            "actions": b.actions,
            "value_preds": b.values,
            "returns": self._returns,
            "masks": b.masks[:-1],
            "old_log_probs": b.action_log_probs,
        }

    @torch.no_grad()
    def compute_returns(self, use_gae, gamma, gae_lambda, proper):
        b = self.buffers
        value_preds = torch.cat([b.values, b.prev_value[None]], 0)
        self._returns, _ = compute_returns(
            b.rewards, value_preds, b.masks, b.bad_masks, b.prev_value,
            gamma, gae_lambda, bool(use_gae), bool(proper))

    @torch.no_grad()
    def after_update(self):
        """Tail -> head copy (reference: storage.py after_update)."""
        b = self.buffers
        for x in (b.obs_image, b.obs_extra, b.obs_image_feat,
                  b.obs_goal_feat, b.rnn_hx, b.masks, b.bad_masks):
            x[0].copy_(x[-1])
