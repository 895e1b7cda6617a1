"""PPO rollouts with the simulator on the device (port of
var_tpu/rl/device_sim.py: the arm's DeviceSimEngine and the ai2thor grid's
GridDeviceSimEngine).

With the simulator itself on the device (envs/arm_sim_device.py,
envs/grid_sim_device.py, pixel-parity-tested against the host sims), a
whole rollout runs without a host round trip:

    reset (randomise + goal sampling from a pre-encoded goal bank)
    -> T steps: sim step -> render -> VAR image embedding
       -> dot-product reward -> return-RMS normalisation -> policy act
    -> GAE -> the batch PPO.update takes

The JAX engine's `lax.scan` is a Python loop here that writes
preallocated (T, N, ...) device tensors in place; nothing inside the loop
reads the device, so the host only queues kernels. A returned batch views
those buffers and stays valid until the next `collect`.

Goal sounds are MFCC'd once on the host, in numpy, and encoded once by
the frozen VAR's sound branch into a (taskNum, C, D) bank; an episode's
goal is a gather from it. The arm's bank holds every clip of every class;
the grid's holds 64 draws per task through the host sim's own sampler
(AudioStore.getAudioFromTask: synonyms, then the clip), encoded by the
CRNN.

Random draws come from the engine's torch.Generator on the device.
`collect` and `eval_batch` also take the draws themselves (CollectDraws,
EvalDraws), because the JAX and torch random streams differ: the tests
pass JAX's draws. Both also take `actions`, applied to the sim in place of
the policy's own: the card-against-CPU check (tools/rl_check.py) drives
the CPU engine with the card's actions, so that a pixel flip from a
last-bit difference in an action cannot compound over the steps.

Not ported yet: the env-axis mesh sharding (ROADMAP "Parallelism") and
cost_report, which waits for the port's bench and flops tools (ROADMAP
"A port bench.py").
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from var_tpu_torch.envs import arm_sim_device as sim
from var_tpu_torch.envs import grid_sim_device as gsim
from var_tpu_torch.models.distributions import (
    gumbel_noise,
    log_probs,
    mode,
    sample,
)
from var_tpu_torch.ops.gae import compute_returns


class RMSState(NamedTuple):
    """The return-RMS normaliser's state on the device (VecPretextNormalize
    twin, reference vec_pretext_normalize.py:55-59, running_mean_std.py)."""

    ret: torch.Tensor    # (N,) running discounted returns
    mean: torch.Tensor   # ()
    var: torch.Tensor    # ()
    count: torch.Tensor  # ()


def init_rms(n: int, device="cpu") -> RMSState:
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return RMSState(full((n,), 0.0), full((), 0.0), full((), 1.0),
                    full((), 1e-4))


def rms_step(rms: RMSState, raw_r, gamma: float, epsilon: float,
             cliprew: float):
    """One step of the return-RMS normaliser: parallel moments over the N
    running returns, the batch variance biased (jnp.var). Returns (rms',
    the clipped normalised reward)."""
    ret, m, v, cnt = rms
    n = ret.shape[0]
    ret = ret * gamma + raw_r
    b_mean, b_var = ret.mean(), ret.var(unbiased=False)
    delta = b_mean - m
    tot = cnt + n
    m = m + delta * n / tot
    v = (v * cnt + b_var * n + delta ** 2 * cnt * n / tot) / tot
    norm = torch.clamp(raw_r / torch.sqrt(v + epsilon), -cliprew, cliprew)
    return RMSState(ret, m, v, tot), norm


class CollectDraws(NamedTuple):
    reset: sim.ResetDraws
    intent: torch.Tensor  # (N,) int64 commanded class
    clip: torch.Tensor    # (N,) int64 goal clip within the class
    noise: torch.Tensor   # (T+1, N, A) standard-normal action noise


class EvalDraws(NamedTuple):
    reset: sim.ResetDraws
    clip: torch.Tensor                    # (N,) int64
    noise: Optional[torch.Tensor] = None  # (T, N, A); None if deterministic


class DeviceSimEngine:
    """Rollout collector whose environment is device code. `var_model` is
    the frozen VAR and `policy` the Policy, both on `device`; PPO updates
    the policy in place, so every collect acts with its newest
    parameters."""

    def __init__(self, var_model, policy, config, T: int, N: int,
                 audio=None, mesh=None,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        if getattr(config, "RLRewardSoundSound", False):
            raise NotImplementedError(
                "RLRewardSoundSound (current-sound reward term) is not "
                "supported by the device-resident sim path; use the host "
                "fused engine (rl/rollout_device.py)")
        if mesh is not None:
            raise NotImplementedError(
                "the env-axis mesh of the device sim is not ported yet "
                "(ROADMAP 'Modules left to port': parallelism)")
        self.var_model = var_model
        self.policy = policy
        self.config = config
        self.T, self.N = T, N
        self.k = sim.consts_from_config(config)
        self.D = config.representationDim
        self.hidden = policy.recurrent_hidden_state_size
        self.A = math.prod(config.RLActionDim)
        self.gamma = float(config.RLGamma)
        self.cliprew = 10.0
        self.epsilon = 1e-8
        self.device = torch.device(device)
        self.generator = generator
        self.goal_bank = self._build_goal_bank(audio)  # (taskNum, C, D)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # the rollout, written in place by collect
        self.images = zeros((T, N) + tuple(config.img_dim), torch.uint8)
        self.ees = zeros((T, N, 2))
        self.image_feats = zeros((T, N, self.D))
        self.actions = zeros((T, N, self.A))
        self.log_probs = zeros((T, N))
        self.values = zeros((T, N))
        self.rewards = zeros((T, N))
        # the policy's own actions in the last eval batch
        self.eval_actions = zeros((T, N, self.A))
        # episode == rollout (ppoNumSteps == RLEnvMaxSteps, all envs reset
        # together): 1 inside the episode, 0 at the terminal boundary, so
        # GAE does not bootstrap across the reset. The terminal done is a
        # time-limit truncation (termination is the step budget only,
        # reference fourInARow.py:390-393), so bad_masks[T] = 0 as well.
        self.masks_full = torch.cat([zeros((T, N)) + 1.0, zeros((1, N))])
        self._ones = zeros((N, 1)) + 1.0

    def _build_goal_bank(self, audio=None):
        """Every goal clip through MFCC -> sound branch -> L2 norm, once.
        Classes keep the store's dataset order (the clip index a draw makes
        points at the same clip in both packages); a class with fewer clips
        is padded by cycling."""
        from var_tpu_torch.data.audio_store import AudioStore
        from var_tpu_torch.ops.audio import mfcc_single, process_sound_feat

        cfg = self.config
        if audio is None:
            audio = AudioStore(cfg)
            audio.loadData()
        per_class = []
        for i in range(cfg.taskNum):
            feats = [process_sound_feat(mfcc_single(clip, audio.param_dict[ds]),
                                        cfg.sound_dim[1])
                     for ds, clips in audio.words[i].items() for clip in clips]
            per_class.append(np.stack(feats).astype(np.float32))
        c_max = max(len(f) for f in per_class)
        banks = [np.concatenate([f] * -(-c_max // len(f)))[:c_max]
                 for f in per_class]
        mfccs = torch.from_numpy(np.stack(banks)).to(self.device)
        with torch.no_grad():
            _, feats = self.var_model.encode_sound(
                mfccs.reshape((-1,) + mfccs.shape[2:]))
        return feats.reshape(mfccs.shape[0], mfccs.shape[1], -1)

    # -- draws ----------------------------------------------------------------

    def draw_collect(self) -> CollectDraws:
        g, N, dev = self.generator, self.N, self.device
        return CollectDraws(
            sim.draw_reset(g, N, self.k, dev),
            torch.randint(0, self.config.taskNum, (N,), generator=g,
                          device=dev),
            torch.randint(0, self.goal_bank.shape[1], (N,), generator=g,
                          device=dev),
            torch.randn((self.T + 1, N, self.A), generator=g, device=dev))

    def draw_eval(self) -> EvalDraws:
        g, N, dev = self.generator, self.N, self.device
        noise = None
        if not self.config.RLDeterministic:
            noise = torch.randn((self.T, N, self.A), generator=g, device=dev)
        return EvalDraws(
            sim.draw_reset(g, N, self.k, dev),
            torch.randint(0, self.goal_bank.shape[1], (N,), generator=g,
                          device=dev), noise)

    # -- device work -----------------------------------------------------------

    def _encode_image(self, img_u8):
        image = img_u8.to(torch.float32) * (1.0 / 255.0)
        return self.var_model.encode_image(image)[1]

    def _observe(self, obj_pose, ee):
        img = sim.render_chw(obj_pose, ee, self.k)
        return img, self._encode_image(img)

    def _act(self, ee, img, ifeat, goal_feat, hx, noise, deterministic,
             action=None):
        """The policy at one observation: (value, action, log-prob, hx).
        A given `action` is scored instead of drawn."""
        obs = {"robot_pose": ee, "goal_sound_feat": goal_feat, "image": img,
               "image_feat": ifeat}
        value, dist, new_hx = self.policy(obs, hx, self._ones, 1)
        if action is None:
            action = (mode(dist) if deterministic
                      else sample(dist, self.generator, noise))
        return value[:, 0], action, log_probs(dist, action)[:, 0], new_hx

    @torch.no_grad()
    def collect(self, rms: RMSState, draws: Optional[CollectDraws] = None,
                actions: Optional[torch.Tensor] = None):
        """One rollout (var_tpu/rl/device_sim.py _collect). Returns
        (rms', the batch for PPO.update, (N,) episode raw reward sums).
        `actions` (T, N, A), if given, are applied and stored in place of
        the policy's samples, with their log-probs."""
        cfg, k, T, D = self.config, self.k, self.T, self.D
        if draws is None:
            draws = self.draw_collect()
        obj_pose, _, ee = sim.reset_from_draws(draws.reset, k)
        goal_feat = self.goal_bank[draws.intent, draws.clip]  # (N, D)
        img, ifeat = self._observe(obj_pose, ee)
        hx = torch.zeros((self.N, self.hidden), device=self.device)
        value, action, logp, hx = self._act(
            ee, img, ifeat, goal_feat, hx, draws.noise[0], False,
            None if actions is None else actions[0])
        raw_sum = torch.zeros_like(rms.ret)
        for t in range(T):
            self.images[t].copy_(img)
            self.ees[t].copy_(ee)
            self.image_feats[t].copy_(ifeat)
            self.actions[t].copy_(action)
            self.log_probs[t].copy_(logp)
            self.values[t].copy_(value)

            ee = sim.apply_action(ee, action.to(torch.float32), k)
            img, ifeat = self._observe(obj_pose, ee)
            raw_r = torch.sum(ifeat[:, :D] * goal_feat, dim=1)
            raw_sum = raw_sum + raw_r
            rms, norm_r = rms_step(rms, raw_r, self.gamma, self.epsilon,
                                   self.cliprew)
            self.rewards[t].copy_(norm_r)

            forced = None if actions is None or t + 1 == T else actions[t + 1]
            value, action, logp, hx = self._act(
                ee, img, ifeat, goal_feat, hx, draws.noise[t + 1], False,
                forced)

        value_preds = torch.cat([self.values, value[None]])
        returns, _ = compute_returns(
            self.rewards, value_preds, self.masks_full, self.masks_full,
            value, self.gamma, float(cfg.ppoGAELambda), bool(cfg.ppoUseGAE),
            bool(cfg.RLUseProperTimeLimits))
        batch = {
            "obs": {
                "image": self.images,
                "robot_pose": self.ees,
                "image_feat": self.image_feats,
                "goal_sound_feat": goal_feat[None].expand(T, self.N, D),
            },
            "rnn_hx0": torch.zeros((self.N, self.hidden), device=self.device),
            "actions": self.actions,
            "value_preds": self.values,
            "returns": returns,
            "masks": self.masks_full[:-1],
            "old_log_probs": self.log_probs,
        }
        # the terminal reset wipes the normaliser's per-env return
        return rms._replace(ret=torch.zeros_like(rms.ret)), batch, raw_sum

    @torch.no_grad()
    def eval_batch(self, intent, draws: Optional[EvalDraws] = None,
                   actions: Optional[torch.Tensor] = None):
        """N evaluation episodes with forced commanded classes
        (var_tpu/rl/device_sim.py _eval_batch; the device twin of the host
        testRL loop, reference VAR/RL_VAR.py:35-61): deterministic acts
        when RLDeterministic, the host's success rule at the final step
        only (the ray test hits the commanded object, arm_sim._test_policy,
        reference fourInARow.py:317-335). Returns (success (N,) bool,
        goal counts (N,) i32, raw reward sums (N,)). The policy's own
        actions are kept in `eval_actions`; `actions` (T, N, A), if given,
        are applied instead of them."""
        k, D = self.k, self.D
        deterministic = bool(self.config.RLDeterministic)
        if draws is None:
            draws = self.draw_eval()
        obj_pose, obj_order, ee = sim.reset_from_draws(draws.reset, k)
        goal_feat = self.goal_bank[intent, draws.clip]
        img, ifeat = self._observe(obj_pose, ee)
        hx = torch.zeros((self.N, self.hidden), device=self.device)
        raw_sum = torch.zeros((self.N,), device=self.device)
        for t in range(self.T):
            noise = None if draws.noise is None else draws.noise[t]
            _, action, _, hx = self._act(ee, img, ifeat, goal_feat, hx,
                                         noise, deterministic)
            self.eval_actions[t].copy_(action)
            if actions is not None:
                action = actions[t]
            ee = sim.apply_action(ee, action.to(torch.float32), k)
            img, ifeat = self._observe(obj_pose, ee)
            raw_sum = raw_sum + torch.sum(ifeat[:, :D] * goal_feat, dim=1)

        hit = sim.ray_test(obj_pose, ee)  # (N,) -1 or the object's index
        hit_class = torch.gather(obj_order, 1,
                                 hit.clamp(min=0).long()[:, None])[:, 0]
        success = (hit >= 0) & (hit_class == intent)
        # the host counts goal_area only at the terminal step, so the count
        # is the success bit (threshold 1)
        return success, success.to(torch.int32), raw_sum


class GridCollectDraws(NamedTuple):
    reset: gsim.ResetDraws
    task: torch.Tensor   # (N,) int64 commanded task
    clip: torch.Tensor   # (N,) int64 goal draw within the task's bank row
    noise: torch.Tensor  # (T+1, N, A) Gumbel noise added to the logits


class GridEvalDraws(NamedTuple):
    reset: gsim.ResetDraws
    clip: torch.Tensor                    # (N,) int64
    noise: Optional[torch.Tensor] = None  # (T, N, A); None if deterministic


class GridDeviceSimEngine:
    """The grid (iTHOR-profile) navigation + toggle task as device code
    (envs/grid_sim_device.py), the arm engine's design: the policy's obs
    adds the egocentric occupancy crop and the action space is discrete
    (allActions)."""

    SAMPLES_PER_TASK = 64

    def __init__(self, var_model, policy, config, T: int, N: int,
                 audio=None, mesh=None,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        if getattr(config, "RLRewardSoundSound", False):
            raise NotImplementedError(
                "RLRewardSoundSound is not supported by the device-resident "
                "grid sim path")
        if mesh is not None:
            raise NotImplementedError(
                "the env-axis mesh of the device sim is not ported yet "
                "(ROADMAP 'Modules left to port': parallelism)")
        from var_tpu_torch.data.audio_store import Task

        self.var_model = var_model
        self.policy = policy
        self.config = config
        self.T, self.N = T, N
        self.D = config.representationDim
        self.hidden = policy.recurrent_hidden_state_size
        self.A = len(config.allActions)
        self.g = int(config.RLVisibleGrid)
        self.vis_dist = float(config.RLVisibilityDistance)
        self.gamma = float(config.RLGamma)
        self.cliprew = 10.0
        self.epsilon = 1e-8
        self.device = torch.device(device)
        self.generator = generator
        self.bank = gsim.build_plan_bank(config, self.device)
        # the task table in the host sim's taskList order (loc, obj, act)
        self.task_list = [Task(loc, obj, act) for loc in config.allTasks
                          for obj in config.allTasks[loc]
                          for act in config.allTasks[loc][obj]]
        self.task_obj = torch.tensor(
            [gsim.OBJ_NAMES.index(t.obj) for t in self.task_list],
            device=self.device)
        self.task_on = torch.tensor(
            [t.act == "ToggleObjectOn" for t in self.task_list],
            device=self.device)
        self.goal_bank = self._build_goal_bank(audio)  # (n_tasks, S, D)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # the rollout, written in place by collect
        self.images = zeros((T, N) + tuple(config.img_dim), torch.uint8)
        self.occs = zeros((T, N, 1, self.g, self.g), torch.uint8)
        self.image_feats = zeros((T, N, self.D))
        self.actions = zeros((T, N, 1), torch.int32)
        self.log_probs = zeros((T, N))
        self.values = zeros((T, N))
        self.rewards = zeros((T, N))
        self.eval_actions = zeros((T, N, 1), torch.int32)
        # one rollout is one episode: see DeviceSimEngine
        self.masks_full = torch.cat([zeros((T, N)) + 1.0, zeros((1, N))])
        self._ones = zeros((N, 1)) + 1.0

    def _build_goal_bank(self, audio=None):
        """SAMPLES_PER_TASK goal MFCCs per task, drawn on the host through
        getAudioFromTask from RandomState(RLEnvSeed + 101), as the JAX
        engine draws them, then encoded by the sound branch in batches of
        64."""
        from var_tpu_torch.data.audio_store import AudioStore

        cfg = self.config
        if audio is None:
            audio = AudioStore(cfg)
            audio.loadData()
        rng = np.random.RandomState(cfg.RLEnvSeed + 101)
        mfccs = np.stack([np.stack([
            audio.getAudioFromTask(rng, t)[0]
            for _ in range(self.SAMPLES_PER_TASK)]) for t in self.task_list
        ]).astype(np.float32)  # (n_tasks, S, 1, Tm, 40)
        flat = torch.from_numpy(mfccs.reshape((-1,) + mfccs.shape[2:]))
        with torch.no_grad():
            feats = torch.cat([
                self.var_model.encode_sound(x.to(self.device))[1]
                for x in flat.split(64)])
        return feats.reshape(mfccs.shape[0], mfccs.shape[1], -1)

    # -- draws ----------------------------------------------------------------

    def _gumbel(self, shape):
        return gumbel_noise(shape, self.generator, device=self.device)

    def draw_collect(self) -> GridCollectDraws:
        g, N, dev = self.generator, self.N, self.device
        return GridCollectDraws(
            gsim.draw_reset(g, self.bank, N, dev),
            torch.randint(0, len(self.task_list), (N,), generator=g,
                          device=dev),
            torch.randint(0, self.goal_bank.shape[1], (N,), generator=g,
                          device=dev),
            self._gumbel((self.T + 1, N, self.A)))

    def draw_eval(self) -> GridEvalDraws:
        g, N, dev = self.generator, self.N, self.device
        noise = None
        if not self.config.RLDeterministic:
            noise = self._gumbel((self.T, N, self.A))
        return GridEvalDraws(
            gsim.draw_reset(g, self.bank, N, dev),
            torch.randint(0, self.goal_bank.shape[1], (N,), generator=g,
                          device=dev), noise)

    # -- device work -----------------------------------------------------------

    def _observe(self, plan, pos, rot, tog):
        img = gsim.render_chw(self.bank, plan, pos, rot, tog)
        occ = gsim.local_occupancy(self.bank, plan, pos, rot, self.g)
        image = img.to(torch.float32) * (1.0 / 255.0)
        return img, occ, self.var_model.encode_image(image)[1]

    def _act(self, img, occ, ifeat, goal_feat, hx, noise, deterministic,
             action=None):
        """The policy at one observation: (value, action, log-prob, hx).
        A given `action` is scored instead of drawn."""
        obs = {"occupancy": occ, "goal_sound_feat": goal_feat, "image": img,
               "image_feat": ifeat}
        value, dist, new_hx = self.policy(obs, hx, self._ones, 1)
        if action is None:
            action = (mode(dist) if deterministic
                      else sample(dist, self.generator, noise))
        return value[:, 0], action, log_probs(dist, action)[:, 0], new_hx

    def _reset(self, draws, task_id):
        return gsim.reset_from_draws(self.bank, draws, task_id,
                                     self.task_obj, self.task_on)

    @torch.no_grad()
    def collect(self, rms: RMSState, draws: Optional[GridCollectDraws] = None,
                actions: Optional[torch.Tensor] = None):
        """One rollout (var_tpu/rl/device_sim.py GridDeviceSimEngine
        ._collect). Returns (rms', the batch for PPO.update, (N,) episode
        raw reward sums). `actions` (T, N, 1), if given, are applied and
        stored in place of the policy's samples, with their log-probs."""
        cfg, T, D = self.config, self.T, self.D
        if draws is None:
            draws = self.draw_collect()
        plan, pos, rot, tog = self._reset(draws.reset, draws.task)
        goal_feat = self.goal_bank[draws.task, draws.clip]  # (N, D)
        img, occ, ifeat = self._observe(plan, pos, rot, tog)
        hx = torch.zeros((self.N, self.hidden), device=self.device)
        value, action, logp, hx = self._act(
            img, occ, ifeat, goal_feat, hx, draws.noise[0], False,
            None if actions is None else actions[0])
        raw_sum = torch.zeros_like(rms.ret)
        for t in range(T):
            self.images[t].copy_(img)
            self.occs[t].copy_(occ)
            self.image_feats[t].copy_(ifeat)
            self.actions[t].copy_(action)
            self.log_probs[t].copy_(logp)
            self.values[t].copy_(value)

            pos, rot, tog = gsim.exe_action(self.bank, plan, pos, rot, tog,
                                            action, self.vis_dist)
            img, occ, ifeat = self._observe(plan, pos, rot, tog)
            raw_r = torch.sum(ifeat[:, :D] * goal_feat, dim=1)
            raw_sum = raw_sum + raw_r
            rms, norm_r = rms_step(rms, raw_r, self.gamma, self.epsilon,
                                   self.cliprew)
            self.rewards[t].copy_(norm_r)

            forced = None if actions is None or t + 1 == T else actions[t + 1]
            value, action, logp, hx = self._act(
                img, occ, ifeat, goal_feat, hx, draws.noise[t + 1], False,
                forced)

        value_preds = torch.cat([self.values, value[None]])
        returns, _ = compute_returns(
            self.rewards, value_preds, self.masks_full, self.masks_full,
            value, self.gamma, float(cfg.ppoGAELambda), bool(cfg.ppoUseGAE),
            bool(cfg.RLUseProperTimeLimits))
        batch = {
            "obs": {
                "image": self.images,
                "occupancy": self.occs,
                "image_feat": self.image_feats,
                "goal_sound_feat": goal_feat[None].expand(T, self.N, D),
            },
            "rnn_hx0": torch.zeros((self.N, self.hidden), device=self.device),
            "actions": self.actions,
            "value_preds": self.values,
            "returns": returns,
            "masks": self.masks_full[:-1],
            "old_log_probs": self.log_probs,
        }
        return rms._replace(ret=torch.zeros_like(rms.ret)), batch, raw_sum

    @torch.no_grad()
    def eval_batch(self, task_id, draws: Optional[GridEvalDraws] = None,
                   actions: Optional[torch.Tensor] = None):
        """N evaluation episodes with forced tasks (GridDeviceSimEngine
        ._eval_batch): the host's success rule, check_task_done (the
        commanded object's state matches the act) counted after every step
        and compared with success_threshold. Returns (success (N,) bool,
        goal counts (N,) i32, raw reward sums (N,)). The policy's own
        actions are kept in `eval_actions`; `actions` (T, N, 1), if given,
        are applied instead of them."""
        D = self.D
        deterministic = bool(self.config.RLDeterministic)
        if draws is None:
            draws = self.draw_eval()
        plan, pos, rot, tog = self._reset(draws.reset, task_id)
        goal_feat = self.goal_bank[task_id, draws.clip]
        obj = self.task_obj[task_id][:, None]
        want_on = self.task_on[task_id]
        img, occ, ifeat = self._observe(plan, pos, rot, tog)
        hx = torch.zeros((self.N, self.hidden), device=self.device)
        raw_sum = torch.zeros((self.N,), device=self.device)
        count = torch.zeros((self.N,), dtype=torch.int32, device=self.device)
        for t in range(self.T):
            noise = None if draws.noise is None else draws.noise[t]
            _, action, _, hx = self._act(img, occ, ifeat, goal_feat, hx,
                                         noise, deterministic)
            self.eval_actions[t].copy_(action)
            if actions is not None:
                action = actions[t]
            pos, rot, tog = gsim.exe_action(self.bank, plan, pos, rot, tog,
                                            action, self.vis_dist)
            count += (torch.gather(tog, 1, obj)[:, 0] == want_on).to(
                torch.int32)
            img, occ, ifeat = self._observe(plan, pos, rot, tog)
            raw_sum = raw_sum + torch.sum(ifeat[:, :D] * goal_feat, dim=1)
        success = count >= int(self.config.success_threshold)
        return success, count, raw_sum
