"""RL trainer: PPO outer loop, policy eval, checkpointing (port of
var_tpu/train/rl.py: the fused, device-sim and reward-wrapper paths).

- fusedRollout: host sims in a vec env -> the fused device rollout
  (frozen-VAR encode, dot reward, return normalisation, recurrent policy
  act; one packed readback per env step) -> GAE -> the PPO update on the
  rollout buffers; deterministic per-class evaluation through the same
  fused step; RLPipelinedRollout reads each step back one step late, so
  the sims' step overlaps the device's;
- RLDeviceSimRollout / RLDeviceSimEval: the sim itself on the device (the
  arm's DeviceSimEngine, the ai2thor grid's GridDeviceSimEngine,
  rl/device_sim.py), one small read per PPO update or per evaluation;
- fusedRollout=False: the reference's protocol, host sims under the
  frozen-VAR reward wrapper (rl/reward.py::VecVARReward: one VAR call per
  env step on the device, return normalisation on the host), the policy
  acting from host observations, a host RolloutStorage (rl/storage.py)
  uploaded once per PPO update; its eval steps the same wrapped envs;
- RLManualControl: one env driven by typed keys or 'dx dy' lines under
  the VAR reward wrapper, the frame written as a PNG each step;
- CSV progress, checkpoints and the success-rate CSV for all of them.

meshShape={'dp': n} trains the fused host path and both device sims on n
ranks (parallel/mesh.py; one process per rank, started by the entry point
or torchrun): each rank steps its contiguous block of the RLNumEnvs envs,
the return-RMS and the PPO update run over all of them (rl/ppo.py), and
the logs take every rank's episodes, so a dp=n run computes and writes
what dp=1 does. Only rank 0 writes checkpoints, config.json, progress.csv
and the `Updates` lines; every rank loads a resumed checkpoint. As in the
JAX package, evaluation is not sharded, and the reward-wrapper path is
not either: with meshShape set it raises.
"""
from __future__ import annotations

import csv
import os
import time
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from var_tpu_torch.config import gym_register
from var_tpu_torch.device import resolve_device
from var_tpu_torch.envs import spaces as S
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.policy import act, build_policy, get_value
from var_tpu_torch.parallel.mesh import all_gather_env, broadcast_, build_mesh
from var_tpu_torch.rl.ppo import PPO, AdamState, PPOConfig, PPOState
from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine
from var_tpu_torch.rl.storage import RolloutStorage
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from var_tpu_torch.train.pretext import PretextTrainer
from var_tpu_torch.utils.logging import CSVLogger
from var_tpu_torch.utils.profiling import PhaseTimer, RSSWatchdog


class RLTrainer:
    """Runs on CUDA unless `device` names another device; asking for CUDA
    where there is none raises."""

    def __init__(self, config, env: Optional[str] = None, device=None):
        self.config = config
        gym_register(config, env=env)
        self.device = resolve_device(device)
        self.pretextObj = PretextTrainer(config, device=self.device)
        self.pretext_model = None
        self.policy = None
        self.ppo: Optional[PPO] = None
        self.state: Optional[PPOState] = None
        # action noise and PPO permutations
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.RLEnvSeed))
        self.timer = PhaseTimer()
        self._watchdog = RSSWatchdog()
        # (env steps, seconds) of each PPO update (rollout + update) of the
        # last trainRL; each ends at the update's metrics read
        self.update_stats = []
        self.mesh = None  # set by trainRL under meshShape

    @property
    def lead(self) -> bool:
        """Whether this process writes files and prints (rank 0)."""
        return self.mesh is None or self.mesh.lead

    def _logger(self):
        """progress.csv's logger on rank 0, None on the others."""
        if not self.lead:
            return None
        return CSVLogger(os.path.join(self.config.RLModelSaveDir,
                                      "progress.csv"))

    def _save_config(self):
        cfg = self.config
        if self.lead:
            os.makedirs(cfg.RLModelSaveDir, exist_ok=True)
            cfg.save_json(os.path.join(cfg.RLModelSaveDir, "config.json"))

    # -- frozen VAR ---------------------------------------------------------

    def load_pretext(self, path: Optional[str] = None):
        """The port's pretext checkpoint (a save directory: its newest)."""
        model = self.pretextObj.loadPretextModel(path)
        self.pretext_model = model.eval().requires_grad_(False)

    # -- policy persistence (reference: RL.py:40-71,209-216) ----------------

    def save_policy(self, label):
        """<RLModelSaveDir>/<label>/checkpoint.pt: params, Adam state, step
        (rank 0 only)."""
        path = os.path.join(self.config.RLModelSaveDir, label)
        if not self.lead:
            return path
        adam = self.state.opt_state
        save_checkpoint(path, {
            "params": self.policy.state_dict(),
            "opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
            "step": self.state.step})
        return path

    def load_policy_params(self, path):
        return load_checkpoint(path)["params"]

    def load_policy_state(self, path):
        """(params, opt_state | None, step | None): the full training
        state, so a fine-tune run continues Adam's moments and the update
        counter (the reference reloads weights only, RL.py:62)."""
        restored = load_checkpoint(path)
        return (restored["params"], restored.get("opt_state"),
                restored.get("step"))

    def _resume_state(self, resume):
        params, opt_state, step = resume
        if params is not None:
            self.policy.load_state_dict(params)
        # every rank starts from rank 0's weights
        broadcast_(list(self.policy.state_dict().values()), self.mesh)
        self.state = self.ppo.init_state()
        if opt_state is None:
            return
        adam = self.state.opt_state
        if set(opt_state["mu"]) != set(adam.mu):
            raise ValueError(
                "restored optimizer state does not match this policy's "
                "parameters")
        with torch.no_grad():
            for k in adam.mu:
                adam.mu[k].copy_(opt_state["mu"][k])
                adam.nu[k].copy_(opt_state["nu"][k])
        self.state = PPOState(
            self.state.params,
            AdamState(int(opt_state["count"]), adam.mu, adam.nu),
            int(step) if step is not None else 0)

    # -- the fused rollout ----------------------------------------------------

    def _fused_envs(self, num_envs: int, first_env: int = 0):
        cfg = self.config
        return make_vec_envs(
            env_name=cfg.RLEnvName, seed=cfg.RLEnvSeed,
            num_processes=num_envs, gamma=None, randomCollect=True,
            config=cfg, first_env=first_env)

    def _fused_engine(self, envs, raw_obs, num_steps: int, num_envs: int,
                      deterministic: bool = False, mesh=None):
        cfg = self.config
        # the policy's extra observation: the arm's gripper pose, or the
        # grid's uint8 egocentric occupancy crop
        is_arm = cfg.name == "ArmConfig"
        extra_key = "robot_pose" if is_arm else "occupancy"
        if isinstance(envs.action_space, S.Discrete):
            action_shape, action_dtype = (1,), torch.int32
        else:
            action_shape, action_dtype = envs.action_space.shape, torch.float32
        return DeviceRolloutEngine(
            self.pretext_model, self.policy, cfg, num_steps, num_envs,
            extra_key, np.asarray(raw_obs[extra_key]).shape[1:],
            torch.float32 if is_arm else torch.uint8, action_shape,
            action_dtype, gamma=cfg.RLGamma,
            deterministic=deterministic, generator=self.generator,
            device=self.device, mesh=mesh)

    def _build_policy(self, action_space):
        """A fresh policy from RLEnvSeed, drawn on the CPU so every device
        starts from the same weights."""
        policy = build_policy(self.config, action_space)
        policy.reset_parameters(
            torch.Generator().manual_seed(int(self.config.RLEnvSeed)))
        self.policy = policy.to(self.device)
        return self.policy

    def setup_fused(self, init_noise: Optional[torch.Tensor] = None):
        """Everything _train_fused does before its loop: envs, policy (or
        the fine-tune checkpoint), engine, PPO state, the first action.
        `init_noise`, if given, replaces the generator's draw for it."""
        cfg = self.config
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
        # under a mesh, host envs for this rank's block of env indices,
        # seeded as dp=1 seeds them
        envs_here = (slice(0, N) if self.mesh is None
                     else self.mesh.block(N, "RLNumEnvs"))
        envs = self._fused_envs(envs_here.stop - envs_here.start,
                                envs_here.start)
        self._build_policy(envs.action_space)
        raw_obs = envs.reset()
        engine = self._fused_engine(envs, raw_obs, T, N, mesh=self.mesh)
        resume = (None, None, None)
        if cfg.RLModelFineTune and os.path.exists(cfg.RLModelLoadDir):
            if self.lead:
                print("Load the weights from", cfg.RLModelLoadDir)
            resume = self.load_policy_state(cfg.RLModelLoadDir)
        self.ppo = PPO(self.policy, PPOConfig.from_config(cfg), self.mesh)
        self._resume_state(resume)
        action = engine.init(raw_obs, init_noise)
        self.episode_rewards = deque(maxlen=10)
        self.env_rewards = np.zeros(N)
        return envs, engine, action

    def _log_rewards(self, raw_rew, done):
        self.env_rewards = self.env_rewards + raw_rew
        for index in np.where(done)[0]:
            self.episode_rewards.append(self.env_rewards[index])
            self.env_rewards[index] = 0.0

    def _log_rollout(self, steps):
        """Each step's (raw rewards, dones) into the episode log, in step
        order; under a mesh, every rank's envs (gathered once per
        rollout), so the log is dp=1's."""
        if not steps:
            return
        if self.mesh is not None:
            rew = torch.from_numpy(np.stack([r for r, _ in steps]).astype(
                np.float32)).to(self.device)
            done = torch.from_numpy(np.stack([d for _, d in steps]).astype(
                np.uint8)).to(self.device)
            rew = all_gather_env(rew, self.mesh, 1).cpu().numpy()
            done = all_gather_env(done, self.mesh, 1).cpu().numpy() > 0
            steps = list(zip(rew, done))
        for raw_rew, done in steps:
            self._log_rewards(raw_rew, done)

    def rollout(self, envs, engine, action, pipelined: bool = False,
                noise: Optional[torch.Tensor] = None):
        """T env steps through the fused engine; returns the next action.
        `noise` (T, ...), if given, replaces the generator's draws.

        pipelined (RLPipelinedRollout): the host steps the sims with the
        action of the step before the newest, so the sims' step overlaps
        the device's fused step and its readback. Step t's readback is
        read after step t+1's dispatch; the first step of the rollout
        keeps the action it was given, and the last step is drained at the
        end, so every reward is counted once and the next rollout starts
        from the freshest action. The stored rollout stays consistent
        (action_t is the policy's draw at obs_t), but the sims apply each
        action one step late, a delay the policy cannot observe."""
        pending = None  # (handle, done) of the step not yet read back
        logged = []  # (raw rewards, dones) of each step, in step order
        for step in range(engine.T):
            with self.timer.phase("env_step"):
                raw_obs, env_rew, done, infos = envs.step(action)
            done = np.array(done)
            bad_masks = np.asarray(
                [0.0 if "bad_transition" in info else 1.0 for info in infos],
                np.float32)
            with self.timer.phase("fused_step"):
                handle = engine.step_async(
                    step, raw_obs, env_rew, done, bad_masks,
                    None if noise is None else noise[step])
                if not pipelined:
                    action, raw_rew = engine.read_packed(handle)
                    logged.append((raw_rew, done))
                    continue
                if pending is not None:
                    action, raw_rew = engine.read_packed(pending[0])
                    logged.append((raw_rew, pending[1]))
                pending = (handle, done)
        if pending is not None:
            action, raw_rew = engine.read_packed(pending[0])
            logged.append((raw_rew, pending[1]))
        self._log_rollout(logged)
        return action

    def update(self, engine, perms: Optional[torch.Tensor] = None):
        """GAE, then one PPO update on the engine's buffers; returns the
        metrics as floats. `perms`, if given, replaces PPO.draw_perms."""
        cfg = self.config
        engine.compute_returns(cfg.ppoUseGAE, cfg.RLGamma, cfg.ppoGAELambda,
                               cfg.RLUseProperTimeLimits)
        with self.timer.phase("ppo_update"):
            batch = engine.device_batch()
            if perms is None:
                perms = self.ppo.draw_perms(batch, self.generator)
            self.state, metrics = self.ppo.update(self.state, batch, perms)
            # the update's one read: it waits for the device, so the phase
            # times the update's device work too
            values = torch.stack(list(metrics.values())).tolist()
        engine.after_update()
        return dict(zip(metrics, values))

    # -- training (reference: RL.py:74-227 trainRL) ---------------------------

    def trainRL(self, total_steps: Optional[int] = None,
                log_interval: Optional[int] = None):
        cfg = self.config
        self.mesh = None
        if getattr(cfg, "meshShape", None):
            if not (getattr(cfg, "RLDeviceSimRollout", False)
                    or getattr(cfg, "fusedRollout", False)):
                raise ValueError(
                    "meshShape shards the fused host path and the device "
                    "sims; the reward-wrapper path (fusedRollout=False) "
                    "runs on one device, as in the JAX package: unset "
                    "meshShape")
            self.mesh = build_mesh(cfg.meshShape, self.device)
        if getattr(cfg, "RLDeviceSimRollout", False):
            return self._train_device_sim(total_steps, log_interval)
        if not getattr(cfg, "fusedRollout", False):
            return self._train_wrapped(total_steps, log_interval)
        return self._train_fused(total_steps, log_interval)

    def setup_device_sim(self):
        """Everything _train_device_sim does before its loop: the policy
        from RLEnvSeed (or the fine-tune checkpoint), the engine, the PPO
        state. Returns the engine."""
        cfg = self.config
        if cfg.ppoNumSteps != cfg.RLEnvMaxSteps:
            raise ValueError(
                "RLDeviceSimRollout requires ppoNumSteps == RLEnvMaxSteps "
                "(one rollout == one episode, the builtin-sim alignment); "
                f"got {cfg.ppoNumSteps} != {cfg.RLEnvMaxSteps}")
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        action_space, engine_cls = device_sim_profile(self.config)
        self._build_policy(action_space)
        engine = engine_cls(
            self.pretext_model, self.policy, cfg, cfg.ppoNumSteps,
            cfg.RLNumEnvs, mesh=self.mesh, generator=self.generator,
            device=self.device)
        resume = (None, None, None)
        if cfg.RLModelFineTune and os.path.exists(cfg.RLModelLoadDir):
            if self.lead:
                print("Load the weights from", cfg.RLModelLoadDir)
            resume = self.load_policy_state(cfg.RLModelLoadDir)
        self.ppo = PPO(self.policy, PPOConfig.from_config(cfg), self.mesh)
        self._resume_state(resume)
        return engine

    def _train_device_sim(self, total_steps: Optional[int] = None,
                          log_interval: Optional[int] = None):
        """Training with the simulator on the device (rl/device_sim.py):
        reset -> T-step rollout -> GAE, then the PPO update, with no host
        round trip inside either. The host makes one small read per update,
        the episode raw rewards and the update's metrics together, at its
        end. So the `collect` phase times the rollout's dispatch only (the
        host waits inside it only when the launch queue is full), and the
        `ppo_update` phase ends at the read: it holds the rollout's device
        work that was still queued, and the update's. update_stats keeps
        (env steps, seconds) of each update, rollout included, each ending
        at that read."""
        from var_tpu_torch.rl.device_sim import init_rms

        cfg = self.config
        total_steps = int(cfg.RLTotalSteps if total_steps is None
                          else total_steps)
        log_interval = (cfg.RLLogInterval if log_interval is None
                        else log_interval)
        engine = self.setup_device_sim()
        self._save_config()
        # N counts every rank's envs; the engine runs this rank's block
        T, N = engine.T, engine.N_global
        # labels continue from the restored update counter, so a fine-tune
        # run never leaves its base's higher-numbered checkpoint as latest
        j0 = self.state.step
        rms = init_rms(engine.N, self.device)
        episode_rewards = deque(maxlen=10)
        logger = self._logger()
        start = time.time()
        num_updates = total_steps // T // N
        self.update_stats = []
        for j in range(num_updates):
            t0 = time.perf_counter()
            with self.timer.phase("collect"):
                rms, batch, ep_raw = engine.collect(rms)
                ep_raw = all_gather_env(ep_raw, self.mesh)
            with self.timer.phase("ppo_update"):
                self.state, metrics = self.ppo.update(
                    self.state, batch,
                    self.ppo.draw_perms(batch, self.generator))
                host = torch.cat([ep_raw, torch.stack(list(metrics.values()))
                                  ]).tolist()
            self.update_stats.append((T * N, time.perf_counter() - t0))
            episode_rewards.extend(host[:N])
            m = dict(zip(metrics, host[N:]))

            if (j % cfg.RLModelSaveInterval == 0 or j == num_updates - 1) \
                    and cfg.RLModelSaveDir:
                self.save_policy("%.5i" % (j0 + j))
            if j % log_interval == 0 and len(episode_rewards) > 1 \
                    and logger is not None:
                total_num_steps = (j + 1) * N * T
                fps = int(total_num_steps / (time.time() - start))
                print(
                    f"Updates {j}, num timesteps {total_num_steps}, FPS {fps}, "
                    f"eprewmean {np.mean(episode_rewards):.2f}, "
                    f"entropy {m['dist_entropy']:.3f}")
                logger.log({
                    "misc/nupdates": j,
                    "misc/total_timesteps": total_num_steps,
                    "fps": fps,
                    "eprewmean": float(np.mean(episode_rewards)),
                    "min": float(np.min(episode_rewards)),
                    "max": float(np.max(episode_rewards)),
                    "loss/policy_entropy": m["dist_entropy"],
                    "loss/policy_loss": m["action_loss"],
                    "loss/value_loss": m["value_loss"],
                    "lr": self.ppo.current_lr(self.state),
                    "perf/collect_ms": round(
                        self.timer.p50_ms("collect"), 3),
                    "perf/ppo_update_ms": round(
                        self.timer.p50_ms("ppo_update"), 3),
                    "perf/host_rss_gb": round(self._watchdog.check(), 2),
                })
        return self.state

    def _train_fused(self, total_steps: Optional[int] = None,
                     log_interval: Optional[int] = None):
        """Device-resident rollout training: the fused step writes the
        rollout into the engine's device buffers; the host reads back one
        packed (action, raw reward) array per env step, and the PPO update
        reads the buffers where they lie."""
        cfg = self.config
        total_steps = int(cfg.RLTotalSteps if total_steps is None
                          else total_steps)
        log_interval = (cfg.RLLogInterval if log_interval is None
                        else log_interval)
        self._save_config()

        envs, engine, action = self.setup_fused()
        # N counts every rank's envs; the engine runs this rank's block
        T, N = engine.T, engine.N_global
        pipelined = bool(getattr(cfg, "RLPipelinedRollout", False))
        if pipelined:
            warnings.warn(
                "RLPipelinedRollout=True trains under a one-step action "
                "delay the policy cannot observe; use the exact default "
                "for final policy training (see ROADMAP.md).")
        # labels continue from the restored update counter, so a fine-tune
        # run never leaves its base's higher-numbered checkpoint as latest
        j0 = self.state.step
        logger = self._logger()
        start = time.time()
        num_updates = total_steps // T // N
        if num_updates == 0 and self.lead:
            print(f"WARNING: RLTotalSteps={total_steps} < ppoNumSteps*"
                  f"RLNumEnvs={T * N}: no PPO updates will run")
        self.update_stats = []
        for j in range(num_updates):
            t0 = time.perf_counter()
            action = self.rollout(envs, engine, action, pipelined)
            m = self.update(engine)
            self.update_stats.append((T * N, time.perf_counter() - t0))

            if (j % cfg.RLModelSaveInterval == 0 or j == num_updates - 1) \
                    and cfg.RLModelSaveDir:
                self.save_policy("%.5i" % (j0 + j))

            episode_rewards = self.episode_rewards
            if j % log_interval == 0 and len(episode_rewards) > 1 \
                    and logger is not None:
                total_num_steps = (j + 1) * N * T
                fps = int(total_num_steps / (time.time() - start))
                print(
                    f"Updates {j}, num timesteps {total_num_steps}, FPS {fps}, "
                    f"eprewmean {np.mean(episode_rewards):.2f}, "
                    f"entropy {m['dist_entropy']:.3f}")
                logger.log({
                    "misc/nupdates": j,
                    "misc/total_timesteps": total_num_steps,
                    "fps": fps,
                    "eprewmean": float(np.mean(episode_rewards)),
                    "min": float(np.min(episode_rewards)),
                    "max": float(np.max(episode_rewards)),
                    "loss/policy_entropy": m["dist_entropy"],
                    "loss/policy_loss": m["action_loss"],
                    "loss/value_loss": m["value_loss"],
                    "lr": self.ppo.current_lr(self.state),
                    "perf/fused_step_ms": round(
                        self.timer.p50_ms("fused_step"), 3),
                    "perf/env_step_ms": round(
                        self.timer.p50_ms("env_step"), 3),
                    "perf/ppo_update_ms": round(
                        self.timer.p50_ms("ppo_update"), 3),
                    "perf/host_rss_gb": round(self._watchdog.check(), 2),
                })
        envs.close()
        return self.state

    # -- the reward-wrapper path (fusedRollout=False) ------------------------

    def _wrapped_envs(self, num_envs: int, gamma):
        cfg = self.config
        return make_vec_envs(
            env_name=cfg.RLEnvName, seed=cfg.RLEnvSeed,
            num_processes=num_envs, gamma=gamma, randomCollect=False,
            config=cfg, pretext_model=self.pretext_model, device=self.device)

    def _to_device(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def setup_wrapped(self):
        """Everything _train_wrapped does before its loop: the wrapped envs,
        the policy (or the fine-tune checkpoint), the PPO state and the
        rollout storage holding the first observation. Returns (envs,
        rollouts)."""
        cfg = self.config
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
        envs = self._wrapped_envs(N, cfg.RLGamma)
        self._build_policy(envs.action_space)
        obs = envs.reset()
        resume = (None, None, None)
        if cfg.RLModelFineTune and os.path.exists(cfg.RLModelLoadDir):
            print("Load the weights from", cfg.RLModelLoadDir)
            resume = self.load_policy_state(cfg.RLModelLoadDir)
        self.ppo = PPO(self.policy, PPOConfig.from_config(cfg))
        self._resume_state(resume)
        # the storage holds the wrapper's observation dict (RLObsIgnore
        # keys dropped)
        rollouts = RolloutStorage(
            T, N, _processed_space(obs), envs.action_space,
            self.policy.recurrent_hidden_state_size, cfg, device=self.device)
        rollouts.set_first_obs(_to_f32(obs))
        self.episode_rewards = deque(maxlen=10)
        self.env_rewards = np.zeros(N)
        return envs, rollouts

    def rollout_wrapped(self, envs, rollouts, noise=None):
        """T env steps: the policy acts on the storage's observation (one
        upload, one read a step), then the wrapped envs step and score
        them. `noise` (T, ...), if given, replaces the generator's draws
        (see distributions.sample)."""
        for step in range(rollouts.num_steps):
            with self.timer.phase("policy_act"):
                out = act(self.policy,
                          {k: self._to_device(v[step])
                           for k, v in rollouts.obs.items()},
                          self._to_device(
                              rollouts.recurrent_hidden_states[step]),
                          self._to_device(rollouts.masks[step]),
                          self.generator,
                          None if noise is None else noise[step])
                action, logp, value, hx = (
                    t.cpu().numpy() for t in (out.action, out.action_log_prob,
                                              out.value, out.rnn_hx))
            with self.timer.phase("env_step"):
                obs, reward, done, infos = envs.step(action)
            self.env_rewards = self.env_rewards + envs.origStepReward
            for index in np.where(done)[0]:
                self.episode_rewards.append(self.env_rewards[index])
                self.env_rewards[index] = 0.0
            bad_masks = np.asarray(
                [[0.0] if "bad_transition" in info else [1.0]
                 for info in infos], np.float32)
            rollouts.insert(_to_f32(obs), hx, action, logp, value, reward,
                            (~done).astype(np.float32)[:, None], bad_masks)

    def update_wrapped(self, rollouts, perms=None):
        """GAE from the value at the last observation, then one PPO update
        of the uploaded rollout; returns the metrics as floats. `perms`, if
        given, replaces PPO.draw_perms."""
        cfg = self.config
        next_value = get_value(
            self.policy,
            {k: self._to_device(v[-1]) for k, v in rollouts.obs.items()},
            self._to_device(rollouts.recurrent_hidden_states[-1]),
            self._to_device(rollouts.masks[-1]))
        rollouts.compute_returns(next_value.cpu().numpy(), cfg.ppoUseGAE,
                                 cfg.RLGamma, cfg.ppoGAELambda,
                                 cfg.RLUseProperTimeLimits)
        with self.timer.phase("ppo_update"):
            batch = rollouts.device_batch()
            if perms is None:
                perms = self.ppo.draw_perms(batch, self.generator)
            self.state, metrics = self.ppo.update(self.state, batch, perms)
            values = torch.stack(list(metrics.values())).tolist()
        rollouts.after_update()
        return dict(zip(metrics, values))

    def _train_wrapped(self, total_steps: Optional[int] = None,
                       log_interval: Optional[int] = None):
        """The reference's training protocol (var_tpu/train/rl.py
        _train_wrapped): per env step a policy act on the device from the
        host observation, the host sims, the VAR reward wrapper; per update
        the storage's upload, GAE and the PPO update."""
        cfg = self.config
        total_steps = int(cfg.RLTotalSteps if total_steps is None
                          else total_steps)
        log_interval = (cfg.RLLogInterval if log_interval is None
                        else log_interval)
        os.makedirs(cfg.RLModelSaveDir, exist_ok=True)
        cfg.save_json(os.path.join(cfg.RLModelSaveDir, "config.json"))
        envs, rollouts = self.setup_wrapped()
        T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
        j0 = self.state.step  # labels continue: see _train_device_sim
        logger = CSVLogger(os.path.join(cfg.RLModelSaveDir, "progress.csv"))
        start = time.time()
        num_updates = total_steps // T // N
        if num_updates == 0:
            print(f"WARNING: RLTotalSteps={total_steps} < ppoNumSteps*"
                  f"RLNumEnvs={T * N}: no PPO updates will run")
        self.update_stats = []
        for j in range(num_updates):
            t0 = time.perf_counter()
            self.rollout_wrapped(envs, rollouts)
            m = self.update_wrapped(rollouts)
            self.update_stats.append((T * N, time.perf_counter() - t0))

            if (j % cfg.RLModelSaveInterval == 0 or j == num_updates - 1) \
                    and cfg.RLModelSaveDir:
                self.save_policy("%.5i" % (j0 + j))
            rewards = self.episode_rewards
            if j % log_interval == 0 and len(rewards) > 1:
                total_num_steps = (j + 1) * N * T
                fps = int(total_num_steps / (time.time() - start))
                print(
                    f"Updates {j}, num timesteps {total_num_steps}, FPS {fps}\n"
                    f" Last {len(rewards)} episodes: mean/median reward "
                    f"{np.mean(rewards):.2f}/{np.median(rewards):.2f}, "
                    f"min/max {np.min(rewards):.2f}/{np.max(rewards):.2f}, "
                    f"entropy {m['dist_entropy']:.3f} vloss "
                    f"{m['value_loss']:.3f} aloss {m['action_loss']:.3f}")
                logger.log({
                    "misc/nupdates": j,
                    "misc/total_timesteps": total_num_steps,
                    "fps": fps,
                    "eprewmean": float(np.mean(rewards)),
                    "min": float(np.min(rewards)),
                    "max": float(np.max(rewards)),
                    "loss/policy_entropy": m["dist_entropy"],
                    "loss/policy_loss": m["action_loss"],
                    "loss/value_loss": m["value_loss"],
                    "lr": self.ppo.current_lr(self.state),
                    "perf/var_reward_p50_ms": round(
                        envs.timer.p50_ms("var_reward"), 3),
                    "perf/policy_act_ms": round(
                        self.timer.p50_ms("policy_act"), 3),
                    "perf/env_step_ms": round(
                        self.timer.p50_ms("env_step"), 3),
                    "perf/ppo_update_ms": round(
                        self.timer.p50_ms("ppo_update"), 3),
                    "perf/host_rss_gb": round(self._watchdog.check(), 2),
                })
        envs.close()
        return self.state

    # -- evaluation (reference: VAR/RL_VAR.py:12-76 testRL) --------------------

    def testRL(self, num_episodes: Optional[int] = None,
               policy_path: Optional[str] = None, num_envs: int = 1):
        """Deterministic per-class evaluation through the fused step.

        num_envs > 1 batches the evaluation: every env runs the same
        per-class round-robin in lockstep, so N envs complete N same-class
        episodes per cycle; totals and the CSV's objIdx column scale by N."""
        cfg = self.config
        if getattr(cfg, "RLDeviceSimEval", False):
            if getattr(cfg, "simBackend", "builtin") != "builtin":
                # the device evaluator runs the BUILTIN sim; scoring it while
                # the config asks for an external adapter would report
                # success on another simulator than configured
                raise ValueError(
                    "RLDeviceSimEval requires simBackend='builtin' "
                    f"(got {cfg.simBackend!r}); use the host testRL path "
                    "for adapter-backed environments")
            return self._test_device_sim(num_episodes, policy_path, num_envs)
        if not getattr(cfg, "fusedRollout", False):
            return self._test_wrapped(num_episodes, policy_path, num_envs)
        return self._test_fused(num_episodes, policy_path, num_envs)

    def _test_fused(self, num_episodes: Optional[int] = None,
                    policy_path: Optional[str] = None, num_envs: int = 1):
        """Raw envs + the engine in deterministic mode: per env step one
        image upload, one small packed upload and ONE readback, the step
        training uses with the distribution's mode instead of a sample."""
        cfg = self.config
        N = int(num_envs)
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        envs = self._fused_envs(N)
        path = policy_path or cfg.skillInfos[0]["path"]
        if not os.path.exists(path):
            # never score a random policy silently (the reference asserts
            # here too, RL.py:42)
            raise FileNotFoundError(
                f"policy checkpoint {path!r} does not exist")
        self._build_policy(envs.action_space)
        raw_obs = envs.reset()
        engine = self._fused_engine(envs, raw_obs, 1, N,
                                    deterministic=bool(cfg.RLDeterministic))
        engine.set_policy_params(self.load_policy_params(path))
        print("Load the weights from", path)

        size_per_class = _eval_size_per_class(cfg)
        episode_num = int(np.sum(size_per_class)) * N
        if num_episodes is not None:
            episode_num = num_episodes

        action = engine.init(raw_obs)
        results, goal_counts, ep_rewards = [], [], []
        eval_env_reward = np.zeros(N)
        episodes = 0
        while episodes < episode_num:
            raw_obs, env_rew, done, infos = envs.step(action)
            # the engine acts at the obs this step produced; the raw reward
            # is the un-normalised VAR reward
            action, raw_rew = engine.step(
                0, raw_obs, np.asarray(env_rew, np.float32),
                done.astype(np.float32), np.ones(N, np.float32))
            eval_env_reward = eval_env_reward + raw_rew
            for i in np.where(done)[0]:
                if episodes >= episode_num:
                    break
                episodes += 1
                gc = infos[i].get("goal_area_count", 0)
                goal_counts.append(gc)
                results.append(int(gc >= cfg.success_threshold))
                ep_rewards.append(eval_env_reward[i])
                eval_env_reward[i] = 0.0

        success_rate = self._finish_eval(
            path, results, goal_counts, ep_rewards, size_per_class, N)
        envs.close()
        return success_rate

    def _test_wrapped(self, num_episodes: Optional[int] = None,
                      policy_path: Optional[str] = None, num_envs: int = 1):
        """Per-class evaluation through the wrapped envs (the JAX package's
        testRL with fusedRollout=False): per env step one policy act from
        the host observation, then the envs and the VAR reward wrapper.
        The same round robin and CSV as _test_fused."""
        cfg = self.config
        N = int(num_envs)
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        path = policy_path or cfg.skillInfos[0]["path"]
        if not os.path.exists(path):
            # never score a random policy silently (RL.py:42)
            raise FileNotFoundError(
                f"policy checkpoint {path!r} does not exist")
        envs = self._wrapped_envs(N, cfg.RLGamma)
        self._build_policy(envs.action_space)
        self.policy.load_state_dict(self.load_policy_params(path))
        print("Load the weights from", path)
        # the per-class quotas: off the base env where it lives in this
        # process (DummyVecEnv), else derived from the config as the envs
        # derive them (a ShmemVecEnv's envs live in its workers)
        unwrapped = envs.unwrapped
        size_per_class = (
            np.asarray(unwrapped.envs[0].env.size_per_class)
            if hasattr(unwrapped, "envs") else _eval_size_per_class(cfg))
        episode_num = int(np.sum(size_per_class)) * N
        if num_episodes is not None:
            episode_num = num_episodes

        obs = envs.reset()
        hx = torch.zeros((N, self.policy.recurrent_hidden_state_size),
                         device=self.device)
        masks = torch.zeros((N, 1), device=self.device)
        # the eval draws' own stream, as the JAX package's PRNGKey(1)
        generator = torch.Generator(device=self.device).manual_seed(1)
        results, goal_counts, ep_rewards = [], [], []
        eval_env_reward = np.zeros(N)
        episodes = 0
        while episodes < episode_num:
            out = act(self.policy, {k: self._to_device(v)
                                    for k, v in _to_f32(obs).items()},
                      hx, masks, generator,
                      deterministic=bool(cfg.RLDeterministic))
            hx = out.rnn_hx
            obs, _, done, infos = envs.step(out.action.cpu().numpy())
            eval_env_reward = eval_env_reward + np.asarray(
                envs.origStepReward)
            masks = self._to_device((~done).astype(np.float32)[:, None])
            for i in np.where(done)[0]:
                if episodes >= episode_num:
                    break
                episodes += 1
                gc = infos[i].get("goal_area_count", 0)
                goal_counts.append(gc)
                results.append(int(gc >= cfg.success_threshold))
                ep_rewards.append(eval_env_reward[i])
                eval_env_reward[i] = 0.0

        success_rate = self._finish_eval(
            path, results, goal_counts, ep_rewards, size_per_class, N)
        envs.close()
        return success_rate

    def device_eval_engine(self, num_envs: int):
        """The device evaluator (policy net + sim engine) for batches of
        `num_envs` episodes; one engine evaluates any number of
        checkpoints (load each into self.policy)."""
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs the "
                               "frozen VAR")
        action_space, engine_cls = device_sim_profile(self.config)
        self._build_policy(action_space)
        # the eval draws' own stream, as the JAX package's PRNGKey(1)
        generator = torch.Generator(device=self.device).manual_seed(1)
        return engine_cls(
            self.pretext_model, self.policy, self.config,
            int(self.config.RLEnvMaxSteps), int(num_envs),
            generator=generator, device=self.device)

    def _test_device_sim(self, num_episodes: Optional[int] = None,
                         policy_path: Optional[str] = None,
                         num_envs: int = 1):
        """Deterministic evaluation on the device sim: one eval_batch per
        round-robin slot, all `num_envs` envs commanded the same class (the
        arm's intent, the grid's task),
        per-class quotas as the host testRL derives them; the results are
        read once, after the last batch. The CSV is
        test_<ckpt>_devicesim.csv, so host-evaluated results stay apart
        (reference VAR/RL_VAR.py:35-75)."""
        cfg = self.config
        N = int(num_envs)
        path = policy_path or cfg.skillInfos[0]["path"]
        if not os.path.exists(path):
            # never score a random policy silently (RL.py:42)
            raise FileNotFoundError(
                f"policy checkpoint {path!r} does not exist")
        engine = self.device_eval_engine(N)
        self.policy.load_state_dict(self.load_policy_params(path))
        print("Load the weights from", path)

        size_per_class = _eval_size_per_class(cfg)
        class_seq = np.repeat(np.arange(cfg.taskNum), size_per_class)
        if num_episodes is not None:
            n_batches = -(-int(num_episodes) // N)
            class_seq = np.tile(class_seq, -(-n_batches //
                                             max(1, len(class_seq))))
            class_seq = class_seq[:n_batches]

        outs = []
        for c in class_seq:
            intent = torch.full((N,), int(c), dtype=torch.int64,
                                device=self.device)
            success, counts, raw = engine.eval_batch(intent)
            outs.append(torch.stack([success.float(), counts.float(), raw]))
        results, goal_counts, ep_rewards = (
            torch.cat(outs, 1).tolist() if outs else ([], [], []))
        results = [int(r) for r in results]
        goal_counts = [int(g) for g in goal_counts]
        if num_episodes is not None:
            results = results[:num_episodes]
            goal_counts = goal_counts[:num_episodes]
            ep_rewards = ep_rewards[:num_episodes]
        return self._finish_eval(
            os.path.join(os.path.dirname(path),
                         os.path.basename(path) + "_devicesim"),
            results, goal_counts, ep_rewards, size_per_class, N)

    def _finish_eval(self, path, results, goal_counts, ep_rewards,
                     size_per_class, N):
        """Success rate and the reference CSV schema, with the commanded
        class per episode (VAR/RL_VAR.py:64-75: objIdx repeats over
        size_per_class, as the round-robin eval intents do)."""
        cfg = self.config
        success_rate = float(np.mean(results)) if results else 0.0
        if path is not None and not getattr(cfg, "render", False):
            objs = np.repeat(np.arange(cfg.taskNum, dtype=np.int64),
                             size_per_class * N)
            reps = -(-len(results) // max(1, len(objs)))
            objs = np.tile(objs, reps)[: len(results)]
            save_dir = os.path.dirname(path)
            os.makedirs(save_dir or ".", exist_ok=True)
            name = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(save_dir, f"test_{name}.csv")
            with open(out, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["objIdx", "goal area count", "rewards",
                                 "results"])
                writer.writerows(
                    [int(o), int(g), float(r), int(s)] for o, g, r, s in
                    zip(objs, goal_counts, ep_rewards, results))
            print("results saved to", out)
        print("success rate", success_rate)
        return success_rate

    # -- manual control (reference: RL.py:27-38 + keyboard teleop) -------------

    def manualControl(self, num_episodes: int = 50, input_fn=None,
                      frame_dir: Optional[str] = None):
        """Drive one env by hand, under the VAR reward wrapper.

        On a real TTY the env's keyBoardMapping keys are read as single
        raw keypresses (the reference's protocol, RL_env_VAR.py:684-692);
        piped or scripted stdin gives line commands, and the arm's
        continuous 'dx dy' actions are always whole lines. Each step writes
        the frame to <frame_dir>/manual_live.png (episodeImgSaveDir by
        default) and prints the step's raw VAR reward. An empty line
        repeats the last command; 'quit' or the end of the input stops.
        `input_fn` injects a scripted command stream."""
        from var_tpu_torch.envs.recording import write_png
        from var_tpu_torch.utils.teleop import make_input_fn

        cfg = self.config
        if self.pretext_model is None:
            raise RuntimeError("load_pretext() first: the reward needs a VAR")
        mapping = getattr(cfg, "keyBoardMapping", None)
        if input_fn is None:
            # single keys on a TTY; continuous 'dx dy' actions need lines
            input_fn = make_input_fn(
                "action> ", single_key=None if mapping is not None else False)
        frame_dir = frame_dir or cfg.episodeImgSaveDir
        os.makedirs(frame_dir, exist_ok=True)
        envs = self._wrapped_envs(1, cfg.RLGamma)
        try:
            envs.reset()
            last = None
            for _ in range(num_episodes):
                for _ in range(cfg.RLEnvMaxSteps):
                    frame = envs.render()
                    if frame is not None:
                        write_png(os.path.join(frame_dir, "manual_live.png"),
                                  np.asarray(frame))
                    try:
                        cmd = input_fn()
                    except (EOFError, StopIteration):
                        return
                    cmd = (cmd or "").strip() or last or ""
                    if cmd == "quit":
                        return
                    last = cmd
                    if mapping is not None:
                        if cmd not in mapping:
                            print(f"unknown key {cmd!r}; "
                                  f"choose from {list(mapping)}")
                            continue
                        action = np.asarray([[list(mapping).index(cmd)]],
                                            np.int32)
                    else:
                        try:
                            dx, dy = (float(v) for v in cmd.split())
                        except ValueError:
                            print("expected 'dx dy' floats")
                            continue
                        action = np.asarray([[dx, dy]], np.float32)
                    _, _, done, _ = envs.step(action)
                    print("step reward", float(envs.origStepReward[0]))
                    if done[0]:
                        break
        finally:
            envs.close()

    # -- mode dispatch (reference: RL.py:251-284 run) ---------------------------

    def run(self):
        cfg = self.config
        if cfg.RLManualControl:
            if cfg.RLManualControlLoaded:
                self.load_pretext()
            else:
                # no VAR to load: a fresh one from an explicit generator
                # (the rewards then mean nothing, but the env is drivable)
                model = self.pretextObj.init_model(seed=0)
                self.pretext_model = model.eval().requires_grad_(False)
            return self.manualControl()
        self.load_pretext()
        if cfg.RLTrain:
            return self.trainRL()
        return self.testRL()


def device_sim_profile(cfg):
    """(action space, engine class) of the profile's device sim: the arm's
    2-D Box and DeviceSimEngine, or the grid's Discrete over allActions
    and GridDeviceSimEngine."""
    from var_tpu_torch.rl.device_sim import (
        DeviceSimEngine,
        GridDeviceSimEngine,
    )

    if cfg.name == "ArmConfig":
        high = np.ones(cfg.RLActionDim, np.float32)
        return S.Box(-high, high, dtype=np.float32), DeviceSimEngine
    return S.Discrete(len(cfg.allActions)), GridDeviceSimEngine


def _eval_size_per_class(cfg):
    """Per-class eval episode quotas from the config, as the env computes
    them (arm: summed sound-source test-set sizes, fourInARow.py:92-96;
    grid: testEpisodesPerClass)."""
    if hasattr(cfg, "testEpisodesPerClass"):
        return np.full(cfg.taskNum, int(cfg.testEpisodesPerClass), np.int64)
    sizes = getattr(cfg, "soundSource", {}).get("size", None)
    if not sizes:
        raise ValueError(
            "cannot derive eval episode quotas: config has neither "
            "testEpisodesPerClass nor soundSource['size']")
    per = np.zeros(cfg.taskNum, np.int64)
    for key in sizes:
        per = per + np.asarray(sizes[key][: cfg.taskNum], np.int64)
    return per


def _processed_space(obs_batch):
    """The space of a processed observation batch (the reward wrapper
    defines the policy's observation at run time)."""
    return S.DictSpace({
        k: S.Box(-np.inf, np.inf, shape=v.shape[1:], dtype=np.float32)
        for k, v in obs_batch.items()})


def _to_f32(obs):
    return {k: np.asarray(v, dtype=np.float32) for k, v in obs.items()}
