"""The fused RL step and the PPO update on the card against the same on
the CPU (chip_smoke.py phase 9; tests/test_torch_kernels.py at reduced
width).

From the same VAR and policy weights, a `config.ppoNumSteps`-step rollout
runs through a CUDA engine and a CPU engine over one host-env stream (the
card's actions drive the envs), with the same Gaussian noise, drawn on the
CPU. Each step's packed (action, raw reward) is compared, then the stored
values, log-probs and normalised rewards. The card's buffers are then
copied into the CPU engine, so that both update from the same batch: GAE
and one PPO.update with the same permutations, whose losses and
parameters are compared.

Tolerances: rtol = atol = 1e-4 for everything but the parameters (IEEE
float32 on both devices, only the order of summation differs). Parameters
after the update: within 2 * lr per optimizer step + 5e-5, with a median
difference below 1e-6, as tests/test_torch_pretext.py holds an Adam step:
Adam moves each weight by about +-lr whatever the size of its gradient, so
a near-zero gradient that rounds to the other sign differs by 2 * lr.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

TOL = 1e-4


def _err(got, want) -> float:
    """Largest |got - want| beyond rtol * |want|, in units of atol: <= 1
    means allclose(rtol=atol=TOL)."""
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return ((got - want).abs() / (TOL + TOL * want.abs())).max().item()


def card_against_cpu(config, seed: int = 0, card: str = "cuda") -> dict:
    """Runs the comparison; returns the worst errors (in units of the
    tolerance, see _err), the parameter differences and `ok`. `card` is
    the device held against the CPU (the CPU itself rehearses the check
    where there is no card)."""
    from var_tpu_torch.config import gym_register
    from var_tpu_torch.envs.vec.factory import make_vec_envs
    from var_tpu_torch.models.encoders import VARPretextNet
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine

    cfg = config
    T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
    gym_register(cfg)
    envs = make_vec_envs(cfg.RLEnvName, cfg.RLEnvSeed, N, None, True, cfg)
    var = VARPretextNet(cfg.representationDim).reset_parameters(
        torch.Generator().manual_seed(seed)).eval().requires_grad_(False)
    policy = build_policy(cfg, envs.action_space).reset_parameters(
        torch.Generator().manual_seed(seed + 1))
    sides = []  # (device, engine, ppo): the card, then the CPU
    for dev in (card, "cpu"):
        pol = copy.deepcopy(policy).to(dev)
        engine = DeviceRolloutEngine(
            copy.deepcopy(var).to(dev), pol, cfg, T, N, "robot_pose", (2,),
            torch.float32, envs.action_space.shape, torch.float32,
            gamma=cfg.RLGamma, device=dev)
        sides.append((dev, engine, PPO(pol, PPOConfig.from_config(cfg))))
    dev_engine, cpu_engine = sides[0][1], sides[1][1]
    noise_gen = torch.Generator().manual_seed(seed + 2)

    def noise():
        return torch.randn((N,) + envs.action_space.shape,
                           generator=noise_gen)

    errs = {"packed": 0.0, "values": 0.0, "log_probs": 0.0, "rewards": 0.0}
    raw_obs = envs.reset()
    eps = noise()
    action = dev_engine.init(raw_obs, eps.to(card))
    errs["packed"] = _err(cpu_engine.init(raw_obs, eps), action)
    for t in range(T):
        raw_obs, env_rew, done, infos = envs.step(action)
        bad = np.asarray([0.0 if "bad_transition" in i else 1.0
                          for i in infos], np.float32)
        eps = noise()
        action, rew = dev_engine.step(t, raw_obs, env_rew, done, bad,
                                      eps.to(card))
        c_action, c_rew = cpu_engine.step(t, raw_obs, env_rew, done, bad,
                                          eps)
        errs["packed"] = max(errs["packed"], _err(c_action, action),
                             _err(c_rew, rew))
    envs.close()
    dev_buf, host = dev_engine.buffers, cpu_engine.buffers
    for key, name in (("values", "values"), ("log_probs", "action_log_probs"),
                      ("rewards", "rewards")):
        errs[key] = _err(getattr(host, name), getattr(dev_buf, name).cpu())

    # the same batch on both sides: the card's buffers
    with torch.no_grad():
        for name, x in dev_buf.as_dict().items():
            getattr(host, name).copy_(x.cpu())
    updates = []  # (metrics, params, returns): the card, then the CPU
    perms = None
    for dev, engine, ppo in sides:
        engine.compute_returns(cfg.ppoUseGAE, cfg.RLGamma, cfg.ppoGAELambda,
                               cfg.RLUseProperTimeLimits)
        batch = engine.device_batch()
        if perms is None:
            perms = ppo.draw_perms(batch, torch.Generator(device=card)
                                   .manual_seed(seed + 3))
        state, metrics = ppo.update(ppo.init_state(), batch, perms.to(dev))
        updates.append((
            {k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu() for k, v in state.params.items()},
            engine.device_batch()["returns"].cpu()))
    (d_metrics, d_params, d_ret), (c_metrics, c_params, c_ret) = updates
    errs["returns"] = _err(c_ret, d_ret)
    errs["losses"] = max(_err(c_metrics[k], v) for k, v in d_metrics.items())
    n_opt = cfg.ppoEpoch * cfg.ppoNumMiniBatch
    atol = 2 * cfg.RLLr * n_opt + 5e-5
    diffs = torch.cat([(c_params[k] - v).abs().ravel()
                       for k, v in d_params.items()])
    report = dict(errs, param_max_diff=diffs.max().item(),
                  param_median_diff=diffs.median().item(), param_atol=atol,
                  metrics_card=d_metrics, metrics_cpu=c_metrics)
    report["ok"] = (max(errs.values()) <= 1.0
                    and report["param_max_diff"] <= atol
                    and report["param_median_diff"] < 1e-6)
    return report
