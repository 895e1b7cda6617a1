"""The RL paths on the card against the same on the CPU (chip_smoke.py
phases 9, 13, 23 and, for the ai2thor grid, 18; at bf16 phase 34;
tests/test_torch_kernels.py at reduced width), and one pretext step
(pretext_card_against_cpu, phase 34). Each check takes the profile from
its config: the arm (Gaussian actions, the gripper pose) or the ai2thor
grid (categorical actions, the occupancy crop, the CRNN VAR).

card_against_cpu (the fused path): from the same VAR and policy weights, a
`config.ppoNumSteps`-step rollout runs through a CUDA engine and a CPU
engine over one host-env stream (the card's actions drive the envs), with
the same action noise (Gaussian, or Gumbel noise on the logits), drawn on
the CPU. Each step's packed (action, raw
reward) is compared, then the stored values, log-probs and normalised
rewards. The card's buffers are then copied into the CPU engine, so that
both update from the same batch: GAE and one PPO.update with the same
permutations, whose losses and parameters are compared.

device_sim_card_against_cpu (the device sim): one `collect` and one
`eval_batch` on each side from the same weights and draws (made on the
CPU). The comparison goes from the card to the CPU: the CPU engine applies
the card's actions to its sim (the `actions` argument), as phase 9 drives
the host envs with the card's actions, so that a last-bit difference in an
action cannot flip a pixel and compound over the steps. Images and
gripper poses (arm) or occupancy crops (grid) must then be equal, and the
success bits and counts; everything else agrees within the tolerances
below. Both sides then run one PPO.update of the card's batch with the
same permutations. render_card_against_host holds the card's render
against the host sim's plain render at seeded states, every pixel (the
grid's `_render_numpy`, not its native `get_image`).

wrapped_card_against_cpu (the reward-wrapper path): see its docstring.

Tolerances: rtol = atol = 1e-4 for everything but the parameters, and
for the ai2thor CRNN's goal embeddings rtol 1e-3 / atol 2e-4 (BASELINE.md)
(IEEE float32 on both devices, only the order of summation differs: both checks
pin the precision through device.resolve_device, since cuDNN's default
TF32 convolutions alone miss 1e-4). Parameters
after the update: within 2 * lr per optimizer step + 5e-5, with a median
difference below 1e-6, as tests/test_torch_pretext.py holds an Adam step:
Adam moves each weight by about +-lr whatever the size of its gradient, so
a near-zero gradient that rounds to the other sign differs by 2 * lr.

At computeDtype='bfloat16' the conv stacks round to bf16 (unit roundoff
EPS = 2^-8) and the two devices' convolutions sum in another order, so a
sum can land on the other side of a bf16 rounding boundary, and the flips
cascade; the tolerances are tests/test_torch_bf16.py's, which states
their reasons: embeddings within EMBED_EPS = 4 EPS a component; what
derives from the VAR reward (raw and normalised rewards, returns, the
return-RMS) within 2 sqrt(representationDim) EMBED_EPS of the tensor's
largest magnitude; values, log-probs and actions within 2 EPS of it;
losses within EPS of the larger of their size and 1; parameters within
the same Adam bound, with a median difference of at most lr/10 per
optimizer step.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

TOL = 1e-4
BF16_EPS = 2.0 ** -8
EMBED_EPS = 4


def _pair(got, want):
    return (torch.as_tensor(np.asarray(got)).double(),
            torch.as_tensor(np.asarray(want)).double())


def _err(got, want) -> float:
    """Largest |got - want| beyond rtol * |want|, in units of atol: <= 1
    means allclose(rtol=atol=TOL)."""
    got, want = _pair(got, want)
    return ((got - want).abs() / (TOL + TOL * want.abs())).max().item()


def _bf16_err(got, want, steps: float = 2.0) -> float:
    """Largest |got - want| in units of `steps` bf16 EPS of want's largest
    magnitude (at least 1e-3)."""
    got, want = _pair(got, want)
    scale = max(want.abs().max().item(), 1e-3)
    return ((got - want).abs().max() / (steps * BF16_EPS * scale)).item()


def _bf16_embedding_err(got, want) -> float:
    """Largest |got - want| of unit-sphere embeddings in units of
    EMBED_EPS EPS."""
    got, want = _pair(got, want)
    return ((got - want).abs().max() / (EMBED_EPS * BF16_EPS)).item()


def _bf16_loss_err(got, want) -> float:
    """|got - want| in units of EPS of max(|want|, 1)."""
    got, want = _pair(got, want)
    return ((got - want).abs() / (BF16_EPS * want.abs().clamp(min=1.0))
            ).max().item()


def _bf16(cfg) -> bool:
    return getattr(cfg, "computeDtype", "float32") == "bfloat16"


def _errs(cfg):
    """(values, embeddings, rewards, losses) comparisons at the config's
    dtype."""
    if not _bf16(cfg):
        return _err, _err, _err, _err
    steps = 2 * cfg.representationDim ** 0.5 * EMBED_EPS
    return (_bf16_err, _bf16_embedding_err,
            lambda got, want: _bf16_err(got, want, steps), _bf16_loss_err)


def _var(cfg, seed: int):
    """The profile's VAR from `seed`, frozen."""
    from var_tpu_torch.models.encoders import build_pretext_model

    return build_pretext_model(cfg).reset_parameters(
        torch.Generator().manual_seed(seed)).eval().requires_grad_(False)


def card_against_cpu(config, seed: int = 0, card: str = "cuda") -> dict:
    """Runs the comparison; returns the worst errors (in units of the
    tolerance, see _err), the parameter differences and `ok`. `card` is
    the device held against the CPU (the CPU itself rehearses the check
    where there is no card)."""
    from var_tpu_torch.config import gym_register
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.envs.spaces import Discrete
    from var_tpu_torch.envs.vec.factory import make_vec_envs
    from var_tpu_torch.models.distributions import gumbel_noise
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine

    cfg = config
    resolve_device(card)
    T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
    gym_register(cfg)
    envs = make_vec_envs(cfg.RLEnvName, cfg.RLEnvSeed, N, None, True, cfg)
    var = _var(cfg, seed)
    policy = build_policy(cfg, envs.action_space).reset_parameters(
        torch.Generator().manual_seed(seed + 1))
    raw_obs = envs.reset()
    is_arm = cfg.name == "ArmConfig"
    extra_key = "robot_pose" if is_arm else "occupancy"
    discrete = isinstance(envs.action_space, Discrete)
    sides = []  # (device, engine, ppo): the card, then the CPU
    for dev in (card, "cpu"):
        pol = copy.deepcopy(policy).to(dev)
        engine = DeviceRolloutEngine(
            copy.deepcopy(var).to(dev), pol, cfg, T, N, extra_key,
            np.asarray(raw_obs[extra_key]).shape[1:],
            torch.float32 if is_arm else torch.uint8,
            (1,) if discrete else envs.action_space.shape,
            torch.int32 if discrete else torch.float32,
            gamma=cfg.RLGamma, device=dev)
        sides.append((dev, engine, PPO(pol, PPOConfig.from_config(cfg))))
    dev_engine, cpu_engine = sides[0][1], sides[1][1]
    noise_gen = torch.Generator().manual_seed(seed + 2)

    def noise():
        if discrete:
            return gumbel_noise((N, envs.action_space.n), noise_gen)
        return torch.randn((N,) + envs.action_space.shape,
                           generator=noise_gen)

    err, _, reward_err, _ = _errs(cfg)
    errs = {"packed": 0.0, "values": 0.0, "log_probs": 0.0, "rewards": 0.0}
    eps = noise()
    action = dev_engine.init(raw_obs, eps.to(card))
    errs["packed"] = err(cpu_engine.init(raw_obs, eps), action)
    for t in range(T):
        raw_obs, env_rew, done, infos = envs.step(action)
        bad = np.asarray([0.0 if "bad_transition" in i else 1.0
                          for i in infos], np.float32)
        eps = noise()
        action, rew = dev_engine.step(t, raw_obs, env_rew, done, bad,
                                      eps.to(card))
        c_action, c_rew = cpu_engine.step(t, raw_obs, env_rew, done, bad,
                                          eps)
        errs["packed"] = max(errs["packed"], err(c_action, action),
                             reward_err(c_rew, rew))
    envs.close()
    dev_buf, host = dev_engine.buffers, cpu_engine.buffers
    for key, name, compare in (
            ("values", "values", err),
            ("log_probs", "action_log_probs", err),
            ("rewards", "rewards", reward_err)):
        errs[key] = compare(getattr(host, name),
                            getattr(dev_buf, name).cpu())

    # the same batch on both sides: the card's buffers
    with torch.no_grad():
        for name, x in dev_buf.as_dict().items():
            getattr(host, name).copy_(x.cpu())
    batches = []
    for _, engine, _ in sides:
        engine.compute_returns(cfg.ppoUseGAE, cfg.RLGamma, cfg.ppoGAELambda,
                               cfg.RLUseProperTimeLimits)
        batches.append(engine.device_batch())
    errs["returns"] = reward_err(batches[1]["returns"],
                                 batches[0]["returns"].cpu())
    return _update_report(cfg, [(s[2], b) for s, b in zip(sides, batches)],
                          card, seed, errs)


def _update_report(cfg, sides, card, seed, errs) -> dict:
    """One PPO.update from a fresh state on each side, `sides` being
    (ppo, batch) pairs with the card's first, with the same permutations.
    Adds the worst loss error to `errs`; returns the report with `ok`."""
    updates = []  # (metrics, params): the card, then the CPU
    perms = None
    for ppo, batch in sides:
        if perms is None:
            perms = ppo.draw_perms(batch, torch.Generator(device=card)
                                   .manual_seed(seed + 3))
        state, metrics = ppo.update(ppo.init_state(), batch,
                                    perms.to(batch["returns"].device))
        updates.append((
            {k: float(v) for k, v in metrics.items()},
            {k: v.detach().cpu() for k, v in state.params.items()}))
    (d_metrics, d_params), (c_metrics, c_params) = updates
    loss_err = _errs(cfg)[3]
    errs["losses"] = max(loss_err(c_metrics[k], v)
                         for k, v in d_metrics.items())
    report = _params_report(cfg, errs, d_params, c_params, cfg.RLLr,
                            cfg.ppoEpoch * cfg.ppoNumMiniBatch)
    report.update(metrics_card=d_metrics, metrics_cpu=c_metrics)
    return report


def _params_report(cfg, errs, d_params, c_params, lr, n_opt) -> dict:
    """The report of `errs` (each <= 1 to pass) and the parameters after
    `n_opt` Adam steps at `lr` on each side, with `ok`."""
    atol = 2 * lr * n_opt + 5e-5
    median = lr / 10 * n_opt if _bf16(cfg) else 1e-6
    diffs = torch.cat([(c_params[k] - v).abs().ravel()
                       for k, v in d_params.items()])
    report = dict(errs, param_max_diff=diffs.max().item(),
                  param_median_diff=diffs.median().item(), param_atol=atol,
                  param_median_bound=median)
    report["ok"] = (max(errs.values()) <= 1.0
                    and report["param_max_diff"] <= atol
                    and report["param_median_diff"] <= median)
    return report


def _to(draws, device):
    """A draws tuple (nested NamedTuples of tensors) on `device`."""
    return type(draws)(*(
        None if x is None else
        _to(x, device) if isinstance(x, tuple) else x.to(device)
        for x in draws))


def device_sim_card_against_cpu(config, seed: int = 0, card: str = "cuda",
                                audio=None) -> dict:
    """The device-sim comparison (see the module docstring): returns the
    worst errors in units of the tolerance, the count of image pixels and
    gripper coordinates that differ, the success bits that differ, the
    parameter differences and `ok`. `audio` (an AudioStore) is shared by
    both engines when given."""
    from var_tpu_torch.data.audio_store import AudioStore
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.rl.device_sim import init_rms
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.train.rl import device_sim_profile

    cfg = config
    resolve_device(card)
    T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
    if audio is None:
        audio = AudioStore(cfg)
        audio.loadData()
    var = _var(cfg, seed)
    action_space, engine_cls = device_sim_profile(cfg)
    policy = build_policy(cfg, action_space).reset_parameters(
        torch.Generator().manual_seed(seed + 1))
    sides = []  # (engine, ppo): the card, then the CPU
    for dev in (card, "cpu"):
        pol = copy.deepcopy(policy).to(dev)
        engine = engine_cls(
            copy.deepcopy(var).to(dev), pol, cfg, T, N, audio=audio,
            generator=torch.Generator(device=dev).manual_seed(seed + 2),
            device=dev)
        sides.append((engine, PPO(pol, PPOConfig.from_config(cfg))))
    (d_eng, _), (c_eng, _) = sides
    # the goal bank: the arm's sound CNN at 1e-4, the ai2thor CRNN's
    # embeddings at their allowance (rtol 1e-3 / atol 2e-4); then the CPU
    # takes the card's bank, so that what follows compares the sim, the
    # policy and the update alone
    is_arm = cfg.name == "ArmConfig"
    err, embedding_err, reward_err, _ = _errs(cfg)
    if not (is_arm or _bf16(cfg)):
        embedding_err = _crnn_err
    errs = {"goal_bank": embedding_err(c_eng.goal_bank,
                                       d_eng.goal_bank.cpu())}
    c_eng.goal_bank = d_eng.goal_bank.cpu()

    # draws made on the CPU, the same on both sides
    draws = c_eng.draw_collect()
    d_rms, d_batch, d_raw = d_eng.collect(init_rms(N, card), _to(draws, card))
    c_rms, c_batch, c_raw = c_eng.collect(
        init_rms(N), draws, actions=d_batch["actions"].cpu())
    # the sim's state as the policy sees it: equal, not close
    exact = "robot_pose" if is_arm else "occupancy"
    mismatch = {
        "pixels": int((c_batch["obs"]["image"]
                       != d_batch["obs"]["image"].cpu()).sum()),
        "poses" if is_arm else "occupancy": int(
            (c_batch["obs"][exact] != d_batch["obs"][exact].cpu()).sum())}
    errs["image_feats"] = embedding_err(c_batch["obs"]["image_feat"],
                                        d_batch["obs"]["image_feat"].cpu())
    for key in ("value_preds", "old_log_probs"):
        errs[key] = err(c_batch[key], d_batch[key].cpu())
    errs["returns"] = reward_err(c_batch["returns"],
                                 d_batch["returns"].cpu())
    errs["rewards"] = reward_err(c_eng.rewards, d_eng.rewards.cpu())
    errs["rms"] = max(reward_err(c, d.cpu()) for c, d in zip(c_rms, d_rms))
    errs["episode_rewards"] = reward_err(c_raw, d_raw.cpu())

    intent = torch.arange(N) % cfg.taskNum
    edraws = c_eng.draw_eval()
    d_succ, d_counts, d_sum = d_eng.eval_batch(intent.to(card),
                                               _to(edraws, card))
    c_succ, c_counts, c_sum = c_eng.eval_batch(
        intent, edraws, actions=d_eng.eval_actions.cpu())
    mismatch["success"] = int((c_succ != d_succ.cpu()).sum()
                              + (c_counts != d_counts.cpu()).sum())
    errs["eval_actions"] = err(c_eng.eval_actions, d_eng.eval_actions.cpu())
    errs["eval_rewards"] = reward_err(c_sum, d_sum.cpu())

    # one update of the card's batch on both sides
    c_batch = {"obs": {k: v.cpu() for k, v in d_batch["obs"].items()},
               **{k: v.cpu() for k, v in d_batch.items() if k != "obs"}}
    report = _update_report(cfg, [(sides[0][1], d_batch),
                                  (sides[1][1], c_batch)], card, seed, errs)
    report.update(mismatch, successes=int(d_succ.sum()))
    report["ok"] = report["ok"] and not any(mismatch.values())
    return report


def _crnn_err(got, want) -> float:
    """Largest |got - want| beyond rtol 1e-3 * |want|, in units of atol
    2e-4: <= 1 means within the CRNN's allowance (rtol 1e-3 / atol
    2e-4)."""
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return ((got - want).abs() / (2e-4 + 1e-3 * want.abs())).max().item()


def render_card_against_host(config, n: int = 1000, seed: int = 0,
                             card: str = "cuda") -> dict:
    """`render_chw` on the card against the host sim's plain render at `n`
    seeded states: the count of states with any pixel that differs. Arm:
    get_image, the arm's one render. Grid: `_render_numpy`, which the
    device sim copies (its default get_image is the native raycast, which
    differs at a few boundary pixels).
    the host sim's own reset, the gripper uniform over the workspace.
    Grid: a seeded floor plan, free cell, heading and object states."""
    if config.name != "ArmConfig":
        return _grid_render_card_against_host(config, n, seed, card)
    from var_tpu_torch.envs import arm_sim_device as sim
    from var_tpu_torch.envs.arm_sim import FourInARowSim

    cfg = config
    host = FourInARowSim(cfg)
    host.seed(seed)
    rng = np.random.RandomState(seed + 1)
    poses, ees = [], []
    for _ in range(n):
        host._randomize()
        host.ee = np.array([rng.uniform(cfg.xMin, cfg.xMax),
                            rng.uniform(cfg.yMin, cfg.yMax)])
        poses.append(host.objPose.copy())
        ees.append(host.ee.copy())
    poses = np.asarray(poses, np.float32)
    ees = np.asarray(ees, np.float32)
    imgs = sim.render_chw(torch.from_numpy(poses).to(card),
                          torch.from_numpy(ees).to(card),
                          sim.consts_from_config(cfg)).cpu().numpy()
    bad = 0
    for i in range(n):
        host.objPose = poses[i].astype(np.float64)
        host.ee = ees[i].astype(np.float64)
        bad += bool((np.transpose(host.get_image(), (2, 0, 1))
                     != imgs[i]).any())
    return {"states": n, "states_differing": bad, "ok": bad == 0}


def _grid_render_card_against_host(cfg, n: int, seed: int, card: str
                                   ) -> dict:
    """Also holds local_occupancy and visible_mask against the host's
    get_local_occupancy_map and visible_objects at the same states."""
    from var_tpu_torch.envs import grid_sim_device as gsim
    from var_tpu_torch.envs.grid_sim import GridHouseSim

    bank = gsim.build_plan_bank(cfg, card)
    plans = list(cfg.allScene[next(iter(cfg.allTasks))])
    host = GridHouseSim(cfg)
    host.seed(seed)
    states, want = [], []
    for _ in range(n):
        k = int(host.np_random.randint(len(plans)))
        host.floor_plan = plans[k]
        host._build_world()
        host._domain_randomization()  # teleport, heading, object states
        states.append((k, *host.pos, int(host.rot) // 45,
                       *(host.objects[o]["isToggled"] for o in gsim.OBJ_NAMES)))
        want.append((np.transpose(host._render_numpy(), (2, 0, 1)),
                     host.get_local_occupancy_map(),
                     [o in host.visible_objects() for o in gsim.OBJ_NAMES]))
    st = torch.tensor(states, dtype=torch.int64, device=card)
    plan, pos, rot, tog = st[:, 0], st[:, 1:3], st[:, 3], st[:, 4:6].bool()
    imgs = gsim.render_chw(bank, plan, pos, rot, tog).cpu().numpy()
    occs = gsim.local_occupancy(bank, plan, pos, rot,
                                cfg.RLVisibleGrid)[:, 0].cpu().numpy()
    vis = gsim.visible_mask(bank, plan, pos, rot,
                            float(cfg.RLVisibilityDistance)).cpu().numpy()
    bad = {"states_differing": 0, "occupancy_differing": 0,
           "visibility_differing": 0}
    for i, (img, occ, v) in enumerate(want):
        bad["states_differing"] += bool((img != imgs[i]).any())
        bad["occupancy_differing"] += bool((occ != occs[i]).any())
        bad["visibility_differing"] += bool((np.asarray(v) != vis[i]).any())
    return {"states": n, **bad, "ok": not any(bad.values())}


def wrapped_card_against_cpu(config, seed: int = 0, card: str = "cuda"
                             ) -> dict:
    """The reward-wrapper path (fusedRollout=False): one
    `config.ppoNumSteps`-step rollout on the card through the wrapped host
    envs (train/rl.py rollout_wrapped) with action noise drawn on the CPU;
    then, step by step, the CPU's policy acts on the card's stored
    observation, recurrent state and masks with the same noise, and the
    CPU's VAR encodes the stored images. Actions, log-probs, values, the
    next recurrent state and the image features are compared; then both
    sides run one PPO.update of the rollout with the same permutations
    (see _update_report). Returns the report with `ok`."""
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.envs.spaces import Discrete
    from var_tpu_torch.models.distributions import gumbel_noise
    from var_tpu_torch.models.policy import act, get_value
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.train.rl import RLTrainer

    cfg = config
    resolve_device(card)
    T, N = cfg.ppoNumSteps, cfg.RLNumEnvs
    trainer = RLTrainer(cfg, device=card)
    var = _var(cfg, seed)
    trainer.pretext_model = copy.deepcopy(var).to(card)
    envs, rollouts = trainer.setup_wrapped()
    space = envs.action_space
    gen = torch.Generator().manual_seed(seed + 2)
    noise = torch.stack([
        gumbel_noise((N, space.n), gen) if isinstance(space, Discrete)
        else torch.randn((N,) + space.shape, generator=gen)
        for _ in range(T)])
    cpu_policy = copy.deepcopy(trainer.policy).to("cpu")
    trainer.rollout_wrapped(envs, rollouts, noise=noise.to(card))
    envs.close()

    err, embedding_err, _, _ = _errs(cfg)
    errs = {"actions": 0.0, "log_probs": 0.0, "values": 0.0, "hx": 0.0,
            "image_feat": 0.0}
    with torch.no_grad():
        for t in range(T):
            obs = {k: torch.from_numpy(v[t]) for k, v in
                   rollouts.obs.items()}
            out = act(cpu_policy, obs,
                      torch.from_numpy(rollouts.recurrent_hidden_states[t]),
                      torch.from_numpy(rollouts.masks[t]), noise=noise[t])
            for key, got, want in (
                    ("actions", out.action, rollouts.actions[t]),
                    ("log_probs", out.action_log_prob,
                     rollouts.action_log_probs[t]),
                    ("values", out.value, rollouts.value_preds[t]),
                    ("hx", out.rnn_hx,
                     rollouts.recurrent_hidden_states[t + 1]),
                    ("image_feat", var.encode_image(obs["image"])[1],
                     obs["image_feat"])):
                errs[key] = max(errs[key], (embedding_err if key ==
                                            "image_feat" else err)(got, want))
        next_value = get_value(
            trainer.policy,
            {k: trainer._to_device(v[-1]) for k, v in rollouts.obs.items()},
            trainer._to_device(rollouts.recurrent_hidden_states[-1]),
            trainer._to_device(rollouts.masks[-1]))
    rollouts.compute_returns(next_value.cpu().numpy(), cfg.ppoUseGAE,
                             cfg.RLGamma, cfg.ppoGAELambda,
                             cfg.RLUseProperTimeLimits)
    card_batch = rollouts.device_batch()
    rollouts.device = torch.device("cpu")
    sides = [(PPO(trainer.policy, PPOConfig.from_config(cfg)), card_batch),
             (PPO(cpu_policy, PPOConfig.from_config(cfg)),
              rollouts.device_batch())]
    return _update_report(cfg, sides, card, seed, errs)


def pretext_card_against_cpu(config, seed: int = 0, card: str = "cuda"
                             ) -> dict:
    """One pretext step (`_train_step_indexed`: the gathers, both sounds'
    MFCC through config.audioBackend, the encoders at config.computeDtype,
    the triplet loss, L2 Adam) on the card and on the CPU from the same
    initial parameters (drawn on the CPU from `seed`), clip bank, images
    and indices, at config.pretextTrainBatchSize: the loss, and the
    parameters at the Adam-step tolerance. Returns the report with `ok`."""
    from var_tpu_torch.data.audio_store import AudioStore
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.train.pretext import PretextTrainer

    cfg = config
    resolve_device(card)
    audio = AudioStore(cfg)
    audio.loadData()
    bank, lengths, ranges = audio.build_clip_bank()
    B = cfg.pretextTrainBatchSize
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B,) + tuple(cfg.img_dim)).astype(np.uint8)
    pos = audio.sample_clip_ids(rng.randint(0, len(ranges), B), ranges, rng)
    neg = audio.sample_clip_ids(rng.randint(0, len(ranges), B), ranges, rng)
    idx = [torch.from_numpy(a.astype(bool if a.dtype == bool else np.int64))
           for a in (np.arange(B), *pos, *neg)]
    sides = []  # (loss, params): the card, then the CPU
    for dev in (card, "cpu"):
        trainer = PretextTrainer(cfg, device=dev, audio=audio)
        trainer._ensure_audio()
        trainer.init_model(seed)
        trainer.setup_optimizer(steps_per_epoch=1)
        put = {"images": images, "wav": bank, "len": lengths}
        loss = trainer._train_step_indexed(
            {k: torch.from_numpy(v).to(dev) for k, v in put.items()},
            *(a.to(dev) for a in idx))
        sides.append((float(loss), {k: v.detach().cpu() for k, v in
                                    trainer.model.state_dict().items()}))
    (d_loss, d_params), (c_loss, c_params) = sides
    report = _params_report(cfg, {"loss": _errs(cfg)[3](c_loss, d_loss)},
                            d_params, c_params, cfg.pretextLR, 1)
    report.update(loss_card=d_loss, loss_cpu=c_loss)
    return report
