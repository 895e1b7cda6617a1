"""The checks tests/test_torch_parallel.py runs on each rank of its gloo
group, and once more in the test process without a mesh (dp=1).

Each check reads its inputs from the work directory the test writes
(weights, batches, draws, permutations), runs one sharded path of the port
and returns what the test compares: everything a rank holds for the whole
run (the rollout gathered, the metrics, the parameters). Only the port is
imported here: the ranks start under spawn and import this module alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from var_tpu_torch import config as tconfig
from var_tpu_torch.models.encoders import build_pretext_model
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.parallel.mesh import all_gather_env, build_mesh
from var_tpu_torch.rl.device_sim import init_rms
from var_tpu_torch.rl.ppo import PPO, PPOConfig
from var_tpu_torch.train.pretext import PretextTrainer
from var_tpu_torch.train.rl import RLTrainer, device_sim_profile

# the meshes of the 4-rank group: dp=4, and dp=2 replicated over 'rep'
MESHES = ({"dp": 4}, {"dp": 2, "rep": 2})
SIM_T, SIM_N = 4, 8
FUSED_T, FUSED_N = 3, 8


def overrides(profile, **extra):
    """The config knobs of `profile` at the file's reduced widths (both
    packages take them)."""
    base = dict(RLNumEnvs=SIM_N, RLEnvMaxSteps=SIM_T, ppoNumSteps=SIM_T,
                RLRecurrentSize=32, RLRecurrentInputSize=16, ppoEpoch=2,
                ppoNumMiniBatch=2, vecEnvBackend="dummy",
                audioBackend="pallas")
    if profile == "ai2thor":
        base.update(sound_dim=(1, 100, 40), pretextTrainBatchSize=4)
    else:
        base.update(pretextTrainBatchSize=8)
    return {**base, **extra}


def knobs(profile, **extra):
    """The port config of `profile` at the file's reduced widths."""
    cfg = tconfig.main_config(env=profile)
    cfg.override(**overrides(profile, **extra))
    tconfig.gym_register(cfg, env=profile)
    return cfg


def _load(work, name):
    return torch.load(os.path.join(work, name), weights_only=False)


def _var(cfg, work, profile):
    model = build_pretext_model(cfg)
    model.load_state_dict(_load(work, f"{profile}_var.pt"))
    return model.eval().requires_grad_(False)


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def pretext_steps(profile, mesh, work):
    """The pretext step over the resident bank, every step's (B,) index
    row from the work directory: arm 3 steps, ai2thor 1."""
    cfg = knobs(profile)
    tr = PretextTrainer(cfg, device="cpu")
    tr._ensure_audio()
    tr.mesh = mesh
    tr.model = build_pretext_model(cfg)
    tr.model.load_state_dict(_load(work, f"{profile}_var.pt"))
    tr.setup_optimizer(steps_per_epoch=10)
    d = np.load(os.path.join(work, f"{profile}_pretext.npz"))
    bank = {k: torch.from_numpy(d[k]) for k in ("images", "wav", "len")}
    cols = [torch.from_numpy(d[k]) for k in ("img", "pos", "pos_zero",
                                              "neg", "neg_zero")]
    losses = [tr._train_step_indexed(bank, *(c[s] for c in cols))
              for s in range(cols[0].shape[0])]
    return {"losses": torch.stack(losses), "params": _params(tr.model)}


def streaming_steps(mesh, work):
    """The arm's streaming step (host batches, each rank uploading its
    block) over the batches pretext_steps gathers from its bank."""
    from var_tpu_torch.data.triplets import TripletBatch

    cfg = knobs("arms")
    tr = PretextTrainer(cfg, device="cpu")
    tr._ensure_audio()
    tr.mesh = mesh
    tr.model = build_pretext_model(cfg)
    tr.model.load_state_dict(_load(work, "arms_var.pt"))
    tr.setup_optimizer(steps_per_epoch=10)
    d = np.load(os.path.join(work, "arms_pretext.npz"))
    losses = []
    for s, img in enumerate(d["img"]):
        pos, neg = d["pos"][s], d["neg"][s]
        batch = TripletBatch(d["images"][img], d["wav"][pos], d["len"][pos],
                             d["pos_zero"][s], d["wav"][neg], d["len"][neg],
                             d["neg_zero"][s], np.zeros(len(img), np.int32))
        dev = tr._wait_upload(*tr._device_batch(batch))
        losses.append(tr._train_step_wav(*dev, len(img)))
    return {"losses": torch.stack(losses), "params": _params(tr.model)}


def multibank_steps(mesh, work):
    """The multi-bank step over two banks that both hold the arm's clip
    bank, each row drawing from one of them in turn: the same batches as
    pretext_steps, through _train_step_multi's (B, K) columns."""
    cfg = knobs("arms")
    tr = PretextTrainer(cfg, device="cpu")
    tr._ensure_audio()
    tr.mesh = mesh
    tr.model = build_pretext_model(cfg)
    tr.model.load_state_dict(_load(work, "arms_var.pt"))
    tr.setup_optimizer(steps_per_epoch=10)
    d = np.load(os.path.join(work, "arms_pretext.npz"))
    wav, lens = torch.from_numpy(d["wav"]), torch.from_numpy(d["len"])
    bank = {"images": torch.from_numpy(d["images"]),
            "multi_params": (tr._param, tr._param),
            "multi_wav": (wav, wav), "multi_len": (lens, lens)}
    losses = []
    for s, img in enumerate(d["img"]):
        first = torch.arange(len(img)) % 2 == 0
        sel = torch.stack([first, ~first], 1)
        cols = []
        for ids, zero in (("pos", "pos_zero"), ("neg", "neg_zero")):
            i = torch.from_numpy(d[ids][s])
            cols += [torch.stack([i, i], 1), sel, torch.from_numpy(d[zero][s])]
        losses.append(tr._train_step_multi(bank, torch.from_numpy(img),
                                           *cols))
    return {"losses": torch.stack(losses), "params": _params(tr.model)}


def device_sim_cycle(profile, mesh, work):
    """One collect and one PPO update of the profile's device sim: the arm
    from explicit global draws, the grid from its generator's global
    draws."""
    from var_tpu_torch.rl.device_sim import GridDeviceSimEngine

    cfg = knobs(profile)
    space, engine_cls = device_sim_profile(cfg)
    policy = build_policy(cfg, space)
    policy.load_state_dict(_load(work, f"{profile}_policy.pt"))
    samples = GridDeviceSimEngine.SAMPLES_PER_TASK
    GridDeviceSimEngine.SAMPLES_PER_TASK = 2  # goal draws per task
    try:
        engine = engine_cls(_var(cfg, work, profile), policy, cfg, SIM_T,
                            SIM_N, mesh=mesh,
                            generator=torch.Generator().manual_seed(5))
    finally:
        GridDeviceSimEngine.SAMPLES_PER_TASK = samples
    draws = (_load(work, "arms_draws.pt") if profile == "arms" else None)
    rms, batch, ep_raw = engine.collect(init_rms(engine.N), draws)
    out = {"rms": torch.stack([rms.mean, rms.var, rms.count]),
           "ep_raw": all_gather_env(ep_raw, mesh),
           "rewards": all_gather_env(engine.rewards, mesh, 1)}
    for k in ("actions", "value_preds", "returns", "old_log_probs"):
        out[k] = all_gather_env(batch[k], mesh, 1)
    out["image"] = all_gather_env(batch["obs"]["image"], mesh, 1)
    ppo = PPO(policy, PPOConfig.from_config(cfg), mesh)
    state, metrics = ppo.update(ppo.init_state(), batch,
                                _load(work, f"{profile}_perms.pt"))
    out["metrics"] = torch.stack(list(metrics.values()))
    out["params"] = _params(policy)
    return out


def fused_cycle(mesh, work):
    """One rollout of the arm's fused host path (host envs for this rank's
    block) and its PPO update, the action noise from the trainer's
    generator, through RLTrainer's own setup, rollout and update."""
    cfg = knobs("arms", RLNumEnvs=FUSED_N, RLEnvMaxSteps=FUSED_T,
                ppoNumSteps=FUSED_T)
    tr = RLTrainer(cfg, device="cpu")
    tr.mesh = mesh
    tr.pretext_model = _var(cfg, work, "arms")
    envs, engine, action = tr.setup_fused()
    try:
        tr.rollout(envs, engine, action)
        metrics = tr.update(engine)
    finally:
        envs.close()
    b = engine.buffers
    return {"actions": all_gather_env(b.actions, mesh, 1),
            "rewards": all_gather_env(b.rewards, mesh, 1),
            "rms": torch.stack([b.rms_mean, b.rms_var, b.rms_count]),
            "episodes": torch.tensor(list(tr.episode_rewards)),
            "metrics": torch.tensor(list(metrics.values())),
            "params": _params(tr.policy)}


CHECKS = {
    "arms_pretext": lambda m, w: pretext_steps("arms", m, w),
    "ai2thor_pretext": lambda m, w: pretext_steps("ai2thor", m, w),
    "arms_stream": streaming_steps,
    "arms_multibank": multibank_steps,
    "arms_sim": lambda m, w: device_sim_cycle("arms", m, w),
    "ai2thor_sim": lambda m, w: device_sim_cycle("ai2thor", m, w),
    "fused": fused_cycle,
}


@contextlib.contextmanager
def mfcc_memo():
    """Each clip's host MFCC computed once in this process: a pure function
    of the clip and its STFT parameters, which every check's goal bank and
    host envs would compute again (a third of a rank's time)."""
    import var_tpu_torch.data.audio_store as store
    import var_tpu_torch.ops.audio as audio

    plain, memo = audio.mfcc_single, {}

    def mfcc_single(wav, params, backend="numpy"):
        a = np.asarray(wav)
        key = (a.dtype.str, a.shape, a.tobytes(), tuple(params), backend)
        if key not in memo:
            memo[key] = plain(wav, params, backend)
        return memo[key].copy()

    audio.mfcc_single = store.mfcc_single = mfcc_single
    try:
        yield
    finally:
        audio.mfcc_single = store.mfcc_single = plain


def run_checks(work, mesh):
    return {name: check(mesh, work) for name, check in CHECKS.items()}


def entry_point_args(work, out):
    """The pretext entry point's arguments for a small arm run into
    `out` (collection on rank 0, then one epoch)."""
    with open(os.path.join(work, "entry.json")) as f:
        sets = json.load(f)["pretext"]
    return ["--env", "arms", "--device", "cpu", "--set",
            f"pretextDataDir=['{out}/data']",
            f"pretextModelSaveDir='{out}/model'", *sets]


def rl_entry_point_args(work, out):
    """The RL entry point's arguments for one device-sim update of 8 envs
    into `out`, on the VAR the test wrote."""
    with open(os.path.join(work, "entry.json")) as f:
        sets = json.load(f)["rl"]
    return ["--env", "arms", "--device", "cpu", "--set",
            f"pretextModelLoadDir='{work}/rl_var'",
            f"RLModelSaveDir='{out}'", *sets]


def mark_inputs(work, written):
    """Tell the ranks the test process has written the inputs (or failed
    to)."""
    with open(os.path.join(work, "inputs.tmp"), "w") as f:
        f.write("ok" if written else "failed")
    os.replace(os.path.join(work, "inputs.tmp"),
               os.path.join(work, "inputs"))


def _wait_for_inputs(work, timeout=600.0):
    path = os.path.join(work, "inputs")
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"no inputs in {work} after {timeout} s")
        time.sleep(0.05)
    with open(path) as f:
        if f.read() != "ok":
            raise RuntimeError("the test process failed to write the inputs")


def rank_main(work, device):
    """Every check on both meshes, once the test process has written the
    inputs; then both entry points joining this group as a torchrun
    launch's ranks do (WORLD_SIZE set), at dp=4."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    _wait_for_inputs(work)
    with mfcc_memo():
        for shape in MESHES:
            mesh = build_mesh(shape, device)
            torch.save(run_checks(work, mesh),
                       os.path.join(work, f"rank{rank}_dp{mesh.dp}.pt"))
    from var_tpu_torch.pretext import main as pretext_main
    from var_tpu_torch.rl import main as rl_main

    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank))
    dp4 = ["meshShape={'dp': 4}"]
    pretext_main(entry_point_args(work, os.path.join(work, "entry_dp4"))
                 + dp4)
    rl_main(rl_entry_point_args(work, os.path.join(work, "rl_dp4")) + dp4)


def die_on_rank_1(device):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()
