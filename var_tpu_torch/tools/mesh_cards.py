"""meshShape across cards: the port's counterpart of the JAX package's
__graft_entry__.py::dryrun_multichip, in one call over every visible card
(rank r on cuda:r, NCCL).

    python -m var_tpu_torch.tools.mesh_cards OUT [--dp N] [--repeats 3]
        [--device cpu] [--width small]

(a) Correctness. The checks below run at dp=1 (no mesh) on the first
device, then on N ranks twice: through the entry points' own spawn
(cli.py::sharded_main, as `python -m var_tpu_torch.pretext|rl --set
'meshShape={"dp": N}'` starts its ranks) and under `torchrun
--nproc_per_node N` (this module as the launched program). At N = 4 every
check runs on {'dp': 4} and on {'dp': 2, 'rep': 2} (two dp lines on
sub-groups). The checks, at the profiles' full width:
- arm pretext through audioBackend='pallas' at batch 128: 3 steps on the
  resident bank, the streaming step (each rank uploading its block of the
  host batch) and the multi-bank step (two banks holding the same clips);
  ai2thor pretext (the CRNN, sound 1x600x40): one step at batch 128;
- the arm's fused host cycle (8 envs x 100 steps, 8 / N envs a rank) and
  its PPO update, with the envs in-process and again as each rank's
  shared-memory workers (envs/vec/shmem.py, the rank's own forkserver);
- each device sim's collect and PPO update at 64 envs;
- every rank's first mel-log-DCT input (32 rows a rank at N = 4) through
  the kernel against its plain version.
Each is held to dp=1 at tests/test_torch_parallel.py's tolerances (the
port's 1e-4; the CRNN's outputs at rtol 1e-3 / atol 2e-4; images and the
grid's actions equal; parameters within 2 lr per Adam step + 5e-5 with a
median gap below 1e-6), and every rank's parameters after every step or
update are held bit for bit to rank 0's. Then the entry points themselves,
each as a user starts it: `python -m var_tpu_torch.rl` (the arm device
sim, 64 envs, 2 updates) and `python -m var_tpu_torch.pretext` (collection
on rank 0, then one epoch at batch 128) at meshShape dp=N, spawned and
under torchrun, against dp=1: the progress rows and every checkpoint.

(b) Rates at the recipes' global sizes, at dp = 1, 2, ..., N (powers of
two): arm and ai2thor pretext triplets/s (batch 128), the arm's fused
env-steps/s (8 envs), both device sims' env-steps/s (64 envs), and a
weak-scaling row for the device sims at 64 envs a rank; each a median of
`--repeats` timed blocks after a warm-up, with its spread; beside each,
the time spent in collectives per step or update and the bytes of each
all-reduce. At dp=N the fused path and the arm device sim run once more
with every rank's host threads at the library's default, the "before" of
sharded_main's cpu_count // N.

Writes OUT/report.json and prints the rows; exits non-zero if a check
fails. With --device cpu the same runs on gloo ranks (the CPU test runs
its comparison and report functions at --width small).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
PARAM_MEDIAN = 1e-6  # a missing all-reduce moves most weights by about lr
PRETEXT_STEPS = {"arms": 3, "ai2thor": 1}
PRETEXT_LR_STEPS = 1e-4  # pretextLR of both profiles

# the checks' sizes: the CPU test's reduced widths, and the profiles' full
# widths at the recipes' env counts (sim_t None: the profile's ppoNumSteps)
WIDTHS = {
    "small": dict(sim_t=4, sim_n=8, fused_t=3, fused_n=8, goal_draws=2,
                  knobs=dict(RLEnvMaxSteps=4, ppoNumSteps=4,
                             RLRecurrentSize=32, RLRecurrentInputSize=16,
                             ppoEpoch=2, ppoNumMiniBatch=2),
                  batch={"arms": 8, "ai2thor": 4},
                  sound={"ai2thor": (1, 100, 40)}),
    "full": dict(sim_t=None, sim_n=64, fused_t=None, fused_n=8,
                 goal_draws=None, knobs={},
                 batch={"arms": 128, "ai2thor": 128}, sound={}),
}


def overrides(profile, width="small", **extra):
    """The config knobs of `profile` at `width` (the CPU test gives them to
    both packages)."""
    w = WIDTHS[width]
    base = dict(RLNumEnvs=w["sim_n"], vecEnvBackend="dummy",
                audioBackend="pallas",
                pretextTrainBatchSize=w["batch"][profile], **w["knobs"])
    if profile in w["sound"]:
        base["sound_dim"] = w["sound"][profile]
    return {**base, **extra}


def knobs(profile, width="small", **extra):
    """The port config of `profile` at `width`."""
    from var_tpu_torch import config as tconfig

    cfg = tconfig.main_config(env=profile)
    cfg.override(**overrides(profile, width, **extra))
    tconfig.gym_register(cfg, env=profile)
    return cfg


def _width(work):
    with open(os.path.join(work, "width.json")) as f:
        return json.load(f)["width"]


def write_width(work, width):
    with open(os.path.join(work, "width.json"), "w") as f:
        json.dump({"width": width}, f)


def _steps(cfg, width, key):
    return WIDTHS[width][key] or int(cfg.ppoNumSteps)


def _load(work, name):
    return torch.load(os.path.join(work, name), weights_only=False)


def _params(module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def _flat(module):
    return torch.cat([v.detach().reshape(-1).float().cpu()
                      for v in module.state_dict().values()])


def _cpu(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


# -- inputs --------------------------------------------------------------------


def write_pretext_inputs(work, profile, cfg, audio, var_state_dict, seed=1):
    """The VAR's weights and PRETEXT_STEPS index rows over a random image
    set and the store's clip bank, at the config's batch."""
    torch.save(var_state_dict, os.path.join(work, f"{profile}_var.pt"))
    bank, lengths, ranges = audio.build_clip_bank()
    rng = np.random.RandomState(seed)
    steps, b = PRETEXT_STEPS[profile], cfg.pretextTrainBatchSize
    images = rng.randint(0, 256, (max(12, b), 3, 96, 96)).astype(np.uint8)
    pos_ids, pos_zero = audio.sample_clip_ids(
        rng.randint(0, 5, steps * b), ranges, rng)
    neg_ids, neg_zero = audio.sample_clip_ids(
        rng.randint(0, 5, steps * b), ranges, rng)
    np.savez(os.path.join(work, f"{profile}_pretext.npz"), images=images,
             wav=bank, len=lengths,
             img=rng.randint(0, len(images), (steps, b)).astype(np.int64),
             pos=pos_ids.reshape(steps, b).astype(np.int64),
             pos_zero=pos_zero.reshape(steps, b),
             neg=neg_ids.reshape(steps, b).astype(np.int64),
             neg_zero=neg_zero.reshape(steps, b))


def write_policy(work, profile, width, seed):
    """The profile's policy, the port's draw from `seed`."""
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.train.rl import device_sim_profile

    cfg = knobs(profile, width)
    space, _ = device_sim_profile(cfg)
    pol = build_policy(cfg, space)
    pol.reset_parameters(torch.Generator().manual_seed(seed))
    torch.save(pol.state_dict(), os.path.join(work, f"{profile}_policy.pt"))


def write_inputs(work, width="full", seed=0):
    """Every check's inputs from seeds, the port's own draws: each
    profile's VAR and pretext rows, its policy, its update's permutations
    (the sims draw their episodes from their generators)."""
    from var_tpu_torch.data.audio_store import AudioStore
    from var_tpu_torch.models.encoders import build_pretext_model

    os.makedirs(work, exist_ok=True)
    write_width(work, width)
    for i, profile in enumerate(("arms", "ai2thor")):
        cfg = knobs(profile, width)
        audio = AudioStore(cfg)
        audio.loadData()
        var = build_pretext_model(cfg)
        var.reset_parameters(torch.Generator().manual_seed(seed + i))
        write_pretext_inputs(work, profile, cfg, audio, var.state_dict(),
                             seed + 1)
        write_policy(work, profile, width, seed + 3 + 2 * i)
        g = torch.Generator().manual_seed(seed + 4 + 2 * i)
        torch.save(torch.stack([torch.randperm(WIDTHS[width]["sim_n"],
                                               generator=g)
                                for _ in range(cfg.ppoEpoch)]),
                   os.path.join(work, f"{profile}_perms.pt"))


# -- the checks (each rank, and dp=1 without a mesh) ---------------------------


def _pretext_trainer(profile, mesh, work, device):
    from var_tpu_torch.models.encoders import build_pretext_model
    from var_tpu_torch.train.pretext import PretextTrainer

    cfg = knobs(profile, _width(work))
    tr = PretextTrainer(cfg, device=device)
    tr._ensure_audio()
    tr.mesh = mesh
    tr.model = build_pretext_model(cfg)
    tr.model.load_state_dict(_load(work, f"{profile}_var.pt"))
    tr.model.to(tr.device)
    tr.setup_optimizer(steps_per_epoch=10)
    return tr


def pretext_steps(profile, mesh, work, device):
    """The pretext step over the resident bank, every step's (B,) index
    row from the work directory: arm 3 steps, ai2thor 1."""
    tr = _pretext_trainer(profile, mesh, work, device)
    d = np.load(os.path.join(work, f"{profile}_pretext.npz"))
    bank = {k: torch.from_numpy(d[k]).to(tr.device)
            for k in ("images", "wav", "len")}
    cols = [torch.from_numpy(d[k]).to(tr.device)
            for k in ("img", "pos", "pos_zero", "neg", "neg_zero")]
    losses, steps = [], []
    for s in range(cols[0].shape[0]):
        losses.append(tr._train_step_indexed(bank, *(c[s] for c in cols)))
        steps.append(_flat(tr.model))
    return {"losses": torch.stack(losses).cpu(), "params": _params(tr.model),
            "steps": steps}


def streaming_steps(mesh, work, device):
    """The arm's streaming step (host batches, each rank uploading its
    block) over the batches pretext_steps gathers from its bank."""
    from var_tpu_torch.data.triplets import TripletBatch

    tr = _pretext_trainer("arms", mesh, work, device)
    d = np.load(os.path.join(work, "arms_pretext.npz"))
    losses, steps = [], []
    for s, img in enumerate(d["img"]):
        pos, neg = d["pos"][s], d["neg"][s]
        batch = TripletBatch(d["images"][img], d["wav"][pos], d["len"][pos],
                             d["pos_zero"][s], d["wav"][neg], d["len"][neg],
                             d["neg_zero"][s], np.zeros(len(img), np.int32))
        dev = tr._wait_upload(*tr._device_batch(batch))
        losses.append(tr._train_step_wav(*dev, len(img)))
        steps.append(_flat(tr.model))
    return {"losses": torch.stack(losses).cpu(), "params": _params(tr.model),
            "steps": steps}


def multibank_steps(mesh, work, device):
    """The multi-bank step over two banks that both hold the arm's clip
    bank, each row drawing from one of them in turn: the same batches as
    pretext_steps, through _train_step_multi's (B, K) columns."""
    tr = _pretext_trainer("arms", mesh, work, device)
    d = np.load(os.path.join(work, "arms_pretext.npz"))
    dev = tr.device
    wav = torch.from_numpy(d["wav"]).to(dev)
    lens = torch.from_numpy(d["len"]).to(dev)
    bank = {"images": torch.from_numpy(d["images"]).to(dev),
            "multi_params": (tr._param, tr._param),
            "multi_wav": (wav, wav), "multi_len": (lens, lens)}
    losses, steps = [], []
    for s, img in enumerate(d["img"]):
        first = torch.arange(len(img), device=dev) % 2 == 0
        sel = torch.stack([first, ~first], 1)
        cols = []
        for ids, zero in (("pos", "pos_zero"), ("neg", "neg_zero")):
            i = torch.from_numpy(d[ids][s]).to(dev)
            cols += [torch.stack([i, i], 1), sel,
                     torch.from_numpy(d[zero][s]).to(dev)]
        losses.append(tr._train_step_multi(
            bank, torch.from_numpy(img).to(dev), *cols))
        steps.append(_flat(tr.model))
    return {"losses": torch.stack(losses).cpu(), "params": _params(tr.model),
            "steps": steps}


def _var(cfg, work, profile, device):
    from var_tpu_torch.models.encoders import build_pretext_model

    model = build_pretext_model(cfg)
    model.load_state_dict(_load(work, f"{profile}_var.pt"))
    return model.to(device).eval().requires_grad_(False)


@contextlib.contextmanager
def _goal_draws(n):
    """The grid engine's goal draws per task set to n (None: its own)."""
    from var_tpu_torch.rl.device_sim import GridDeviceSimEngine

    samples = GridDeviceSimEngine.SAMPLES_PER_TASK
    if n is not None:
        GridDeviceSimEngine.SAMPLES_PER_TASK = n
    try:
        yield
    finally:
        GridDeviceSimEngine.SAMPLES_PER_TASK = samples


def device_sim_cycle(profile, mesh, work, device):
    """One collect and one PPO update of the profile's device sim: the arm
    from explicit global draws where the work directory holds them, else
    (and the grid always) from its generator's global draws."""
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.parallel.mesh import all_gather_env
    from var_tpu_torch.rl.device_sim import init_rms
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.train.rl import device_sim_profile

    width = _width(work)
    cfg = knobs(profile, width)
    T, N = _steps(cfg, width, "sim_t"), WIDTHS[width]["sim_n"]
    space, engine_cls = device_sim_profile(cfg)
    policy = build_policy(cfg, space)
    policy.load_state_dict(_load(work, f"{profile}_policy.pt"))
    policy.to(device)
    with _goal_draws(WIDTHS[width]["goal_draws"]):
        engine = engine_cls(
            _var(cfg, work, profile, device), policy, cfg, T, N, mesh=mesh,
            generator=torch.Generator(device=device).manual_seed(5),
            device=device)
    draws_path = os.path.join(work, "arms_draws.pt")
    draws = (_load(work, "arms_draws.pt")
             if profile == "arms" and os.path.exists(draws_path) else None)
    rms, batch, ep_raw = engine.collect(init_rms(engine.N, device), draws)
    out = {"rms": torch.stack([rms.mean, rms.var, rms.count]),
           "ep_raw": all_gather_env(ep_raw, mesh),
           "rewards": all_gather_env(engine.rewards, mesh, 1)}
    for k in ("actions", "value_preds", "returns", "old_log_probs"):
        out[k] = all_gather_env(batch[k], mesh, 1)
    out["image"] = all_gather_env(batch["obs"]["image"], mesh, 1)
    ppo = PPO(policy, PPOConfig.from_config(cfg), mesh)
    state, metrics = ppo.update(ppo.init_state(), batch,
                                _load(work, f"{profile}_perms.pt").to(device))
    out["metrics"] = torch.stack(list(metrics.values()))
    out = {k: _cpu(v) for k, v in out.items()}
    out["params"] = _params(policy)
    return out


def fused_cycle(mesh, work, device, backend="dummy"):
    """One rollout of the arm's fused host path (host envs for this rank's
    block, in-process or, with backend 'shmem', one worker process each
    from the rank's own forkserver) and its PPO update, the action noise
    from the trainer's generator, through RLTrainer's own setup, rollout
    and update."""
    from var_tpu_torch.parallel.mesh import all_gather_env
    from var_tpu_torch.train.rl import RLTrainer

    width = _width(work)
    cfg0 = knobs("arms", width)
    T, N = _steps(cfg0, width, "fused_t"), WIDTHS[width]["fused_n"]
    cfg = knobs("arms", width, RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
                vecEnvBackend=backend)
    tr = RLTrainer(cfg, device=device)
    tr.mesh = mesh
    tr.pretext_model = _var(cfg, work, "arms", tr.device)
    envs, engine, action = tr.setup_fused()
    try:
        tr.rollout(envs, engine, action)
        metrics = tr.update(engine)
    finally:
        envs.close()
    b = engine.buffers
    out = {"actions": all_gather_env(b.actions, mesh, 1),
           "rewards": all_gather_env(b.rewards, mesh, 1),
           "rms": torch.stack([b.rms_mean, b.rms_var, b.rms_count]),
           "episodes": torch.tensor(list(tr.episode_rewards)),
           "metrics": torch.tensor(list(metrics.values()))}
    out = {k: _cpu(v) for k, v in out.items()}
    out["params"] = _params(tr.policy)
    return out


CHECKS = {
    "arms_pretext": lambda m, w, d: pretext_steps("arms", m, w, d),
    "ai2thor_pretext": lambda m, w, d: pretext_steps("ai2thor", m, w, d),
    "arms_stream": streaming_steps,
    "arms_multibank": multibank_steps,
    "arms_sim": lambda m, w, d: device_sim_cycle("arms", m, w, d),
    "ai2thor_sim": lambda m, w, d: device_sim_cycle("ai2thor", m, w, d),
    "fused": fused_cycle,
    "fused_shmem": lambda m, w, d: fused_cycle(m, w, d, "shmem"),
}
KERNEL_CHECKS = ("arms_pretext", "ai2thor_pretext")


@contextlib.contextmanager
def first_kernel_input(into):
    """Counts the mel-log-DCT launches of the block and keeps the first
    input the path gives the kernel, which `kernel_report` then runs
    through the kernel and its plain version."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.ops import mel_log_dct as mld

    stft = audio._stft_power_gemm

    def capture(wav, params, *args):
        power = stft(wav, params, *args)
        into.setdefault("first", (power.detach().clone(), params))
        return power

    audio._stft_power_gemm = capture
    before = mld.mel_log_dct.launches
    try:
        yield
    finally:
        audio._stft_power_gemm = stft
        into["launches"] = mld.mel_log_dct.launches - before


def kernel_report(seen):
    """The kernel against its plain version on the first captured input:
    shape, max abs error, agreement at rtol = atol = 1e-4."""
    from var_tpu_torch.ops import mel_log_dct as mld

    power, params = seen["first"]
    with torch.no_grad():
        got = mld.mel_log_dct(power, params)
        want = mld.mel_log_dct_reference(power, params)
    return {"launches": seen["launches"], "shape": list(power.shape),
            "max_abs_err": (got - want).abs().max().item(),
            "ok": bool(torch.allclose(got, want, **TOL))}


def run_checks(work, mesh, device):
    """Every check on this rank, each with its kernel launches; the
    pretext checks also report the rank's first kernel input against the
    plain version."""
    out = {}
    for name in CHECKS:
        seen = {}
        with first_kernel_input(seen):
            out[name] = CHECKS[name](mesh, work, device)
        out[name]["kernel"] = (kernel_report(seen) if name in KERNEL_CHECKS
                               else {"launches": seen["launches"]})
    return out


def meshes_for(world):
    """The meshes a group of `world` ranks checks: dp over all of them,
    and at 4 ranks also two dp=2 lines replicated over 'rep'."""
    return ({"dp": world}, {"dp": 2, "rep": 2}) if world == 4 else (
        {"dp": world},)


def mesh_name(shape):
    return "_".join(f"{k}{v}" for k, v in shape.items())


def check_file(work, route, shape, rank):
    return os.path.join(work, f"{route}_{mesh_name(shape)}_rank{rank}.pt")


def check_rank(config, work, route, device):
    """One rank of the checks: every check on each of meshes_for(world),
    saved to check_file."""
    import torch.distributed as dist

    from var_tpu_torch.parallel.mesh import build_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    for shape in meshes_for(world):
        mesh = build_mesh(shape, device)
        torch.save(run_checks(work, mesh, device),
                   check_file(work, route, shape, rank))


# -- comparing -----------------------------------------------------------------


def _row(check, what, err, tol, ok):
    return {"check": check, "what": what, "err": float(err), "tol": tol,
            "ok": bool(ok)}


def _close(check, what, got, want, tol):
    got = np.asarray(_cpu(got), np.float64)
    want = np.asarray(_cpu(want), np.float64)
    if got.shape != want.shape:
        return _row(check, what + " shape", math.inf, 0, False)
    err = np.abs(got - want)
    excess = (err - tol["atol"] - tol["rtol"] * np.abs(want)).max(initial=0)
    return _row(check, what, err.max(initial=0), f"rtol {tol['rtol']:g} "
                f"atol {tol['atol']:g}", excess <= 0 and np.isfinite(got).all())


def _equal(check, what, got, want):
    got, want = _cpu(got), _cpu(want)
    same = got.shape == want.shape and torch.equal(got, want)
    err = 0.0 if same else (float((got.double() - want.double()).abs().max())
                            if got.shape == want.shape else math.inf)
    return _row(check, what, err, "equal", same)


def _cat(params, keys):
    return torch.cat([params[k].float().ravel() for k in keys])


def _param_rows(check, got, want, bound):
    diffs = (_cat(got, want) - _cat(want, want)).abs()
    return [_row(check, "parameters max", diffs.max(), f"{bound:.3e}",
                 diffs.max().item() <= bound),
            _row(check, "parameters median", diffs.median(),
                 f"< {PARAM_MEDIAN:g}", diffs.median().item() < PARAM_MEDIAN)]


@functools.lru_cache(maxsize=None)
def _sizes(profile, width):
    """(RLLr, ppoEpoch, ppoNumMiniBatch, pretext batch, sound frames) of
    `profile` at `width`."""
    cfg = knobs(profile, width)
    return (cfg.RLLr, cfg.ppoEpoch, cfg.ppoNumMiniBatch,
            cfg.pretextTrainBatchSize, int(cfg.sound_dim[1]))


def compare_to_dp1(got, dp1, width):
    """Rows holding one rank's checks to dp=1's, at the tolerances of
    tests/test_torch_parallel.py."""
    rows = []
    for name, out in got.items():
        want = dp1[name]
        if name.endswith("pretext") or name in ("arms_stream",
                                                "arms_multibank"):
            profile = name.split("_")[0]
            tol = TOL if profile == "arms" else CRNN_TOL
            bound = 2 * PRETEXT_LR_STEPS * PRETEXT_STEPS[profile] + 5e-5
            rows.append(_close(name, "losses", out["losses"], want["losses"],
                               tol))
            rows += _param_rows(name, out["params"], want["params"], bound)
            if name in ("arms_stream", "arms_multibank"):
                # and the indexed step's, on the same batches
                rows.append(_close(name, "losses against the indexed step",
                                   out["losses"], dp1["arms_pretext"]["losses"],
                                   TOL))
            continue
        lr, epochs, minibatches, _, _ = _sizes(
            "ai2thor" if name == "ai2thor_sim" else "arms", width)
        bound = 2 * lr * epochs * minibatches + 5e-5
        if name.startswith("fused"):
            for k in ("actions", "rewards", "rms", "metrics", "episodes"):
                rows.append(_close(name, k, out[k], want[k], TOL))
                if name == "fused_shmem":  # and the in-process envs' run
                    rows.append(_close(name, k + " against in-process envs",
                                       out[k], dp1["fused"][k], TOL))
        else:
            rows.append(_equal(name, "image", out["image"], want["image"]))
            if name == "ai2thor_sim":
                rows.append(_equal(name, "actions", out["actions"],
                                   want["actions"]))
            for k in ("actions", "value_preds", "returns", "old_log_probs",
                      "rms", "ep_raw", "metrics", "rewards"):
                rows.append(_close(name, k, out[k], want[k], TOL))
        rows += _param_rows(name, out["params"], want["params"], bound)
    return rows


def compare_ranks(outs):
    """Rows holding every rank's parameters after every step or update
    (and its metrics) bit for bit to rank 0's; `outs` is in rank order."""
    rows = []
    lead = outs[0]
    for r, other in enumerate(outs[1:], 1):
        for name, out in lead.items():
            # bit for bit: the int32 view tells -0.0 from 0.0, NaN from NaN
            same = torch.equal(
                _cat(other[name]["params"], out["params"]).view(torch.int32),
                _cat(out["params"], out["params"]).view(torch.int32))
            for s, flat in enumerate(out.get("steps", [])):
                same = same and torch.equal(
                    other[name]["steps"][s].view(torch.int32),
                    flat.view(torch.int32))
            if "metrics" in out:
                same = same and torch.equal(other[name]["metrics"],
                                            out["metrics"])
            rows.append(_row(name, f"rank {r} parameters after every step "
                             "bit-equal to rank 0's", 0.0 if same else 1.0,
                             "equal", same))
    return rows


def kernel_rows(outs, shapes):
    """Each rank's first kernel input against the plain version, at the
    expected per-rank shape of each pretext check."""
    rows = []
    for r, out in enumerate(outs):
        for name in KERNEL_CHECKS:
            k = out[name]["kernel"]
            ok = k.get("ok", False) and k["shape"] == list(shapes[name])
            rows.append(_row(name, f"rank {r} kernel at {k['shape']} "
                             f"({k['launches']} launches) against plain",
                             k.get("max_abs_err", math.inf), "rtol 1e-4 "
                             "atol 1e-4", ok))
    return rows


def load_checks(work, route, world):
    """{mesh name: every rank's saved checks, in rank order}."""
    return {mesh_name(shape): [
        torch.load(check_file(work, route, shape, r), weights_only=False)
        for r in range(world)] for shape in meshes_for(world)}


def compare_checks(dp1, by_mesh, route, width):
    """Every row of (a) for one launch route: each mesh's ranks
    (load_checks) against dp=1 (rank 0 holds what every rank holds) and
    against rank 0; each rank's first kernel input at its block's shape
    (B / dp, frames + 1, 257 bins)."""
    rows = []
    for name, outs in by_mesh.items():
        dp = int(name.split("_")[0][2:])
        shapes = {}
        for check in KERNEL_CHECKS:
            _, _, _, batch, frames = _sizes(check.split("_")[0], width)
            shapes[check] = (batch // dp, frames + 1, 257)
        tag = f"{route} {name}"
        for row in (compare_to_dp1(outs[0], dp1, width) + compare_ranks(outs)
                    + kernel_rows(outs, shapes)):
            rows.append({"route": tag, **row})
    return rows


# -- timing collectives --------------------------------------------------------


class CollectiveClock:
    """Times every all-reduce, all-gather and broadcast this process makes
    while installed (CUDA events on the current stream around each call on
    the card, the host clock on the CPU) and keeps the bytes of each
    all-reduce. `read()` returns (ms, calls, all-reduce bytes) since the
    last read."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "broadcast")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events, self.host_ms, self.calls = [], 0.0, 0
        self.reduce_bytes = []
        self.real = {}

    def __enter__(self):
        import torch.distributed as dist

        for name in self.NAMES:
            real = getattr(dist, name)
            self.real[name] = real

            def timed(tensor, *args, _real=real, _name=name, **kw):
                if _name == "all_reduce":
                    self.reduce_bytes.append(tensor.numel()
                                             * tensor.element_size())
                self.calls += 1
                if self.cuda:
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    a.record()
                    out = _real(tensor, *args, **kw)
                    b.record()
                    self.events.append((a, b))
                    return out
                t0 = time.perf_counter()
                out = _real(tensor, *args, **kw)
                self.host_ms += (time.perf_counter() - t0) * 1e3
                return out

            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, real in self.real.items():
            setattr(dist, name, real)

    def read(self):
        if self.cuda:
            torch.cuda.synchronize()
            ms = sum(a.elapsed_time(b) for a, b in self.events)
        else:
            ms = self.host_ms
        out = (ms, self.calls, list(self.reduce_bytes))
        self.events, self.host_ms, self.calls = [], 0.0, 0
        self.reduce_bytes = []
        return out


# -- rates ---------------------------------------------------------------------


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_blocks(block, repeats, clock, device):
    """block() once to warm up, then `repeats` times; each timed block's
    (seconds, items, collective ms, collective calls, all-reduce bytes)."""
    block()
    _sync(device)
    clock.read()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        items = block()
        _sync(device)
        secs = time.perf_counter() - t0
        out.append((secs, items) + clock.read())
    return out


PRETEXT_BLOCK = 10  # pretext steps a timed block


def pretext_rate(profile, mesh, device, repeats, clock, seed=7):
    """Triplets/s of the pretext step at the profile's batch (global),
    over `repeats` blocks of PRETEXT_BLOCK steps on a random bank."""
    from var_tpu_torch.models.encoders import build_pretext_model
    from var_tpu_torch.train.pretext import PretextTrainer

    cfg = knobs(profile, "full")
    tr = PretextTrainer(cfg, device=device)
    tr._ensure_audio()
    tr.mesh = mesh
    tr.model = build_pretext_model(cfg)
    tr.model.reset_parameters(torch.Generator().manual_seed(seed))
    tr.model.to(tr.device)
    tr.setup_optimizer(steps_per_epoch=1000)
    bank_np, lengths, ranges = tr.audio.build_clip_bank()
    rng = np.random.RandomState(seed)
    B = cfg.pretextTrainBatchSize
    dev = tr.device
    bank = {"images": torch.from_numpy(rng.randint(
        0, 256, (512, 3, 96, 96)).astype(np.uint8)).to(dev),
        "wav": torch.from_numpy(bank_np).to(dev),
        "len": torch.from_numpy(lengths).to(dev)}

    def rows():
        pos, pz = tr.audio.sample_clip_ids(rng.randint(0, 5, B), ranges, rng)
        neg, nz = tr.audio.sample_clip_ids(rng.randint(0, 5, B), ranges, rng)
        return [torch.from_numpy(np.asarray(a)).to(dev) for a in (
            rng.randint(0, 512, B).astype(np.int64), pos.astype(np.int64),
            pz, neg.astype(np.int64), nz)]

    batches = [rows() for _ in range(PRETEXT_BLOCK)]

    def block():
        for b in batches:
            tr._train_step_indexed(bank, *b)
        return PRETEXT_BLOCK * B

    return _timed_blocks(block, repeats, clock, device)


def fused_rate(mesh, device, repeats, clock, var):
    """Env-steps/s of the arm's fused host path at 8 envs (global): one
    warm-up cycle, then `repeats` cycles of rollout and update."""
    from var_tpu_torch.train.rl import RLTrainer

    cfg = knobs("arms", "full", RLNumEnvs=8)
    tr = RLTrainer(cfg, device=device)
    tr.mesh = mesh
    tr.pretext_model = var
    envs, engine, action = tr.setup_fused()
    state = {"action": action}

    def cycle():
        state["action"] = tr.rollout(envs, engine, state["action"])
        tr.update(engine)
        return engine.T * cfg.RLNumEnvs

    try:
        return _timed_blocks(cycle, repeats, clock, device)
    finally:
        envs.close()


def sim_rate(profile, mesh, device, repeats, clock, var, n_envs):
    """Env-steps/s of the profile's device sim at `n_envs` (global): the
    trainer's collect, update and one read per update, as
    _train_device_sim runs them; one warm-up update, then `repeats`."""
    from var_tpu_torch.parallel.mesh import all_gather_env
    from var_tpu_torch.rl.device_sim import init_rms
    from var_tpu_torch.train.rl import RLTrainer

    cfg = knobs(profile, "full", RLNumEnvs=n_envs)
    tr = RLTrainer(cfg, device=device)
    tr.mesh = mesh
    tr.pretext_model = var
    engine = tr.setup_device_sim()
    state = {"rms": init_rms(engine.N, tr.device)}

    def update():
        state["rms"], batch, ep_raw = engine.collect(state["rms"])
        ep_raw = all_gather_env(ep_raw, mesh)
        tr.state, metrics = tr.ppo.update(
            tr.state, batch, tr.ppo.draw_perms(batch, tr.generator))
        torch.cat([ep_raw, torch.stack(list(metrics.values()))]).tolist()
        return engine.T * n_envs

    return _timed_blocks(update, repeats, clock, device)


RATE_PATHS = ("arms_pretext", "ai2thor_pretext", "arms_fused", "arms_sim",
              "ai2thor_sim", "arms_sim_weak", "ai2thor_sim_weak")


def rate_rank(config, out_path, paths, repeats, device):
    """One rank of the rates at the mesh of its group: each path's timed
    blocks, from rank 0 into out_path (JSON)."""
    import torch.distributed as dist

    from var_tpu_torch.models.encoders import build_pretext_model
    from var_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(config.meshShape, device)
    vars_ = {}
    for profile in ("arms", "ai2thor"):
        var = build_pretext_model(knobs(profile, "full"))
        var.reset_parameters(torch.Generator().manual_seed(11))
        vars_[profile] = var.to(device).eval().requires_grad_(False)
    results = {"threads": torch.get_num_threads(), "dp": mesh.dp}
    with CollectiveClock(device) as clock:
        for path in paths:
            profile = path.split("_")[0]
            if path.endswith("pretext"):
                blocks = pretext_rate(profile, mesh, device, repeats, clock)
            elif path == "arms_fused":
                blocks = fused_rate(mesh, device, repeats, clock,
                                    vars_["arms"])
            else:
                n = 64 * (mesh.dp if path.endswith("weak") else 1)
                blocks = sim_rate(profile, mesh, device, repeats, clock,
                                  vars_[profile], n)
            results[path] = blocks
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def summarize_rates(results):
    """One row per path of a rates run: the median rate over the blocks
    with its spread (min, max), the collectives' ms per step or update
    (median), their calls, and the bytes of each all-reduce (those of one
    block, distinct sizes with their counts)."""
    rows = []
    for path in RATE_PATHS:
        if path not in results:
            continue
        blocks = results[path]
        rates = [items / secs for secs, items, *_ in blocks]
        per = PRETEXT_BLOCK if path.endswith("pretext") else 1
        coll = [ms / per for _, _, ms, *_ in blocks]
        sizes = {}
        for b in blocks[-1][4]:
            sizes[b] = sizes.get(b, 0) + 1
        rows.append({
            "path": path, "dp": results["dp"], "threads": results["threads"],
            "unit": "triplets/s" if path.endswith("pretext")
            else "env-steps/s",
            "median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "runs": len(rates),
            "collective_ms_per_step": statistics.median(coll),
            "collective_calls_per_block": blocks[-1][3],
            "allreduce_bytes": {str(k): v for k, v in sorted(sizes.items())},
        })
    return rows


# -- the entry points as a user starts them ------------------------------------


ENTRY_ARGS = {
    "rl": ["--env", "arms", "--set", "RLTrain=True", "RLModelFineTune=False",
           "RLDeviceSimRollout=True", "RLNumEnvs=64", "RLTotalSteps=12800",
           "RLModelSaveInterval=1", "RLLogInterval=1",
           "vecEnvBackend='dummy'"],
    "pretext": ["--env", "arms", "--set", "pretextCollectNum=[64,64,64,64,128]",
                "pretextDataEpisode=400", "pretextEpoch=1",
                "pretextModelSaveInterval=1", "pretextTrainBatchSize=128",
                "pretextModelFineTune=False", "pretextDataset='VARDataset'",
                "vecEnvBackend='dummy'", "audioBackend='pallas'"],
}
ENTRY_SMALL = {
    "rl": ["RLNumEnvs=8", "RLEnvMaxSteps=4", "ppoNumSteps=4",
           "RLTotalSteps=64", "RLRecurrentSize=32", "RLRecurrentInputSize=16"],
    "pretext": ["pretextCollectNum=[4,4,4,4,8]", "pretextDataEpisode=4",
                "pretextDataNumFiles=2", "pretextEnvMaxSteps=8",
                "pretextNumEnvs=2", "pretextTrainBatchSize=8"],
}


def entry_argv(kind, out, var_dir, width, device, dp):
    argv = list(ENTRY_ARGS[kind])
    if device == "cpu":
        argv[2:2] = ["--device", "cpu"]
    if width == "small":
        argv += ENTRY_SMALL[kind]
    if kind == "rl":
        argv += [f"pretextModelLoadDir='{var_dir}'", f"RLModelSaveDir='{out}'"]
    else:
        argv += [f"pretextDataDir=['{out}/data']",
                 f"pretextModelSaveDir='{out}/model'"]
    return argv + [f"meshShape={{'dp': {dp}}}"]


def _run(cmd, log, env=None, timeout=1200):
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            env=env, timeout=timeout).returncode
    secs = time.perf_counter() - t0
    if rc:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{' '.join(cmd[:6])} ... exited {rc}:\n{tail}")
    return secs


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _torchrun(n):
    """torchrun's command for n ranks on this host, on a free local port."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
            str(n), "--master_addr", "localhost", "--master_port",
            str(_free_port())]


def entry_rows(work, n, width, device):
    """The entry points as a user starts them at dp=1 and at dp=n (spawned,
    then under torchrun): each run's first progress row at rtol = atol =
    1e-4 and every checkpoint within the Adam-step bound (median gap below
    1e-6) against dp=1's; the seconds of each run."""
    import csv

    from var_tpu_torch.train.checkpoint import load_checkpoint

    var_dir = os.path.join(work, "entry_var")
    rows, secs = [], {}
    for kind in ("pretext", "rl"):
        runs = {}
        for route in ("dp1", "spawn", "torchrun"):
            out = os.path.join(work, f"entry_{kind}_{route}")
            shutil.rmtree(out, ignore_errors=True)
            dp = 1 if route == "dp1" else n
            argv = entry_argv(kind, out, var_dir, width, device, dp)
            cmd = ((_torchrun(n) if route == "torchrun"
                    else [sys.executable]) + ["-m", f"var_tpu_torch.{kind}"]
                   + argv)
            secs[f"{kind} {route}"] = _run(cmd, out + ".log")
            runs[route] = out if kind == "rl" else os.path.join(out, "model")
        if kind == "pretext":
            # the RL runs train on the VAR the dp=1 pretext run wrote
            shutil.copytree(os.path.join(runs["dp1"], "0"), var_dir,
                            dirs_exist_ok=True)
        cfg = knobs("arms", width)
        if kind == "rl":
            bound = 2 * cfg.RLLr * cfg.ppoEpoch * cfg.ppoNumMiniBatch
            keys = ("loss/value_loss", "loss/policy_loss",
                    "loss/policy_entropy", "eprewmean")
        else:
            bound = 2 * PRETEXT_LR_STEPS * math.ceil(
                sum(cfg.pretextCollectNum if width == "small" else
                    [64, 64, 64, 64, 128]) / cfg.pretextTrainBatchSize)
            keys = ("avg_loss",)
        labels = sorted(x for x in os.listdir(runs["dp1"])
                        if x.isdigit())
        want_rows = list(csv.DictReader(open(os.path.join(
            runs["dp1"], "progress.csv"))))
        for route in ("spawn", "torchrun"):
            got_rows = list(csv.DictReader(open(os.path.join(
                runs[route], "progress.csv"))))
            tag = f"entry {kind} {route} dp{n}"
            rows.append({"route": tag, **_row(
                kind, "progress rows", 0, "count",
                len(got_rows) == len(want_rows))})
            for k in keys:
                rows.append({"route": tag, **_close(
                    kind, f"first row {k}", float(got_rows[0][k]),
                    float(want_rows[0][k]), TOL)})
            for i, label in enumerate(labels):
                got = load_checkpoint(os.path.join(runs[route], label))
                want = load_checkpoint(os.path.join(runs["dp1"], label))
                for row in _param_rows(f"{kind} {label}", got["params"],
                                       want["params"],
                                       bound * (i + 1) + 5e-5):
                    rows.append({"route": tag, **row})
    return rows, secs


# -- the report ----------------------------------------------------------------


def report_lines(checks, rates, entry_secs=None, card=""):
    """The printed report: each failed row, the counts, and one line per
    rate row."""
    lines = []
    bad = [r for r in checks if not r["ok"]]
    for r in bad:
        lines.append(f"FAIL {r.get('route', '')} {r['check']}: {r['what']} "
                     f"{r['err']:.3e} ({r['tol']})")
    worst = {}
    for r in checks:
        key = (r.get("route", ""), r["check"])
        worst[key] = max(worst.get(key, 0.0), r["err"]) if math.isfinite(
            r["err"]) else r["err"]
    lines.append(f"checks: {len(checks) - len(bad)} of {len(checks)} rows "
                 f"ok over {len(worst)} (route, check) pairs")
    for r in rates:
        lines.append(
            f"rate {r['path']} dp={r['dp']} threads={r['threads']}: "
            f"{r['median']:.1f} {r['unit']} (min {r['min']:.1f}, max "
            f"{r['max']:.1f}, {r['runs']} runs); collectives "
            f"{r['collective_ms_per_step']:.3f} ms a step or update; "
            f"all-reduce bytes {r['allreduce_bytes']}; {card}")
    for k, v in (entry_secs or {}).items():
        lines.append(f"entry {k}: {v:.1f} s")
    return lines


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _config(dp, device):
    from var_tpu_torch.config import main_config

    cfg = main_config(env="arms")
    cfg.override(meshShape={"dp": dp})
    return cfg


def run(out, dp=None, repeats=3, device="cuda", width="full",
        rates=True, entries=True):
    """(a) and (b) into out/report.json; returns the report."""
    from var_tpu_torch.cli import sharded_main
    from var_tpu_torch.parallel.mesh import launch

    # dp=1 only when asked for: a rehearsal of every path on one card
    n = dp or (4 if device == "cpu" else torch.cuda.device_count())
    if n < 2 and not dp:
        raise SystemExit(f"mesh_cards needs two or more ranks, got {n}")
    work = os.path.join(out, "work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_all = time.perf_counter()
    write_inputs(work, width)
    first = "cpu" if device == "cpu" else "cuda:0"
    t0 = time.perf_counter()
    dp1 = run_checks(work, None, first)
    secs = {"checks dp1": time.perf_counter() - t0}
    if first != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_main(_config(n, device), device, check_rank, (work, "spawn"))
    secs["checks spawn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.getcwd()] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    secs["checks torchrun"] = _run(
        _torchrun(n) + ["-m", "var_tpu_torch.tools.mesh_cards", out,
                        "--device", device, "--rank-checks", "torchrun"],
        os.path.join(out, "torchrun_checks.log"), env=env)
    checks, launches = [], {}
    for route in ("spawn", "torchrun"):
        by_mesh = load_checks(work, route, n)
        checks += compare_checks(dp1, by_mesh, route, width)
        for name, outs in by_mesh.items():
            for check in CHECKS:
                launches[f"{route} {name} {check}"] = sum(
                    o[check]["kernel"]["launches"] for o in outs)
    entry_secs = {}
    if entries:
        rows, entry_secs = entry_rows(work, n, width, device)
        checks += rows
    rate_rows = []
    if rates and width == "full":
        dps = [d for d in (1, 2, 4, 8) if d <= n]
        for d in dps:
            path = os.path.join(out, f"rates_dp{d}.json")
            # at dp=1 the weak-scaling rows are the 64-env rows themselves
            paths = [p for p in RATE_PATHS if d > 1 or not p.endswith("weak")]
            sharded_main(_config(d, device), device, rate_rank,
                         (path, paths, repeats))
            with open(path) as f:
                rate_rows += summarize_rates(json.load(f))
        # the "before" of the ranks' host threads: the library default
        path = os.path.join(out, f"rates_dp{n}_default_threads.json")
        launch(rate_rank, (_config(n, device), path,
                           ("arms_fused", "arms_sim"), repeats), n,
               device=device)
        with open(path) as f:
            rate_rows += summarize_rates(json.load(f))
    card = card_line() if device != "cpu" else "cpu"
    rep = {"ranks": n, "width": width, "device": device, "card": card,
           "checks": checks, "rates": rate_rows, "launches": launches,
           "entry_seconds": entry_secs,
           "seconds": {**secs, "all": time.perf_counter() - t_all},
           "ok": all(r["ok"] for r in checks)}
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(rep, f, indent=1)
    for line in report_lines(checks, rate_rows, entry_secs, card):
        print(line, flush=True)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--dp", type=int, default=None,
                    help="ranks (default: every visible card; 4 on the CPU)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="full")
    ap.add_argument("--no-rates", action="store_true")
    ap.add_argument("--no-entries", action="store_true")
    ap.add_argument("--rank-checks", default=None,
                    help=argparse.SUPPRESS)  # one torchrun rank of (a)
    a = ap.parse_args(argv)
    if a.rank_checks:
        from var_tpu_torch.cli import sharded_main

        n = int(os.environ["WORLD_SIZE"])
        return sharded_main(_config(n, a.device), a.device, check_rank,
                            (os.path.join(a.out, "work"), a.rank_checks))
    rep = run(a.out, a.dp, a.repeats, a.device, a.width, not a.no_rates,
              not a.no_entries)
    if not rep["ok"]:
        raise SystemExit("mesh_cards: a check failed")
    return rep


if __name__ == "__main__":
    main()
