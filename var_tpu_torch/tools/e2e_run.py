"""End-to-end task-capability run of the port, arm or ai2thor profile
(twin of scripts/e2e_run.py): collect -> VAR -> PPO -> eval, then the
success rate with its binomial CI95.

    python -m var_tpu_torch.tools.e2e_run WORK [--env arms] [--device cpu] \\
        [--device-sim] [--num-envs 64] [--rl-steps 12000000] [--rl-lr 3e-5] \\
        [--collect-per-class 1600] [--var-epochs 60] \\
        [--device-eval-per-class 256] [--stages collect,var,rl,eval] \\
        [--leg-steps S] [--select-best-per-class 256] [--select-best-every 1] \\
        [--set KNOB=VALUE ...]

The eval stage scores the final checkpoint on the host sims (the fused
testRL); --device-eval-per-class adds the device-sim evaluator
(RLDeviceSimEval) at that many episodes per class. Each run updates one
profile entry of the JSON at --out, under build/ by default. The device
is CUDA unless --device says otherwise; there cuDNN picks the fastest
float32 algorithm for each convolution shape by timing
(torch.backends.cudnn.benchmark). The grid recipe:

    python -m var_tpu_torch.tools.e2e_run WORK --env ai2thor --device-sim \
        --num-envs 64 --rl-steps 10000000 --rl-lr 6e-5 \
        --device-eval-per-class 256 \
        --set 'pretextCollectNum=[800,800,1600,1600,3200]'

Legs. --leg-steps S splits the PPO stage over calls, for a run longer
than one machine lease. Each leg resumes from the newest checkpoint under
WORK/rl_model (RLModelFineTune=True: parameters, Adam's count and moments,
the update counter), trains at most S more env steps and writes
WORK/rl_model/DONE_RL once the recipe's RLTotalSteps are reached. Every
leg keeps RLTotalSteps at the whole recipe, so the LR schedule (its
horizon and the linear decay's start, counted in optimizer steps) is the
unsplit run's, and checkpoint labels continue from the restored counter.
As in the JAX package's resume, a leg re-seeds the action-noise and
permutation generator from RLEnvSeed and starts a fresh return-RMS: the
checkpoint holds neither. With S a multiple of ppoNumSteps * RLNumEnvs *
RLModelSaveInterval the legs save the unsplit run's labels, plus each
leg's last. A later leg passes --stages rl,eval (or rl) to skip collection
and the VAR. The eval stages score the newest checkpoint.

--select-best-per-class N sweeps the checkpoints with the device
evaluator (tools/success_curve.py) at N episodes per class, links
rl_model/best to the best one and records checkpoint_selection in the
JSON, as scripts/e2e_run.py does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "e2e", "E2E_port.json")
DONE_MARKER = "DONE_RL"


def build_config(env, work, rl_steps, rl_lr=None, num_envs=None,
                 collect_per_class=None, var_epochs=None, device_sim=False,
                 extra_set=None):
    from var_tpu_torch.cli import parse_set_items
    from var_tpu_torch.config import gym_register, main_config

    cfg = main_config(env=env)
    overrides = dict(
        pretextDataDir=[os.path.join(work, "triplets")],
        pretextModelSaveDir=os.path.join(work, "var_model"),
        pretextModelFineTune=False,
        pretextDataset="VARDataset",
        RLModelSaveDir=os.path.join(work, "rl_model"),
        RLModelFineTune=False,
        RLTrain=True,
        RLTotalSteps=rl_steps,
        RLLogInterval=1,
        episodeImgSaveInterval=-1,
    )
    if collect_per_class:
        # the empty class gets twice the quota; the episode cap is generous
        # because collection stops at the quota anyway
        overrides["pretextCollectNum"] = (
            [collect_per_class] * cfg.taskNum + [2 * collect_per_class])
        overrides["pretextDataEpisode"] = max(2000, 5 * collect_per_class)
    if var_epochs:
        overrides["pretextEpoch"] = var_epochs
        overrides["pretextLRDecayEpoch"] = [var_epochs // 2,
                                            var_epochs * 5 // 6]
    if rl_lr is not None:
        overrides["RLLr"] = rl_lr
    if num_envs is not None:
        overrides["RLNumEnvs"] = num_envs
    if device_sim:
        overrides["RLDeviceSimRollout"] = True
    # raw KNOB=VALUE overrides last, so they win over the derivations above
    overrides.update(parse_set_items(extra_set or []))
    cfg.override(**overrides)
    cfg.override(pretextModelLoadDir=os.path.join(
        work, "var_model", str(cfg.pretextEpoch - 1)))
    cfg.cfg_check()
    gym_register(cfg, env=env)
    return cfg


def binom_ci95(rate, n_episodes):
    """95% normal-approximation binomial confidence half-width."""
    return 1.96 * (max(rate * (1 - rate), 1e-9) / n_episodes) ** 0.5


def scale_eval_quotas(cfg, eval_per_class):
    """Per-class eval quotas of `eval_per_class` episodes per env: the arm
    env derives them from the sound-source sizes (fourInARow.py:92-96),
    so those are rescaled here, at eval time only; the grid sim reads
    testEpisodesPerClass."""
    if hasattr(cfg, "testEpisodesPerClass"):
        cfg.override(testEpisodesPerClass=eval_per_class)
        return
    sizes = cfg.soundSource["size"]
    total = [sum(col) for col in zip(*sizes.values())]
    for ds in sizes:
        sizes[ds] = [eval_per_class * v // t if t else 0
                     for v, t in zip(sizes[ds], total)]


def _hardware(device: str) -> str:
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("work")
    ap.add_argument("--env", choices=["arms", "ai2thor"], default="arms")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    ap.add_argument("--rl-steps", type=int, default=200_000)
    ap.add_argument("--eval-per-class", type=int, default=16)
    ap.add_argument("--eval-envs", type=int, default=8)
    ap.add_argument("--rl-lr", type=float, default=None)
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--collect-per-class", type=int, default=400)
    ap.add_argument("--var-epochs", type=int, default=60)
    ap.add_argument("--device-sim", action="store_true",
                    help="train on the device-resident sim "
                         "(RLDeviceSimRollout=True)")
    ap.add_argument("--device-eval-per-class", type=int, default=0,
                    help="also score the final checkpoint on the device "
                         "sim (RLDeviceSimEval) at this many episodes per "
                         "class (0 = off)")
    ap.add_argument("--device-eval-envs", type=int, default=128)
    ap.add_argument("--set", nargs="*", default=[], metavar="KNOB=VALUE",
                    dest="set_items",
                    help="config overrides, applied after the runner's own")
    ap.add_argument("--stages", default="collect,var,rl,eval")
    ap.add_argument("--leg-steps", type=int, default=0,
                    help="train at most this many env steps in this call, "
                         "resuming from the newest checkpoint (0 = the "
                         "whole run)")
    ap.add_argument("--select-best-per-class", type=int, default=0,
                    help="sweep the checkpoints with the device evaluator "
                         "at this many episodes per class and link "
                         "rl_model/best to the best (0 = off)")
    ap.add_argument("--select-best-every", type=int, default=1,
                    help="curve stride: evaluate every k-th checkpoint")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def run_leg(trainer, leg_steps: int) -> dict:
    """One leg of the PPO stage (see the module docstring): resume from the
    newest checkpoint, train at most `leg_steps` env steps of what the
    recipe has left, write rl_model/DONE_RL when none is left."""
    from var_tpu_torch.train.checkpoint import latest_checkpoint

    cfg = trainer.config
    rl_dir = cfg.RLModelSaveDir
    per_update = int(cfg.ppoNumSteps) * int(cfg.RLNumEnvs)
    total_updates = int(cfg.RLTotalSteps) // per_update
    latest = latest_checkpoint(rl_dir)
    done = 0 if latest is None else int(os.path.basename(latest)) + 1
    if latest is not None:
        cfg.override(RLModelFineTune=True, RLModelLoadDir=latest)
    steps = min(int(leg_steps) // per_update, total_updates - done)
    if steps > 0:
        print(f"leg: updates {done}..{done + steps - 1} of {total_updates}"
              + (f", resuming from {latest}" if latest else ""))
        trainer.trainRL(total_steps=steps * per_update)
        done += steps
    finished = done >= total_updates
    if finished:
        with open(os.path.join(rl_dir, DONE_MARKER), "w") as f:
            f.write(f"{done} updates, {done * per_update} env steps\n")
    return {"resumed_from": latest, "updates_done": done,
            "updates_total": total_updates, "done": finished}


def select_checkpoint(env, work, episodes_per_class, envs, every, extra_set,
                      device) -> dict:
    """Sweep the run's checkpoints, link rl_model/best to the best one and
    write rl_model/best_checkpoint.json (scripts/e2e_run.py:280-330)."""
    from var_tpu_torch.tools.success_curve import run_curve, select_best

    rl_dir = os.path.join(work, "rl_model")
    rows = run_curve(env, work, episodes_per_class, envs, every,
                     extra_set=extra_set, device=device)
    best = select_best(rows)
    best_link = os.path.join(rl_dir, "best")
    # a stale 'best' may be a link, a file or a directory
    if os.path.lexists(best_link):
        if os.path.isdir(best_link) and not os.path.islink(best_link):
            shutil.rmtree(best_link)
        else:
            os.unlink(best_link)
    os.symlink(best["checkpoint"], best_link)
    sel = {
        "best_checkpoint": os.path.join(rl_dir, best["checkpoint"]),
        "shipped_as": best_link,
        "best_success_rate": best["success_rate"],
        "best_ci95": best["ci95"],
        "best_env_steps": best["env_steps"],
        "final_success_rate": rows[-1]["success_rate"],
        # eval_batch runs whole batches: episodes round up to a batch
        "episodes_per_point": (-(-episodes_per_class // envs) * envs
                               * len([k for k in rows[0]
                                      if k.startswith("class_")])),
        "curve_csv": os.path.join(rl_dir, "success_curve.csv"),
    }
    with open(os.path.join(rl_dir, "best_checkpoint.json"), "w") as f:
        json.dump(sel, f, indent=2)
    print(f"selected {sel['best_checkpoint']}: {best['success_rate']:.4f} "
          f"±{best['ci95']:.4f} (final: {rows[-1]['success_rate']:.4f})")
    return sel


def main(argv=None):
    from var_tpu_torch.device import resolve_device

    args = parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.dirname(out) == ROOT and os.path.basename(out).startswith(
            "E2E_"):
        raise SystemExit(f"--out {args.out}: the repo's E2E_*.json files "
                         "hold the JAX package's results")
    device = str(resolve_device(args.device))
    import torch

    # a run's convolution shapes are fixed, so let cuDNN time its float32
    # algorithms for each and keep the fastest (TF32 stays off)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = torch.device(device).type == "cuda"
    try:
        return _run(args, out, device)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _run(args, out, device):
    from var_tpu_torch.train.checkpoint import latest_checkpoint
    from var_tpu_torch.train.pretext import PretextTrainer
    from var_tpu_torch.train.rl import RLTrainer

    stages = set(args.stages.split(","))

    def config(**extra):
        return build_config(args.env, args.work, args.rl_steps, args.rl_lr,
                            args.num_envs, args.collect_per_class,
                            args.var_epochs, extra_set=args.set_items,
                            **extra)

    cfg = config(device_sim=args.device_sim)
    timings = {}
    result = {
        # the resolved config: --set RLTotalSteps=X wins over --rl-steps
        "rl_steps": int(cfg.RLTotalSteps),
        "collect_quota": list(cfg.pretextCollectNum),
        "num_envs": cfg.RLNumEnvs,
        "rl_lr": cfg.RLLr,
        "device_sim": bool(cfg.RLDeviceSimRollout),
    }
    if "collect" in stages or "var" in stages:
        pretext = PretextTrainer(cfg, device=device)
        if "collect" in stages:
            t0 = time.time()
            pretext.collectPretextData()
            timings["collect_s"] = time.time() - t0
        if "var" in stages:
            t0 = time.time()
            pretext.trainRepresentation()
            timings["var_train_s"] = time.time() - t0

    rl_dir = os.path.join(args.work, "rl_model")
    updates = int(cfg.RLTotalSteps) // (cfg.ppoNumSteps * cfg.RLNumEnvs)
    if "rl" in stages:
        t0 = time.time()
        rl = RLTrainer(cfg, env=args.env, device=device)
        rl.load_pretext()
        if args.leg_steps:
            leg = run_leg(rl, args.leg_steps)
            result["leg"] = leg
        else:
            rl.trainRL()
        timings["rl_train_s"] = time.time() - t0
    # the policy the eval stages score: the newest checkpoint (the final
    # one once the run is done)
    final_ckpt = (latest_checkpoint(rl_dir) if args.leg_steps else
                  os.path.join(rl_dir, "%.5i" % (updates - 1)))

    if "eval" in stages:
        t0 = time.time()
        cfg.override(RLTrain=False)
        # lockstep batched eval: N envs finish N same-class episodes per
        # round-robin cycle, so the per-env quota is eval_per_class / N
        per_env = max(1, args.eval_per_class // args.eval_envs)
        scale_eval_quotas(cfg, per_env)
        rl_eval = RLTrainer(cfg, env=args.env, device=device)
        rl_eval.load_pretext()
        rate = rl_eval.testRL(policy_path=final_ckpt,
                              num_envs=args.eval_envs)
        timings["eval_s"] = time.time() - t0
        n_eps = per_env * args.eval_envs * cfg.taskNum
        result.update(
            success_rate=rate, ci95=binom_ci95(rate, n_eps),
            eval_episodes=n_eps, task_classes=cfg.taskNum,
            checkpoint=final_ckpt,
            eval_csv=os.path.join(args.work, "rl_model",
                                  f"test_{os.path.basename(final_ckpt)}.csv"))

    if args.device_eval_per_class:
        t0 = time.time()
        cfg_d = config()
        cfg_d.override(RLTrain=False, RLDeviceSimEval=True)
        per_env = max(1, args.device_eval_per_class // args.device_eval_envs)
        scale_eval_quotas(cfg_d, per_env)
        rl_dev = RLTrainer(cfg_d, env=args.env, device=device)
        rl_dev.load_pretext()
        rate = rl_dev.testRL(policy_path=final_ckpt,
                             num_envs=args.device_eval_envs)
        n_eps = per_env * args.device_eval_envs * cfg_d.taskNum
        result["device_eval"] = {
            "success_rate": rate, "eval_episodes": n_eps,
            "ci95": binom_ci95(rate, n_eps), "eval_s": time.time() - t0}

    if args.select_best_per_class:
        t0 = time.time()
        result["checkpoint_selection"] = select_checkpoint(
            args.env, args.work, args.select_best_per_class,
            args.device_eval_envs, args.select_best_every, args.set_items,
            device)
        result["checkpoint_selection"]["select_s"] = time.time() - t0

    result["timings_s"] = timings
    result["hardware"] = _hardware(device)
    doc = {}
    if os.path.exists(out):
        with open(out) as f:
            doc = json.load(f)
    doc.setdefault("profiles", {}).setdefault(args.env, {}).update(result)
    doc["date"] = time.strftime("%Y-%m-%d")
    doc["pipeline"] = ("collect -> VAR train -> PPO (frozen-VAR reward) -> "
                       "deterministic per-class eval (var_tpu_torch)")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
    print("E2E result:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
