"""End-to-end task-capability run of the port, arm or ai2thor profile
(twin of scripts/e2e_run.py): collect -> VAR -> PPO -> eval, then the
success rate with its binomial CI95.

    python -m var_tpu_torch.tools.e2e_run WORK [--env arms] [--device cpu] \\
        [--device-sim] [--num-envs 64] [--rl-steps 12000000] [--rl-lr 3e-5] \\
        [--collect-per-class 1600] [--var-epochs 60] \\
        [--device-eval-per-class 256] [--stages collect,var,rl,eval] \\
        [--set KNOB=VALUE ...]

The eval stage scores the final checkpoint on the host sims (the fused
testRL); --device-eval-per-class adds the device-sim evaluator
(RLDeviceSimEval) at that many episodes per class. Each run updates one
profile entry of the JSON at --out, under build/ by default. The device
is CUDA unless --device says otherwise. The grid recipe:

    python -m var_tpu_torch.tools.e2e_run WORK --env ai2thor --device-sim \
        --num-envs 64 --rl-steps 10000000 --rl-lr 6e-5 \
        --device-eval-per-class 256 \
        --set 'pretextCollectNum=[800,800,1600,1600,3200]'

The checkpoint sweep (scripts/success_curve.py, --select-best-per-class)
waits for ROADMAP item 10.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "build", "e2e", "E2E_port.json")


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
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def main(argv=None):
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.train.pretext import PretextTrainer
    from var_tpu_torch.train.rl import RLTrainer

    args = parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.dirname(out) == ROOT and os.path.basename(out).startswith(
            "E2E_"):
        raise SystemExit(f"--out {args.out}: the repo's E2E_*.json files "
                         "hold the JAX package's results")
    device = str(resolve_device(args.device))
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

    updates = int(cfg.RLTotalSteps) // (cfg.ppoNumSteps * cfg.RLNumEnvs)
    final_ckpt = os.path.join(args.work, "rl_model", "%.5i" % (updates - 1))
    if "rl" in stages:
        t0 = time.time()
        rl = RLTrainer(cfg, env=args.env, device=device)
        rl.load_pretext()
        rl.trainRL()
        timings["rl_train_s"] = time.time() - t0

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
