"""Self-improvement demonstration (twin of scripts/self_improve_demo.py):
a weak VAR -> a policy trained to its ceiling -> eval, then `--rounds`
rounds of train/self_improve.py::self_improve(), each evaluated and
reward-landscape probed.

The weak VAR comes from the reference's collect quota (50 a class), which
underfits the builtin renders. Collected shards accumulate across rounds
(selfimprove_<i>), so the JSON records the whole improvement curve.

    python -m var_tpu_torch.tools.self_improve_demo WORK [--env arms] \\
        [--device cpu] [--rounds 1] [--var-mode scratch] \\
        [--weak-rl-steps 2500000] [--ft-rl-steps 4000000] \\
        [--eval-backend device] [--eval-per-class 256] [--eval-envs 128] \\
        [--stages weak,weak_eval,improve,final_eval] [--set KNOB=VALUE ...]

Each stage can run in its own call: a later call with --stages
improve,final_eval keeps the weak baseline and earlier rounds already in
--out (under build/ by default, never a repo E2E_*.json). The device
evaluator (RLDeviceSimEval's eval_batch, one class a batch) is the
default; --eval-backend host runs the fused host testRL.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from var_tpu_torch.tools import e2e_run

DEFAULT_OUT = os.path.join(e2e_run.ROOT, "build", "e2e",
                           "self_improve_port.json")


def run_eval(args, var_ckpt, rl_ckpt, device):
    """Deterministic per-class eval of one (VAR, policy) pair; returns
    (rate, episodes, extra). A fresh config each time: scale_eval_quotas
    edits it in place."""
    import torch

    from var_tpu_torch.tools.success_curve import class_rates
    from var_tpu_torch.train.rl import RLTrainer

    if args.eval_backend == "device":
        cfg = e2e_run.build_config(args.env, args.work, rl_steps=1,
                                   extra_set=args.set_items)
        cfg.override(RLTrain=False, RLDeviceSimEval=True,
                     pretextModelLoadDir=var_ckpt)
        tr = RLTrainer(cfg, env=args.env, device=device)
        tr.load_pretext()
        eng = tr.device_eval_engine(args.eval_envs)
        # the demo's own stream, as the JAX script's PRNGKey(11)
        eng.generator = torch.Generator(device=tr.device).manual_seed(11)
        tr.policy.load_state_dict(tr.load_policy_params(rl_ckpt))
        per_class, per = class_rates(eng, cfg.taskNum, args.eval_per_class,
                                     args.eval_envs)
        rate = sum(per_class) / cfg.taskNum
        n = per * cfg.taskNum
        return rate, n, {"per_class": [round(r, 3) for r in per_class],
                         "ci95": round(e2e_run.binom_ci95(rate, n), 4),
                         "evaluator": "device sim (RLDeviceSimEval)"}

    cfg = e2e_run.build_config(args.env, args.work, rl_steps=0,
                               num_envs=args.num_envs, device_sim=True,
                               extra_set=args.set_items)
    cfg.override(RLTrain=False, vecEnvBackend="dummy")
    per_env = max(1, args.eval_per_class // args.eval_envs)
    e2e_run.scale_eval_quotas(cfg, per_env)
    tr = RLTrainer(cfg, env=args.env, device=device)
    tr.load_pretext(path=var_ckpt)
    rate = tr.testRL(policy_path=rl_ckpt, num_envs=args.eval_envs)
    n = per_env * args.eval_envs * cfg.taskNum
    return rate, n, {"ci95": round(e2e_run.binom_ci95(rate, n), 4),
                     "evaluator": "host testRL (fused)"}


def run_probe(args, var_ckpt, device):
    """The reward-landscape probe of one VAR (tools/var_probe.py's probe_2d
    for the arm, tools/grid_probe.py for the grid), 8 layouts."""
    from var_tpu_torch.tools import grid_probe, var_probe

    cfg, model = var_probe.load_var(args.env, var_ckpt, args.set_items,
                                    device)
    if args.env == "arms":
        rate, mean_off = var_probe.probe_2d(cfg, model, n_layouts=8,
                                            verbose=False, device=device)
        return {"peak_in_hitbox": round(rate, 3),
                "mean_peak_offset_cm": round(mean_off * 100, 1),
                "n_samples": 8 * cfg.taskNum}
    pk, ca = grid_probe.probe(cfg, model, n_layouts=8, verbose=False,
                              device=device)
    return {"peak_accuracy": round(pk, 3),
            "on_object_class_accuracy": round(ca, 3),
            "n_samples": 8 * cfg.taskNum}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("work")
    ap.add_argument("--env", choices=["arms", "ai2thor"], default="arms")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weak-per-class", type=int, default=50)
    ap.add_argument("--weak-var-epochs", type=int, default=40)
    ap.add_argument("--weak-rl-steps", type=int, default=2_500_000)
    ap.add_argument("--improve-per-class", type=int, default=800)
    ap.add_argument("--ft-var-epochs", type=int, default=80)
    ap.add_argument("--ft-rl-steps", type=int, default=4_000_000)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--rl-lr", type=float, default=None)
    ap.add_argument("--ent-coef", type=float, default=0.02)
    ap.add_argument("--eval-per-class", type=int, default=256)
    ap.add_argument("--eval-envs", type=int, default=128)
    ap.add_argument("--eval-backend", default="device",
                    choices=["device", "host"])
    ap.add_argument("--var-mode", default="scratch",
                    choices=["finetune", "scratch"])
    ap.add_argument("--set", nargs="*", default=[], metavar="KNOB=VALUE",
                    dest="set_items",
                    help="overrides for every stage (collect, VAR, policy, "
                         "eval, probe)")
    ap.add_argument("--improve-set", nargs="*", default=[],
                    metavar="KNOB=VALUE", dest="improve_set_items",
                    help="overrides for the improvement rounds only")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--stages", default="weak,weak_eval,improve,final_eval")
    ap.add_argument("--out", default=DEFAULT_OUT)
    return ap.parse_args(argv)


def main(argv=None):
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.train.checkpoint import latest_checkpoint
    from var_tpu_torch.train.pretext import PretextTrainer
    from var_tpu_torch.train.rl import RLTrainer
    from var_tpu_torch.train.self_improve import self_improve

    args = parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.dirname(out) == e2e_run.ROOT and os.path.basename(
            out).startswith("E2E_"):
        raise SystemExit(f"--out {args.out}: the repo's E2E_*.json files "
                         "hold the JAX package's results")
    device = str(resolve_device(args.device))
    stages = set(args.stages.split(","))
    rl_dir = os.path.join(args.work, "rl_model")

    def config(rl_steps, per_class, var_epochs, extra=()):
        return e2e_run.build_config(
            args.env, args.work, rl_steps, args.rl_lr, args.num_envs,
            per_class, var_epochs, device_sim=True,
            extra_set=[f"ppoEntropyCoef={args.ent_coef}",
                       *args.set_items, *extra])

    def persist(result):
        result["hardware"] = e2e_run._hardware(device)
        doc = {}
        if os.path.exists(out):
            with open(out) as f:
                doc = json.load(f)
        doc.setdefault("profiles", {}).setdefault(args.env, {})[
            "self_improve_demo"] = result
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f, indent=2)

    result = {
        "pipeline": "weak VAR -> PPO -> eval, then self_improve() rounds "
                    f"({args.var_mode}) -> eval after each (var_tpu_torch)",
        "var_mode": args.var_mode,
        "weak": {"collect_per_class": args.weak_per_class,
                 "var_epochs": args.weak_var_epochs,
                 "rl_steps": args.weak_rl_steps},
        "recipe_set": list(args.set_items),
        "improve_set": list(args.improve_set_items),
        "rounds": [],
    }
    timings = {}
    if "weak" not in stages and os.path.exists(out):
        # a later call keeps the curve the earlier calls wrote
        with open(out) as f:
            prev = json.load(f).get("profiles", {}).get(
                args.env, {}).get("self_improve_demo", {})
        result["weak"] = prev.get("weak", result["weak"])
        result["rounds"] = prev.get("rounds", [])
        timings.update(prev.get("timings_s", {}))
    weak_var = os.path.join(args.work, "var_model",
                            str(args.weak_var_epochs - 1))
    ft_var = os.path.join(args.work, "var_model", str(args.ft_var_epochs - 1))

    if "weak" in stages:
        t0 = time.time()
        cfg = config(args.weak_rl_steps, args.weak_per_class,
                     args.weak_var_epochs)
        pretext = PretextTrainer(cfg, device=device)
        pretext.collectPretextData()
        pretext.trainRepresentation()
        timings["weak_var_s"] = time.time() - t0
        t0 = time.time()
        rl = RLTrainer(cfg, env=args.env, device=device)
        rl.load_pretext()
        rl.trainRL()
        timings["weak_rl_s"] = time.time() - t0

    if "weak_eval" in stages:
        t0 = time.time()
        ckpt = latest_checkpoint(rl_dir)
        rate, n, extra = run_eval(args, weak_var, ckpt, device)
        timings["weak_eval_s"] = time.time() - t0
        result["weak"].update(success_rate=rate, eval_episodes=n,
                              checkpoint=ckpt, **extra)
        print(f"WEAK baseline success: {rate:.4f} over {n} episodes")
        if not args.no_probe:
            result["weak"]["reward_landscape_probe"] = run_probe(
                args, weak_var, device)
            print("weak probe:", result["weak"]["reward_landscape_probe"])
        result["timings_s"] = timings
        persist(result)

    if "improve" in stages:
        # pretextModelLoadDir starts at the weak VAR; self_improve moves it
        # to each round's new VAR, so one config chains the rounds
        cfg = config(args.ft_rl_steps, args.improve_per_class,
                     args.weak_var_epochs, args.improve_set_items)
        for r in range(args.rounds):
            t0 = time.time()
            self_improve(cfg, rounds=1, env=args.env,
                         pretext_epochs=args.ft_var_epochs,
                         rl_steps=args.ft_rl_steps, var_mode=args.var_mode,
                         device=device)
            rec = {"round": len(result["rounds"]) + 1,
                   "var_mode": args.var_mode,
                   "collect_per_class": args.improve_per_class,
                   "ft_var_epochs": args.ft_var_epochs,
                   "ft_rl_steps": args.ft_rl_steps,
                   "train_s": time.time() - t0}
            if "final_eval" in stages:
                t0 = time.time()
                ckpt = latest_checkpoint(rl_dir)
                rate, n, extra = run_eval(args, ft_var, ckpt, device)
                rec.update(success_rate=rate, eval_episodes=n,
                           checkpoint=ckpt, eval_s=time.time() - t0, **extra)
                print(f"ROUND {rec['round']} success: {rate:.4f} over {n} "
                      "episodes")
                if not args.no_probe:
                    rec["reward_landscape_probe"] = run_probe(args, ft_var,
                                                              device)
                    print(f"round {rec['round']} probe:",
                          rec["reward_landscape_probe"])
            result["rounds"].append(rec)
            result["timings_s"] = timings
            persist(result)

    result["timings_s"] = timings
    persist(result)
    print("self-improve demo result:", json.dumps(result))
    return result


if __name__ == "__main__":
    main()
