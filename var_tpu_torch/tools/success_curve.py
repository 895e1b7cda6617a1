"""Task-success learning curve of a run (twin of scripts/success_curve.py):
every saved checkpoint, or every k-th, scored by the device-resident
evaluator (RLDeviceSimEval's eval_batch).

    python -m var_tpu_torch.tools.success_curve arms WORK \\
        [--episodes-per-class 256] [--envs 128] [--every 1] [--device cpu] \\
        [--out CSV] [--set KNOB=VALUE ...]
    python -m var_tpu_torch.tools.success_curve --merge OUT CSV [CSV ...]

Writes <WORK>/rl_model/success_curve.csv, one row per checkpoint, with the
columns of artifacts/*_success_curve_*.csv: checkpoint, update, env_steps,
success_rate, ci95, class_0..class_{taskNum-1}. The net shapes, the
episode protocol and pretextModelLoadDir come from the run's own
rl_model/config.json. A run split over machines that keep no files
between calls sweeps each leg's checkpoints in its own call; --merge joins
those CSVs (the later row wins for a checkpoint swept twice) and prints
the best row.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time

from var_tpu_torch.tools.e2e_run import binom_ci95, build_config

# the snapshot's knobs that shape the nets and the episode protocol
SNAPSHOT_KNOBS = ("pretextModelLoadDir", "pretextEpoch", "representationDim",
                  "RLRecurrentSize", "RLRecurrentInputSize", "RLEnvMaxSteps",
                  "RLDeterministic", "computeDtype")


def list_checkpoints(rl_dir):
    """Numeric checkpoint dirs sorted by update label."""
    out = []
    for name in os.listdir(rl_dir):
        if name.isdigit() and os.path.isdir(os.path.join(rl_dir, name)):
            out.append((int(name), os.path.join(rl_dir, name)))
    return [p for _, p in sorted(out)]


def select_best(rows):
    """The best curve row: the highest success rate; ties go to the latest
    checkpoint (more training behind the same measured rate)."""
    if not rows:
        raise ValueError("empty curve")
    return max(rows, key=lambda r: (r["success_rate"], r["update"]))


def write_curve(rows, out_csv):
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def read_curve(path):
    """Rows of a curve CSV with the types run_curve gives them."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k in r:
            if k in ("update", "env_steps"):
                r[k] = int(r[k])
            elif k != "checkpoint":
                r[k] = float(r[k])
    return rows


def merge_curves(paths):
    """One curve from several, sorted by update; a later file's row wins
    for a checkpoint that two files hold."""
    by_update = {}
    for path in paths:
        for row in read_curve(path):
            by_update[row["update"]] = row
    return [by_update[u] for u in sorted(by_update)]


def class_rates(engine, n_classes, episodes_per_class, envs):
    """Per-class success rates of the engine's policy over whole eval
    batches of `envs` episodes, one class a batch, at least
    `episodes_per_class` episodes a class; one read at the end. Returns
    (rates, episodes a class)."""
    import torch

    batches = -(-episodes_per_class // envs)
    hits = []
    for c in range(n_classes):
        intent = torch.full((envs,), c, dtype=torch.int64,
                            device=engine.device)
        hits.append(sum(engine.eval_batch(intent)[0].sum()
                        for _ in range(batches)))
    per = batches * envs
    return [h / per for h in torch.stack(hits).tolist()], per


def run_curve(env, work, episodes_per_class=128, envs=64, every=1,
              out_csv=None, extra_set=None, device="cuda"):
    """Sweep every (k-th) checkpoint of a run with the device evaluator and
    write the rows as CSV; returns the rows. `extra_set` carries the run's
    --set overrides, for knobs the snapshot does not hold."""
    import torch

    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.train.rl import RLTrainer

    device = resolve_device(device)
    cfg = build_config(env, work, rl_steps=1, extra_set=extra_set)
    cfg.override(RLTrain=False)
    rl_dir = os.path.join(work, "rl_model")
    snap_path = os.path.join(rl_dir, "config.json")
    if os.path.exists(snap_path):
        with open(snap_path) as f:
            snap = json.load(f)
        cfg.override(**{k: snap[k] for k in SNAPSHOT_KNOBS if k in snap})
        steps_per_update = int(snap["ppoNumSteps"]) * int(snap["RLNumEnvs"])
    else:
        steps_per_update = int(cfg.ppoNumSteps) * int(cfg.RLNumEnvs)

    trainer = RLTrainer(cfg, env=env, device=device)
    trainer.load_pretext()
    engine = trainer.device_eval_engine(envs)
    # the sweep's own stream, as the JAX script's PRNGKey(3)
    engine.generator = torch.Generator(device=device).manual_seed(3)

    all_ckpts = list_checkpoints(rl_dir)
    if not all_ckpts:
        raise SystemExit(f"no checkpoints under {rl_dir}")
    ckpts = all_ckpts[::max(1, every)]
    if ckpts[-1] != all_ckpts[-1]:
        # the final checkpoint is the policy the run ships: never drop it
        ckpts.append(all_ckpts[-1])
    out_csv = out_csv or os.path.join(rl_dir, "success_curve.csv")
    n_classes = int(cfg.taskNum)

    rows = []
    for path in ckpts:
        trainer.policy.load_state_dict(trainer.load_policy_params(path))
        t0 = time.time()
        per_class, per = class_rates(engine, n_classes, episodes_per_class,
                                     envs)
        rate = sum(per_class) / n_classes
        ci = binom_ci95(rate, per * n_classes)
        update = int(os.path.basename(path))
        rows.append({"checkpoint": os.path.basename(path),
                     "update": update,
                     "env_steps": (update + 1) * steps_per_update,
                     "success_rate": round(rate, 4),
                     "ci95": round(ci, 4),
                     **{f"class_{c}": round(r, 4)
                        for c, r in enumerate(per_class)}})
        print(f"{os.path.basename(path)}: {rate:.3f} ±{ci:.3f} "
              f"({time.time() - t0:.1f}s, per-class "
              f"{[round(r, 2) for r in per_class]})")
    write_curve(rows, out_csv)
    print("curve saved to", out_csv)
    return rows


def _print_best(rows):
    best = select_best(rows)
    print(f"best checkpoint: {best['checkpoint']} "
          f"({best['success_rate']:.4f} ±{best['ci95']:.4f} at "
          f"{best['env_steps']} env-steps); final {rows[-1]['checkpoint']} "
          f"({rows[-1]['success_rate']:.4f} ±{rows[-1]['ci95']:.4f})")
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("env", nargs="?", choices=["arms", "ai2thor"])
    ap.add_argument("work", nargs="?")
    ap.add_argument("--episodes-per-class", type=int, default=128)
    ap.add_argument("--envs", type=int, default=64,
                    help="episodes per eval batch (one class per batch)")
    ap.add_argument("--every", type=int, default=1,
                    help="evaluate every k-th checkpoint")
    ap.add_argument("--out", default=None,
                    help="CSV path (default <work>/rl_model/success_curve.csv)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], metavar="KNOB=VALUE",
                    dest="set_items")
    ap.add_argument("--merge", nargs="+", metavar="CSV",
                    help="OUT followed by the curve CSVs to join")
    args = ap.parse_args(argv)
    if args.merge:
        if len(args.merge) < 2:
            ap.error("--merge needs OUT and at least one CSV")
        rows = merge_curves(args.merge[1:])
        write_curve(rows, args.merge[0])
        print("curve saved to", args.merge[0])
        return _print_best(rows)
    if not (args.env and args.work):
        ap.error("env and work are required unless --merge is given")
    rows = run_curve(args.env, args.work, args.episodes_per_class,
                     args.envs, args.every, args.out, args.set_items,
                     args.device)
    return _print_best(rows)


if __name__ == "__main__":
    main()
