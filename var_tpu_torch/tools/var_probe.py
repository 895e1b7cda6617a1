"""VAR quality probe for the arm task: the reward landscape (twin of
scripts/var_probe.py).

Sweeps the gripper over the object row of several random layouts and
scores, per commanded class, whether the VAR reward dot(image_feat,
goal_feat) peaks over the commanded object, the property PPO training
depends on.

    python -m var_tpu_torch.tools.var_probe MODEL_DIR [N_LAYOUTS] \\
        [--device cpu] [--set KNOB=VALUE ...]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _class_feats(cfg, model, env, rng, device):
    """One goal embedding per class, as an RL episode draws its goal."""
    with torch.no_grad():
        return np.stack([
            model.encode_sound(torch.as_tensor(env.audio.genSoundFeat(
                intentIdx=c, featType="MFCC", rand_fn=rng.randint)[0],
                dtype=torch.float32, device=device)[None])[1][0].cpu().numpy()
            for c in range(cfg.taskNum)])


def _image_feats(model, imgs, device):
    x = torch.as_tensor(np.stack(imgs), dtype=torch.float32,
                        device=device) / 255.0
    with torch.no_grad():
        return torch.cat([model.encode_image(b)[1]
                          for b in x.split(256)]).cpu().numpy()


def _env(cfg, seed):
    from var_tpu_torch.envs.core import make

    env = make(cfg.RLEnvName)
    env.seed(seed)
    env.reset()
    return env


def probe(cfg, model, n_layouts=5, seed=11, verbose=True, device="cpu"):
    """(peak_accuracy, argmax_class_accuracy):
    - peak_accuracy: the share of (layout, class) pairs whose reward peak
      along the sweep lands on the commanded object;
    - argmax_class_accuracy: the share of on-object sweep points whose
      best-matching class embedding is the object under the gripper."""
    env = _env(cfg, seed)
    rng = np.random.RandomState(seed)
    feats = _class_feats(cfg, model, env, rng, device)
    peak_hits, cls_hits, cls_total = 0, 0, 0
    for _ in range(n_layouts):
        env._randomize()
        xs = env.objPose[:, 0].mean()
        ys = np.linspace(cfg.yMin, cfg.yMax, 61)
        imgs = []
        for y in ys:
            env.ee = np.array([xs, y])
            imgs.append(env.get_image().transpose(2, 0, 1))
        R = _image_feats(model, imgs, device) @ feats.T  # (61, taskNum)
        slot_of = env.objOrder  # object index -> row slot (= class)
        inv = {v: k for k, v in slot_of.items()}
        for cls in range(cfg.taskNum):
            ytrue = env.objPose[inv[cls]][1]
            peak_hits += int(abs(ys[np.argmax(R[:, cls])] - ytrue) <= 0.04)
        for j, y in enumerate(ys):
            env.ee = np.array([xs, y])
            hit = env.ray_test()
            if hit >= 0:
                cls_total += 1
                cls_hits += int(np.argmax(R[j]) == slot_of[hit])
    pk = peak_hits / (n_layouts * cfg.taskNum)
    ca = cls_hits / max(1, cls_total)
    if verbose:
        print(f"probe: peak_accuracy {pk:.2f} "
              f"({peak_hits}/{n_layouts * cfg.taskNum}), "
              f"on-object class accuracy {ca:.2f} ({cls_hits}/{cls_total})")
    return pk, ca


def probe_2d(cfg, model, n_layouts=3, seed=11, verbose=True, device="cpu"):
    """The (x, y) reward landscape scored against the ray-test hit box, the
    eval's success rule: per (layout, class) the peak's offset from the
    object and whether the peak pose's ray cast hits the commanded object.
    Returns (peak-in-hit-box rate, mean |peak offset| in m)."""
    env = _env(cfg, seed)
    rng = np.random.RandomState(seed)
    feats = _class_feats(cfg, model, env, rng, device)
    xs = np.linspace(cfg.xMin, cfg.xMax, 21)
    ys = np.linspace(cfg.yMin, cfg.yMax, 41)
    in_box, offsets = 0, []
    for _ in range(n_layouts):
        env._randomize()
        imgs = []
        for x in xs:
            for y in ys:
                env.ee = np.array([x, y])
                imgs.append(env.get_image().transpose(2, 0, 1))
        R = (_image_feats(model, imgs, device) @ feats.T).reshape(
            len(xs), len(ys), cfg.taskNum)
        inv = {v: k for k, v in env.objOrder.items()}
        for cls in range(cfg.taskNum):
            i, j = np.unravel_index(np.argmax(R[:, :, cls]), R.shape[:2])
            off = np.array([xs[i], ys[j]]) - env.objPose[inv[cls]]
            offsets.append(off)
            env.ee = np.array([xs[i], ys[j]])
            hit = env.ray_test()
            ok = hit >= 0 and env.objOrder[hit] == cls
            in_box += int(ok)
            if verbose:
                print(f"  cls{cls}: peak offset ({off[0]:+.3f},{off[1]:+.3f})"
                      f" R={R[i, j, cls]:.2f} in_box={ok}")
    n = n_layouts * cfg.taskNum
    rate = in_box / n
    mean_off = float(np.mean(np.linalg.norm(offsets, axis=1)))
    if verbose:
        print(f"probe_2d: peak-in-hit-box {rate:.2f} ({in_box}/{n}), "
              f"mean |peak offset| {mean_off * 100:.1f} cm")
    return rate, mean_off


def load_var(env_name, model_dir, set_items=(), device="cuda"):
    """(config, the VAR at model_dir in eval mode) for a probe."""
    from var_tpu_torch.cli import parse_set_items
    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.train.pretext import PretextTrainer

    device = resolve_device(device)
    cfg = main_config(env=env_name)
    if set_items:
        cfg.override(**parse_set_items(list(set_items)))
    cfg.override(pretextModelLoadDir=model_dir, RLTrain=True)
    gym_register(cfg, env=env_name)
    model = PretextTrainer(cfg, device=device).loadPretextModel()
    return cfg, model.eval().requires_grad_(False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dir")
    ap.add_argument("n_layouts", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], dest="set_items",
                    metavar="KNOB=VALUE")
    args = ap.parse_args(argv)
    cfg, model = load_var("arms", args.model_dir, args.set_items,
                          args.device)
    dev = next(model.parameters()).device
    return (probe(cfg, model, args.n_layouts, device=dev),
            probe_2d(cfg, model, max(1, args.n_layouts // 2), device=dev))


if __name__ == "__main__":
    main()
