"""VAR quality probe for the grid (iTHOR-profile) task (twin of
scripts/grid_probe.py).

Sweeps the agent over free cells and every heading of several floor plans
and scores, per commanded task, whether the VAR reward dot(image_feat,
goal_feat) peaks at a pose that sees the commanded object in the task's
done state, the landscape the grid policy climbs (reference:
Envs/vec_env/vec_pretext_normalize.py:96-101).

    python -m var_tpu_torch.tools.grid_probe MODEL_DIR [N_LAYOUTS] \\
        [--device cpu] [--set KNOB=VALUE ...]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from var_tpu_torch.tools.var_probe import _image_feats, load_var


def probe(cfg, model, n_layouts=3, seed=11, verbose=True, max_cells=40,
          return_per_class=False, device="cpu"):
    """(peak_accuracy, argmax_class_accuracy[, per_class]):
    - peak_accuracy: the share of (layout, task) pairs whose highest-reward
      pose is labelled with the commanded task (it sees exactly the
      commanded object, in the act's done state);
    - argmax_class_accuracy: the share of poses that see one object whose
      best-matching task embedding is the pose's label (the grid's
      labelling rule, grid_sim.py get_positive_negative)."""
    from var_tpu_torch.data.audio_store import Task
    from var_tpu_torch.envs.core import make

    env = make(cfg.RLEnvName)
    env.seed(seed)
    env.reset()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        feats = np.stack([
            model.encode_sound(torch.as_tensor(
                env.audio.getAudioFromTask(rng, t)[0], dtype=torch.float32,
                device=device)[None])[1][0].cpu().numpy()
            for t in env.taskList])

    rots = np.arange(0, 360, cfg.rotateStepDegrees, dtype=np.float64)
    peak_hits, cls_hits, cls_total, n_pairs = 0, 0, 0, 0
    pc_peak = np.zeros((cfg.taskNum, 2), np.int64)  # hits, totals
    pc_cls = np.zeros((cfg.taskNum, 2), np.int64)
    scenes = cfg.allScene[env.taskList[0].loc]
    for li in range(n_layouts):
        env.floor_plan = int(scenes[li % len(scenes)])
        env._build_world()
        free = [c for c in np.argwhere(env.grid == 0) if env._free(c)]
        if len(free) > max_cells:
            free = [free[i] for i in
                    rng.choice(len(free), max_cells, replace=False)]
        for cls, task in enumerate(env.taskList):
            env.task = task
            env.taskID = cls
            env._setup_task()
            # the VAR pairs a view with the utterance of the state it shows
            # (pretext_env_VAR.py:34-43), so the reward peaks in the task's
            # done state: flip the commanded object there
            env.objects[task.obj]["isToggled"] = (
                task.act == "ToggleObjectOn")
            imgs, labels = [], []
            for cell in free:
                for rot in rots:
                    env.pos = np.asarray(cell)
                    env.rot = float(rot)
                    visible = env.visible_objects()
                    if len(visible) == 1:
                        lbl = env.task2ID[Task(task.loc, visible[0],
                                               env._pos_act(visible[0]))]
                    else:
                        lbl = cfg.taskNum
                    imgs.append(env.get_image().transpose(2, 0, 1))
                    labels.append(lbl)
            labels = np.asarray(labels)
            R = _image_feats(model, imgs, device) @ feats.T  # (P, taskNum)
            n_pairs += 1
            hit = int(labels[int(np.argmax(R[:, cls]))] == cls)
            peak_hits += hit
            pc_peak[cls] += (hit, 1)
            on_obj = labels < cfg.taskNum
            if on_obj.any():
                cls_hits += int(np.sum(
                    np.argmax(R[on_obj], axis=1) == labels[on_obj]))
                cls_total += int(np.sum(on_obj))
                for c2 in range(cfg.taskNum):
                    sel = labels == c2
                    if sel.any():
                        pc_cls[c2] += (int(np.sum(
                            np.argmax(R[sel], axis=1) == c2)),
                            int(np.sum(sel)))
    peak_acc = peak_hits / max(1, n_pairs)
    cls_acc = cls_hits / max(1, cls_total)
    per_class = {
        str(task): {
            "peak": round(pc_peak[c, 0] / max(1, pc_peak[c, 1]), 3),
            "cls_acc": round(pc_cls[c, 0] / max(1, pc_cls[c, 1]), 3),
            "n_views": int(pc_cls[c, 1]),
        }
        for c, task in enumerate(env.taskList)
    }
    if verbose:
        print(f"probe: peak_accuracy {peak_acc:.2f} ({peak_hits}/{n_pairs}), "
              f"on-object class accuracy {cls_acc:.2f} "
              f"({cls_hits}/{cls_total})")
        for k, v in per_class.items():
            print(f"  {k}: peak {v['peak']:.2f} cls_acc {v['cls_acc']:.2f} "
                  f"({v['n_views']} views)")
    if return_per_class:
        return peak_acc, cls_acc, per_class
    return peak_acc, cls_acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_dir")
    ap.add_argument("n_layouts", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], dest="set_items",
                    metavar="KNOB=VALUE")
    args = ap.parse_args(argv)
    cfg, model = load_var("ai2thor", args.model_dir, args.set_items,
                          args.device)
    return probe(cfg, model, args.n_layouts, return_per_class=True,
                 device=next(model.parameters()).device)


if __name__ == "__main__":
    main()
