"""Self-improvement loop: collect -> update the VAR -> fine-tune the policy
(port of var_tpu/train/self_improve.py; reference: examples/README.md:
31-45).

After a first VAR and policy are trained, each round collects fresh
label-free image/sound pairs, updates the VAR on every shard collected so
far, and fine-tunes the PPO policy against the updated frozen VAR, resuming
from the newest policy checkpoint (parameters, Adam state and the update
counter, so checkpoint labels continue).
"""
from __future__ import annotations

import os
from typing import Optional

from var_tpu_torch.config import gym_register
from var_tpu_torch.data.triplets import load_env_data
from var_tpu_torch.train.checkpoint import latest_checkpoint
from var_tpu_torch.train.pretext import PretextTrainer
from var_tpu_torch.train.rl import RLTrainer


def next_selfimprove_index(config) -> int:
    """The first unused selfimprove_<i> shard index, so that a later call
    never overwrites an earlier round's data."""
    train_dir = os.path.join(config.pretextDataDir[0], "train")
    base = 0
    while os.path.exists(os.path.join(train_dir,
                                      f"selfimprove_{base}.pickle")):
        base += 1
    return base


def self_improve(config, rounds: int = 1, env: Optional[str] = None,
                 pretext_epochs: Optional[int] = None,
                 rl_steps: Optional[int] = None, var_mode: str = "finetune",
                 device=None):
    """`rounds` improvement rounds on `device` (CUDA unless named). Each
    round:
      1. collects pretext pairs into selfimprove_<i>.pickle (the random
         collection protocol);
      2. updates the VAR on the accumulated shards: 'finetune' continues
         the current weights with the frozen image-sound association
         (VARFineTuneDataset, the reference's semantics); 'scratch'
         retrains from a fresh init with per-epoch resampling (VARDataset)
         over every shard;
      3. fine-tunes the policy against the updated VAR for `rl_steps` env
         steps (RLTotalSteps when None), from the newest checkpoint in
         RLModelSaveDir.
    """
    if var_mode not in ("finetune", "scratch"):
        raise ValueError(
            f"var_mode must be finetune|scratch, got {var_mode!r}")
    gym_register(config, env=env)
    base = next_selfimprove_index(config)
    epochs = pretext_epochs or config.pretextEpoch
    for r in range(rounds):
        print(f"=== self-improvement round {base + r} ({var_mode}) ===")
        pretext = PretextTrainer(config, device=device)
        pretext.collectPretextData(fileName=f"selfimprove_{base + r}")

        if var_mode == "finetune":
            config.override(pretextDataset="VARFineTuneDataset",
                            pretextModelFineTune=True)
            pretext.loadPretextModel()
        else:
            config.override(pretextDataset="VARDataset",
                            pretextModelFineTune=False)
            pretext = PretextTrainer(config, device=device,
                                     audio=pretext.audio)
        dataset = load_env_data(config, pretext._ensure_audio())
        pretext.trainRepresentation(epoch=epochs, dataset=dataset)
        # the newest VAR checkpoint is the RL phase's load target
        config.override(pretextModelLoadDir=os.path.join(
            config.pretextModelSaveDir, str(epochs - 1)))

        newest = latest_checkpoint(config.RLModelSaveDir)
        if newest is not None:
            config.override(RLModelLoadDir=newest)
        config.override(RLTrain=True, RLModelFineTune=True)
        rl = RLTrainer(config, env=env, device=device)
        rl.load_pretext()
        rl.trainRL(total_steps=rl_steps)
    print("self-improvement complete")
