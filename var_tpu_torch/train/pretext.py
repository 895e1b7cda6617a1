"""VAR pretext training in PyTorch (port of var_tpu/train/pretext.py, the
device-resident path).

- The image set and the packed int16 clip bank are uploaded to the device
  once; each epoch uploads only its (steps, batch) index arrays.
- Each step gathers the batch with index_select, computes MFCC for the
  positive and the negative sound (ops/audio.py::sound_features; with
  audioBackend='pallas' the mel-log-DCT tail runs in the hand-written CUDA
  kernel), runs both encoders, the triplet margin loss and an L2-Adam
  update (torch Adam weight_decay: the decay is added to the gradient
  before the moments, as the JAX package's optax chain does) with the
  multistep LR schedule.
- The epoch is a Python loop that does not synchronise: the losses are
  read back once, at the end of the epoch.

The chunked (larger than device memory), streaming and heterogeneous
multi-bank paths, plotting and manual collection wait for later slices and
raise NotImplementedError where the JAX package would take them.
"""
from __future__ import annotations

import copy
import csv
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.data.triplets import load_env_data, save_shard
from var_tpu_torch.device import resolve_device
from var_tpu_torch.models.encoders import build_pretext_model
from var_tpu_torch.ops.audio import sound_features
from var_tpu_torch.ops.losses import triplet_margin_loss
from var_tpu_torch.train.checkpoint import (
    is_checkpoint,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)


def multistep_lr(base_lr: float, milestones_epochs, gamma: float,
                 steps_per_epoch: int,
                 start_step: int = 0) -> Callable[[int], float]:
    """MultiStepLR stepped per epoch, as a function of the optimizer step.

    `start_step` resumes mid-schedule: milestones already passed fold their
    decay into the base LR, the rest shift so they still fire at the right
    global epoch. Step s uses base * gamma^(number of boundaries <= s)."""
    boundaries = {}
    lr = base_lr
    for m in milestones_epochs:
        b = int(m) * steps_per_epoch - start_step
        if b <= 0:
            lr = lr * gamma
        else:
            boundaries[b] = gamma

    def schedule(step: int) -> float:
        v = lr
        for b, scale in sorted(boundaries.items()):
            if step >= b:
                v = v * scale
        return v

    return schedule


def make_optimizer(config, params, steps_per_epoch: int, lr=None,
                   start_step: int = 0):
    """(torch.optim.Adam with L2 weight decay, per-step LR schedule)."""
    base_lr = config.pretextLR if lr is None else lr
    if getattr(config, "pretextLRStep", "step") == "step":
        schedule = multistep_lr(
            base_lr, config.pretextLRDecayEpoch, config.pretextLRDecayGamma,
            steps_per_epoch, start_step)
    else:
        # any other value: no scheduler, constant LR
        def schedule(step: int) -> float:
            return base_lr
    optimizer = torch.optim.Adam(
        params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=config.pretextAdamL2)
    return optimizer, schedule


class PretextTrainer:
    """Collection and training driver. Runs on CUDA unless `device` names
    another device; asking for CUDA where there is none raises."""

    def __init__(self, config, device=None, audio: Optional[AudioStore] = None):
        self.config = config
        self.device = resolve_device(device)
        self.audio = audio
        self.model = None
        self.optimizer = None
        self.lr_fn = None
        self.step = 0
        self._param = None  # STFT params of the active dataset
        # (items, seconds) per epoch of the last trainRepresentation call;
        # each epoch's time ends at its loss readback, which synchronises
        self.epoch_stats = []

    # -- setup -------------------------------------------------------------

    def _ensure_audio(self):
        if self.audio is None:
            self.audio = AudioStore(self.config)
            self.audio.loadData()
        self._param = self.audio._default_param()
        return self.audio

    def init_model(self, seed: int = 0):
        """Fresh parameters from `seed`, drawn on the CPU so that every
        device starts from the same weights."""
        model = build_pretext_model(self.config)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        return self.model

    def setup_optimizer(self, steps_per_epoch: int, lr=None,
                        start_step: int = 0):
        self.optimizer, self.lr_fn = make_optimizer(
            self.config, self.model.parameters(), steps_per_epoch, lr=lr,
            start_step=start_step)
        self.step = 0

    # -- persistence ---------------------------------------------------------

    def save_model(self, epoch_label):
        path = os.path.join(self.config.pretextModelSaveDir, str(epoch_label))
        payload = {"params": self.model.state_dict(), "step": self.step}
        if self.optimizer is not None:
            payload["opt_state"] = self.optimizer.state_dict()
        save_checkpoint(path, payload)
        print("Model saved to", path)
        return path

    def loadPretextModel(self, path: Optional[str] = None):
        """Load weights for inference or fine-tuning. If `path` is a save
        directory rather than a checkpoint, the newest numeric checkpoint
        inside it is used."""
        path = self.config.pretextModelLoadDir if path is None else path
        if os.path.isdir(path) and not is_checkpoint(path):
            newest = latest_checkpoint(path)
            if newest is not None:
                path = newest
        if self.model is None:
            self.init_model()
        self.model.load_state_dict(load_checkpoint(path)["params"])
        print("Load weights for pretextModel from", path)
        return self.model

    # -- the train step ------------------------------------------------------

    def _features(self, bank, ids, zero):
        cfg = self.config
        return sound_features(
            bank["wav"].index_select(0, ids), bank["len"].index_select(0, ids),
            cfg.sound_dim[1], self._param, backend=cfg.audioBackend,
            zero_mask=zero)

    def _train_step_indexed(self, bank, img_idx, pos_idx, pos_zero, neg_idx,
                            neg_zero) -> torch.Tensor:
        """One step over the device-resident dataset: gathers, MFCC of both
        sounds (no gradient, as in the JAX step), forward, backward, Adam.
        Returns the loss as a device scalar, without synchronising."""
        image = bank["images"].index_select(0, img_idx).float() * (1.0 / 255.0)
        with torch.no_grad():
            pos_feat = self._features(bank, pos_idx, pos_zero)
            neg_feat = self._features(bank, neg_idx, neg_zero)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(image, pos_feat, neg_feat)
        loss = triplet_margin_loss(
            out["image_feat"], out["sound_feat_positive"],
            out["sound_feat_negative"], self.config.tripletMargin)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def _upload_dataset(self, ds):
        """Images + packed clip bank + lengths on the device, once."""
        if ds.has_sound:
            raise NotImplementedError(
                "shards with precomputed sound features take the streaming "
                "path, which is not ported yet")
        if not self.audio.params_homogeneous():
            raise NotImplementedError(
                "heterogeneous STFT presets need the multi-bank path, which "
                "is not ported yet")
        bank, lengths, ranges = self.audio.build_clip_bank()
        budget = int(getattr(self.config, "pretextHBMBudgetMB", 8192)) * 2 ** 20
        if ds.images.nbytes > budget - bank.nbytes:
            raise NotImplementedError(
                "the image set exceeds the device budget; the chunked path "
                "is not ported yet")

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return {"images": put(ds.images), "wav": put(bank),
                "len": put(lengths), "ranges": ranges}

    def _run_epoch_indexed(self, ds, bank, batch_size: int, epoch: int):
        """One epoch over the device-resident dataset. The last ragged
        batch wraps around so every step has the same shape."""
        order = ds.epoch_order(epoch, shuffle=True)
        n = len(order)
        steps = max(1, -(-n // batch_size))
        reps = -(-(steps * batch_size) // max(1, n))
        padded = np.tile(order, reps + 1)[: steps * batch_size]
        idx = padded.reshape(steps, batch_size)
        pos_ids, pos_zero, neg_ids, neg_zero = ds.epoch_clip_ids(
            bank["ranges"], epoch)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        img_i = put(idx.astype(np.int64))
        pos_i, pos_z = put(pos_ids[idx].astype(np.int64)), put(pos_zero[idx])
        neg_i, neg_z = put(neg_ids[idx].astype(np.int64)), put(neg_zero[idx])
        losses = [
            self._train_step_indexed(bank, img_i[s], pos_i[s], pos_z[s],
                                     neg_i[s], neg_z[s])
            for s in range(steps)]
        return torch.stack(losses).tolist(), n

    # -- the training loop ---------------------------------------------------

    def trainRepresentation(self, epoch: Optional[int] = None,
                            lr: Optional[float] = None, start_ep: int = 0,
                            dataset=None, log_csv: bool = True):
        cfg = self.config
        epoch = cfg.pretextEpoch if epoch is None else epoch
        print("Begin representation training")
        if getattr(cfg, "meshShape", None):
            raise NotImplementedError(
                "meshShape (data parallelism) is not ported yet")
        audio = self._ensure_audio()
        ds = dataset if dataset is not None else load_env_data(cfg, audio)
        if len(ds) == 0:
            raise RuntimeError("empty pretext dataset")

        batch_size = cfg.pretextTrainBatchSize
        # ceil: every epoch runs ceil(n/B) updates (wrap-around padding)
        steps_per_epoch = max(1, -(-len(ds) // batch_size))
        if self.model is None:
            self.init_model(seed=cfg.pretextEnvSeed)
        if cfg.pretextModelFineTune:
            if os.path.exists(cfg.pretextModelLoadDir):
                self.loadPretextModel()
            else:
                print(f"fine-tune requested but {cfg.pretextModelLoadDir!r} "
                      "not found; training from scratch")
        self.setup_optimizer(steps_per_epoch, lr=lr,
                             start_step=start_ep * steps_per_epoch)

        os.makedirs(cfg.pretextModelSaveDir, exist_ok=True)
        cfg.save_json(os.path.join(cfg.pretextModelSaveDir, "config.json"))
        bank = self._upload_dataset(ds)

        loss_list = []
        self.epoch_stats = []
        for ep in range(epoch):
            t_ep = time.perf_counter()
            losses, n = self._run_epoch_indexed(
                ds, bank, batch_size, start_ep + ep)
            self.epoch_stats.append((n, time.perf_counter() - t_ep))
            avg_loss = float(np.mean(losses))
            loss_list.append(avg_loss)
            print(f"epoch {start_ep + ep}: average loss {avg_loss:.5f}")
            if (ep + 1) % cfg.pretextModelSaveInterval == 0 or ep + 1 == epoch:
                self.save_model(start_ep + ep)

        n_triplets = sum(n for n, _ in self.epoch_stats)
        dt = sum(t for _, t in self.epoch_stats)
        if dt > 0 and n_triplets:
            print(f"pretext throughput: {n_triplets / dt:.1f} triplets/sec")

        if log_csv and cfg.pretextTrain:
            save_path = os.path.join(cfg.pretextModelSaveDir, "progress.csv")
            with open(save_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["avg_loss"])
                writer.writerows([v] for v in loss_list)
            print("results saved to", save_path)
        print("Pretext Training Complete")
        return loss_list

    # -- data collection -----------------------------------------------------

    def collectPretextData(self, fileName: Optional[str] = None):
        """Per-class quota collection over vectorized pretext envs, pickled
        into shards data_<epoch>.pickle; the file budget extends when quotas
        are unmet."""
        from var_tpu_torch.envs.vec.factory import make_vec_envs

        cfg = self.config
        print("Begin collecting...")
        target_num = list(cfg.pretextCollectNum)
        collected = [0] * (cfg.taskNum + 1)
        audio = self._ensure_audio()
        envs = make_vec_envs(
            env_name=cfg.pretextEnvName,
            seed=cfg.pretextEnvSeed,
            num_processes=cfg.pretextNumEnvs,
            gamma=None,
            randomCollect=True,
            config=cfg,
            audio=audio,
        )

        def harvest(observations):
            for pairs in envs.unwrapped.obs_list:
                gt = int(np.asarray(pairs["ground_truth"]).reshape(()))
                if collected[gt] < target_num[gt]:
                    observations.append(copy.deepcopy(pairs))
                    collected[gt] += 1

        observations: list = []
        envs.reset()
        harvest(observations)
        epoch = 0
        num_files = cfg.pretextDataNumFiles
        while epoch <= num_files:
            if epoch == num_files and sum(collected) < sum(target_num):
                num_files += 3
                print("Increase number of files")
            print("Number of pairs for each object", collected)
            for _episode in range(cfg.pretextDataEpisode):
                for _ in range(cfg.pretextEnvMaxSteps):
                    # the grid pretext sim teleports at random and takes
                    # no action; the arm's takes a zero vector
                    action = [np.zeros(cfg.pretextActionDim, np.float32)
                              if hasattr(cfg, "pretextActionDim") else 0
                              for _ in range(cfg.pretextNumEnvs)]
                    envs.step(action)
                    harvest(observations)
                if sum(collected) == sum(target_num):
                    break
            if fileName is None:
                name = f"data_{epoch}"
            else:
                # a caller-fixed name must not overwrite earlier shards
                name = fileName if epoch == 0 else f"{fileName}_{epoch}"
            save_shard(
                os.path.join(cfg.pretextDataDir[0], "train", name + ".pickle"),
                observations,
            )
            observations = []
            if sum(collected) == sum(target_num):
                break
            epoch += 1
        envs.close()
        return epoch

    # -- mode dispatch ---------------------------------------------------------

    def run(self):
        """Collection / training dispatch from config booleans."""
        from var_tpu_torch.config import gym_register

        cfg = self.config
        gym_register(cfg)
        if cfg.pretextManualControl or cfg.pretextManualCollect:
            raise NotImplementedError("manual collection is not ported yet")
        if cfg.pretextCollection:
            self.collectPretextData()
        if cfg.pretextTrain:
            self.trainRepresentation(epoch=cfg.pretextEpoch, lr=cfg.pretextLR)
        elif not cfg.pretextCollection:
            raise NotImplementedError(
                "testRepresentation (the embedding plot) is not ported yet")
