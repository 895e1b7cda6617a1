"""VAR pretext training in PyTorch (port of var_tpu/train/pretext.py).

Every step computes MFCC for the positive and the negative sound
(ops/audio.py::sound_features; with audioBackend='pallas' the mel-log-DCT
tail runs in the hand-written CUDA kernel), runs both encoders, the
triplet margin loss and an L2-Adam update (torch Adam weight_decay: the
decay is added to the gradient before the moments, as the JAX package's
optax chain does) with the multistep LR schedule. The epoch is a Python
loop that does not synchronise: the losses are read back once, at its end.
_upload_dataset picks one of four paths:
- resident: the image set and the packed int16 clip bank live on the
  device; each epoch uploads only its (steps, batch) index arrays;
- multi-bank (heterogeneous STFT presets, the arm 'mix'): one packed bank
  per STFT param set; a step runs one MFCC per param set and merges the
  rows by the bank selector and the zero mask;
- chunked (an image set larger than pretextHBMBudgetMB): the clip bank
  stays resident, the images go up in fixed contiguous slabs, the next
  slab's upload overlapping the current slab's steps;
- streaming (shards with precomputed features): host batches with one
  batch's upload in flight.
On CUDA the chunk and batch uploads copy from pinned memory on a side
stream; the compute stream waits on their events.

With meshShape={'dp': n} (parallel/mesh.py; one process per rank, started
by the entry point) every rank holds the whole dataset and bank, and each
step's (B,) index row, or a streamed batch, is split into n contiguous
blocks: each rank runs the MFCC and both encoders on its block, its loss
is the block's sum over the global B, and the gradients (and the loss)
are summed over the ranks before Adam, so every rank steps identically and
the run computes what dp=1 computes. Only rank 0 writes checkpoints,
config.json and progress.csv.

testRepresentation writes the embedding points to representation.npz (the
PNG plot draws with matplotlib, which the port does not use).
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
from var_tpu_torch.data.triplets import TripletBatch, load_env_data, save_shard
from var_tpu_torch.device import resolve_device
from var_tpu_torch.models.encoders import build_pretext_model
from var_tpu_torch.ops.audio import sound_features
from var_tpu_torch.ops.losses import triplet_margin_loss
from var_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    barrier,
    broadcast_,
    build_mesh,
    group_rank,
)
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
        self._h2d_stream = None  # CUDA side stream of the async uploads
        # (items, seconds) per epoch of the last trainRepresentation call;
        # each epoch's time ends at its loss readback, which synchronises
        self.epoch_stats = []
        self.mesh = None  # set by trainRepresentation under meshShape

    @property
    def lead(self) -> bool:
        """Whether this process writes files and prints (rank 0)."""
        return self.mesh is None or self.mesh.lead

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
        if self.lead:
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

    def _multi_features(self, bank, ids, sel, zero):
        """One MFCC per STFT param set, each over the rows its bank holds
        (the others masked to zero), summed: every row has one bank."""
        cfg = self.config
        total = None
        for k, p in enumerate(bank["multi_params"]):
            wav, lens = bank["multi_wav"][k], bank["multi_len"][k]
            f = sound_features(
                wav.index_select(0, ids[:, k]), lens.index_select(0, ids[:, k]),
                cfg.sound_dim[1], p, backend=cfg.audioBackend,
                zero_mask=torch.logical_or(~sel[:, k], zero))
            total = f if total is None else total + f
        return total

    def _local(self, *xs):
        """This rank's block of each (B, ...) batch tensor (all of it
        without a mesh)."""
        if self.mesh is None:
            return xs
        return tuple(self.mesh.shard(x, 0, "the batch") for x in xs)

    def _optimize(self, image, pos_feat, neg_feat,
                  total: Optional[int] = None) -> torch.Tensor:
        """Forward, backward and Adam on one batch (uint8 images are scaled
        here). Under a mesh the batch is this rank's block of `total`
        items: its mean loss is scaled to the block's share, and the
        gradients and the loss are summed over the ranks before Adam.
        Returns the (global) loss as a device scalar, without
        synchronising."""
        if image.dtype == torch.uint8:
            image = image.float() * (1.0 / 255.0)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(image, pos_feat, neg_feat)
        loss = triplet_margin_loss(
            out["image_feat"], out["sound_feat_positive"],
            out["sound_feat_negative"], self.config.tripletMargin)
        if self.mesh is not None:
            loss = loss * (image.shape[0] / total)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            params = list(self.model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            loss = loss.reshape(1)
            all_reduce_sum_([p.grad for p in params] + [loss], self.mesh)
            loss = loss[0]
        self.optimizer.step()
        self.step += 1
        return loss

    def _train_step_indexed(self, bank, img_idx, pos_idx, pos_zero, neg_idx,
                            neg_zero) -> torch.Tensor:
        """One step over the device-resident dataset: gathers, MFCC of both
        sounds (no gradient, as in the JAX step), then _optimize."""
        total = img_idx.shape[0]
        img_idx, pos_idx, pos_zero, neg_idx, neg_zero = self._local(
            img_idx, pos_idx, pos_zero, neg_idx, neg_zero)
        image = bank["images"].index_select(0, img_idx)
        with torch.no_grad():
            pos_feat = self._features(bank, pos_idx, pos_zero)
            neg_feat = self._features(bank, neg_idx, neg_zero)
        return self._optimize(image, pos_feat, neg_feat, total)

    def _train_step_multi(self, bank, img_idx, pos_ids, pos_sel, pos_zero,
                          neg_ids, neg_sel, neg_zero) -> torch.Tensor:
        """The multi-bank step: ids and selectors are (B, K), one column per
        STFT param set."""
        total = img_idx.shape[0]
        (img_idx, pos_ids, pos_sel, pos_zero, neg_ids, neg_sel,
         neg_zero) = self._local(img_idx, pos_ids, pos_sel, pos_zero,
                                 neg_ids, neg_sel, neg_zero)
        image = bank["images"].index_select(0, img_idx)
        with torch.no_grad():
            pos_feat = self._multi_features(bank, pos_ids, pos_sel, pos_zero)
            neg_feat = self._multi_features(bank, neg_ids, neg_sel, neg_zero)
        return self._optimize(image, pos_feat, neg_feat, total)

    def _train_step_wav(self, image, pos_wav, pos_len, pos_zero, neg_wav,
                        neg_len, neg_zero,
                        total: Optional[int] = None) -> torch.Tensor:
        """The streaming step over uploaded packed waveforms (under a mesh,
        this rank's block of a batch of `total`)."""
        cfg = self.config
        with torch.no_grad():
            pos_feat = sound_features(pos_wav, pos_len, cfg.sound_dim[1],
                                      self._param, backend=cfg.audioBackend,
                                      zero_mask=pos_zero)
            neg_feat = sound_features(neg_wav, neg_len, cfg.sound_dim[1],
                                      self._param, backend=cfg.audioBackend,
                                      zero_mask=neg_zero)
        return self._optimize(image, pos_feat, neg_feat, total)

    def _train_step_feat(self, image, pos_feat, neg_feat,
                         total: Optional[int] = None) -> torch.Tensor:
        """The streaming step over precomputed features (pretextDataHasSound
        shards): no MFCC, so no kernel launch."""
        return self._optimize(image, pos_feat, neg_feat, total)

    # -- uploads ---------------------------------------------------------------

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_async(self, arrays):
        """Host arrays to the device without waiting: on CUDA, copies from
        pinned memory on a side stream; returns (tensors, the CUDA event
        that marks them ready, or None on the CPU). Callable from a worker
        thread. The caching host allocator keeps a pinned buffer until the
        copy that reads it has run, so the host copies may be dropped."""
        if self.device.type != "cuda":
            return tuple(self._put(a) for a in arrays), None
        if self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._h2d_stream):
            out = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                    self.device, non_blocking=True) for a in arrays)
            ready = torch.cuda.Event()
            ready.record(self._h2d_stream)
        return out, ready

    def _wait_upload(self, tensors, ready):
        """Make the compute stream wait for an _upload_async, and tell the
        allocator that stream uses the tensors, so their memory is not
        handed to another upload while a step may still read it."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    def _upload_dataset(self, ds):
        """The dataset's device form, which picks the epoch path: resident
        (images + packed clip bank + lengths), chunked (the bank only, when
        the images exceed pretextHBMBudgetMB less the bank), multi-bank
        (heterogeneous STFT presets of the arm store), or None for
        streaming (shards with precomputed features, or a heterogeneous
        ai2thor store)."""
        if ds.has_sound or len(ds) == 0:
            return None
        if self.audio.params_homogeneous():
            bank, lengths, ranges = self.audio.build_clip_bank()
            budget = int(getattr(self.config, "pretextHBMBudgetMB",
                                 8192)) * 2 ** 20
            free = budget - bank.nbytes
            if ds.images.nbytes > free:
                return {"chunked": True, "wav": self._put(bank),
                        "len": self._put(lengths), "ranges": ranges,
                        # half the rest per chunk: one in use, one in flight
                        "chunk_bytes": max(2 ** 20, free // 2)}
            return {"images": self._put(ds.images), "wav": self._put(bank),
                    "len": self._put(lengths), "ranges": ranges}
        if self.audio.env_type != "pybullet":
            return None
        banks, entries = self.audio.build_clip_banks()
        # the step reads the param sets from the upload, so a new upload
        # with other presets takes its own params
        return {"images": self._put(ds.images),
                "multi_params": tuple(p for p, _, _ in banks),
                "multi_wav": tuple(self._put(w) for _, w, _ in banks),
                "multi_len": tuple(self._put(n) for _, _, n in banks),
                "entries": entries}

    # -- epochs ------------------------------------------------------------------

    def _run_epoch_indexed(self, ds, bank, batch_size: int, epoch: int):
        """One epoch over the device-resident dataset (single or multi
        bank). The last ragged batch wraps around so every step has the
        same shape."""
        order = ds.epoch_order(epoch, shuffle=True)
        n = len(order)
        steps = max(1, -(-n // batch_size))
        reps = -(-(steps * batch_size) // max(1, n))
        idx = np.tile(order, reps + 1)[: steps * batch_size].reshape(
            steps, batch_size)
        img_i = self._put(idx.astype(np.int64))
        if "multi_wav" in bank:
            pos, neg = ds.epoch_clip_ids_multi(
                bank["entries"], len(bank["multi_wav"]), epoch)
            cols = [self._put(a[idx].astype(np.int64) if a.dtype != bool
                              else a[idx]) for a in (*pos, *neg)]
            losses = [self._train_step_multi(bank, img_i[s],
                                             *(c[s] for c in cols))
                      for s in range(steps)]
            return torch.stack(losses).tolist(), n
        pos_ids, pos_zero, neg_ids, neg_zero = ds.epoch_clip_ids(
            bank["ranges"], epoch)
        put = self._put
        pos_i, pos_z = put(pos_ids[idx].astype(np.int64)), put(pos_zero[idx])
        neg_i, neg_z = put(neg_ids[idx].astype(np.int64)), put(neg_zero[idx])
        losses = [
            self._train_step_indexed(bank, img_i[s], pos_i[s], pos_z[s],
                                     neg_i[s], neg_z[s])
            for s in range(steps)]
        return torch.stack(losses).tolist(), n

    def _run_epoch_chunked(self, ds, bank, batch_size: int, epoch: int):
        """One epoch of an image set larger than the device budget.

        Items stay in fixed contiguous slabs of the image array, so a chunk
        uploads as one contiguous copy. The visit order within a slab is
        the global epoch order restricted to it, so a single slab gives the
        resident path's losses; an item stays in its slab across epochs,
        so batches mix within one slab at a time. Slab k+1's upload runs on
        a worker thread (and on CUDA a side stream) while slab k's steps
        run; a ragged last slab wraps within itself, so every slab runs
        chunk_items // batch_size steps."""
        from concurrent.futures import ThreadPoolExecutor

        item_bytes = int(ds.images[0].nbytes)
        chunk_items = max(batch_size,
                          int(bank["chunk_bytes"] // item_bytes)
                          // batch_size * batch_size)
        order = ds.epoch_order(epoch, shuffle=True)
        n = len(order)
        pos_ids, pos_zero, neg_ids, neg_zero = ds.epoch_clip_ids(
            bank["ranges"], epoch)
        n_chunks = -(-n // chunk_items)
        slab_of = order // chunk_items
        S = chunk_items // batch_size
        sh = (S, batch_size)

        def produce(ci):
            a = ci * chunk_items
            b = min(a + chunk_items, n)
            img = ds.images[a:b]
            if b - a < chunk_items:  # ragged final slab: pad by wrapping
                reps = -(-chunk_items // (b - a))
                img = np.concatenate([img] * reps)[:chunk_items]
            visit = order[slab_of == ci]
            if len(visit) < chunk_items:
                reps = -(-chunk_items // max(1, len(visit)))
                visit = np.tile(visit, reps)[:chunk_items]
            local = (visit - a).astype(np.int64) % (b - a)
            return self._upload_async((
                img, local.reshape(sh),
                pos_ids[visit].astype(np.int64).reshape(sh),
                pos_zero[visit].reshape(sh),
                neg_ids[visit].astype(np.int64).reshape(sh),
                neg_zero[visit].reshape(sh)))

        losses = []
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="chunk-upload") as ex:
            fut = ex.submit(produce, 0)
            for ci in range(n_chunks):
                d_img, l_i, p_i, p_z, n_i, n_z = self._wait_upload(
                    *fut.result())
                if ci + 1 < n_chunks:
                    fut = ex.submit(produce, ci + 1)
                slab = {"images": d_img, "wav": bank["wav"],
                        "len": bank["len"]}
                losses += [self._train_step_indexed(slab, l_i[s], p_i[s],
                                                    p_z[s], n_i[s], n_z[s])
                           for s in range(S)]
        return torch.stack(losses).tolist(), n

    def _device_batch(self, batch: TripletBatch):
        """A host batch's upload: (tensors, ready) as _upload_async.
        Images go as uint8 and waveforms as int16, scaled on the device.
        Under a mesh only this rank's block goes up."""
        arrays = (batch.image,)
        if batch.pos_feat is not None:
            arrays += (batch.pos_feat, batch.neg_feat)
        else:
            arrays += (batch.pos_wav, batch.pos_len, batch.pos_zero,
                       batch.neg_wav, batch.neg_len, batch.neg_zero)
        return self._upload_async(self._local(*arrays))

    def _prefetch_epoch(self, ds, batch_size: int, epoch: int):
        """The streaming path's batches, (host batch, device tensors), with
        the next batch assembled and uploaded on a worker thread while the
        current one trains: one batch in flight."""
        from concurrent.futures import ThreadPoolExecutor

        it = ds.iter_epoch(batch_size, epoch=epoch, shuffle=True,
                           drop_last=False)

        def produce():
            b = next(it, None)
            return None if b is None else (b, self._device_batch(b))

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="h2d-prefetch") as ex:
            fut = ex.submit(produce)
            while True:
                item = fut.result()
                if item is None:
                    return
                fut = ex.submit(produce)
                yield item[0], self._wait_upload(*item[1])

    def _run_epoch_streaming(self, ds, batch_size: int, epoch: int):
        losses, n = [], 0
        for batch, dev in self._prefetch_epoch(ds, batch_size, epoch):
            total = len(batch.ground_truth)
            if batch.pos_feat is not None:
                losses.append(self._train_step_feat(*dev, total))
            else:
                losses.append(self._train_step_wav(*dev, total))
            n += total
        return torch.stack(losses).tolist(), n

    # -- the training loop ---------------------------------------------------

    def trainRepresentation(self, epoch: Optional[int] = None,
                            lr: Optional[float] = None, start_ep: int = 0,
                            dataset=None, log_csv: bool = True):
        cfg = self.config
        epoch = cfg.pretextEpoch if epoch is None else epoch
        self.mesh = None
        if getattr(cfg, "meshShape", None):
            # every rank of the group: see the module docstring
            self.mesh = build_mesh(cfg.meshShape, self.device)
            self.mesh.local(cfg.pretextTrainBatchSize,
                            "pretextTrainBatchSize")
        if self.lead:
            print("Begin representation training")
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
        # every rank starts from rank 0's weights
        broadcast_(list(self.model.state_dict().values()), self.mesh)
        self.setup_optimizer(steps_per_epoch, lr=lr,
                             start_step=start_ep * steps_per_epoch)

        if self.lead:
            os.makedirs(cfg.pretextModelSaveDir, exist_ok=True)
            cfg.save_json(os.path.join(cfg.pretextModelSaveDir,
                                       "config.json"))
        bank = self._upload_dataset(ds)

        loss_list = []
        self.epoch_stats = []
        for ep in range(epoch):
            t_ep = time.perf_counter()
            if bank is None:
                losses, n = self._run_epoch_streaming(
                    ds, batch_size, start_ep + ep)
            elif bank.get("chunked"):
                losses, n = self._run_epoch_chunked(
                    ds, bank, batch_size, start_ep + ep)
            else:
                losses, n = self._run_epoch_indexed(
                    ds, bank, batch_size, start_ep + ep)
            self.epoch_stats.append((n, time.perf_counter() - t_ep))
            avg_loss = float(np.mean(losses))
            loss_list.append(avg_loss)
            if self.lead:
                print(f"epoch {start_ep + ep}: average loss {avg_loss:.5f}")
            if (ep + 1) % cfg.pretextModelSaveInterval == 0 or ep + 1 == epoch:
                self.save_model(start_ep + ep)

        n_triplets = sum(n for n, _ in self.epoch_stats)
        dt = sum(t for _, t in self.epoch_stats)
        if dt > 0 and n_triplets and self.lead:
            print(f"pretext throughput: {n_triplets / dt:.1f} triplets/sec")

        if log_csv and cfg.pretextTrain and self.lead:
            save_path = os.path.join(cfg.pretextModelSaveDir, "progress.csv")
            with open(save_path, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["avg_loss"])
                writer.writerows([v] for v in loss_list)
            print("results saved to", save_path)
        if self.lead:
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

    # -- embedding export ------------------------------------------------------

    @torch.no_grad()
    def project_embeddings(self, dataset, max_batches: Optional[int] = None):
        """Images and positive sounds through the VAR, in item order:
        {'img': (N, D+1), 'sound': (N, D+1)}, the label in the last
        column. Shards without features take one MFCC per batch, the
        positive sound's."""
        cfg = self.config
        self._ensure_audio()
        max_batches = cfg.plotNumBatch if max_batches is None else max_batches
        img_pts, sound_pts = [], []
        for n, batch in enumerate(dataset.iter_epoch(
                cfg.pretextTestBatchSize, epoch=0, shuffle=False)):
            if n >= max_batches:
                break
            if batch.pos_feat is not None:
                pos_feat = self._put(batch.pos_feat)
            else:
                pos_feat = sound_features(
                    self._put(batch.pos_wav), self._put(batch.pos_len),
                    cfg.sound_dim[1], self._param, backend=cfg.audioBackend,
                    zero_mask=self._put(batch.pos_zero))
            image = self._put(batch.image).float() * (1.0 / 255.0)
            img_f = self.model.encode_image(image)[1]
            snd_f = self.model.encode_sound(pos_feat)[1]
            gt = batch.ground_truth[:, None].astype(np.float32)
            img_pts.append(np.concatenate([img_f.cpu().numpy(), gt], axis=1))
            sound_pts.append(np.concatenate([snd_f.cpu().numpy(), gt],
                                            axis=1))
        return {"img": np.concatenate(img_pts, axis=0),
                "sound": np.concatenate(sound_pts, axis=0)}

    def testRepresentation(self, dataset=None):
        """pretextTestMethod 'plot' (the arm profile, which lists no
        method, takes it too): the points the JAX package's plot draws,
        written to <pretextModelSaveDir>/representation.npz ('img' and
        'sound', each (N, D+1) with the label column); returns its path."""
        cfg = self.config
        method = getattr(cfg, "pretextTestMethod", "plot")
        if method != "plot":
            raise NotImplementedError(method)
        ds = dataset if dataset is not None else load_env_data(
            cfg, self._ensure_audio())
        if self.model is None:
            self.loadPretextModel()
        self.model.eval()
        pts = self.project_embeddings(ds)
        os.makedirs(cfg.pretextModelSaveDir, exist_ok=True)
        path = os.path.join(cfg.pretextModelSaveDir, "representation.npz")
        np.savez(path, img=pts["img"], sound=pts["sound"])
        print("representation points saved to", path)
        return path

    # -- manual collection -----------------------------------------------------

    def manuallyCollectPretextData(self, input_fn=None,
                                   max_steps: Optional[int] = None):
        """Manual triplet collection on one pretext sim. Commands from
        `input_fn` (default: single keys on a TTY, else lines): any other
        command steps the sim, 'r' stores the current pair, 'z' flushes
        the stored pairs to a timestamped shard, 'q'/'quit' or the end of
        input stops; the last pairs are flushed on exit. Returns the last
        shard's path (None if nothing was left to flush)."""
        from var_tpu_torch.envs.core import make
        from var_tpu_torch.utils.teleop import make_input_fn

        cfg = self.config
        if cfg.realTimeVec:
            raise NotImplementedError(
                "realTimeVec draws with matplotlib, which the port does not "
                "use (ROADMAP 'Modules left to port': Options that still "
                "raise)")
        self._ensure_audio()
        env = make(cfg.pretextEnvName)
        env.unwrapped.audio = self.audio
        env.seed(cfg.pretextEnvSeed)
        input_fn = input_fn or make_input_fn("collect [step|r|z|quit]> ")
        obs = env.reset()
        steps = 0
        while max_steps is None or steps < max_steps:
            try:
                cmd = (input_fn() or "").strip()
            except (EOFError, StopIteration):
                break
            if cmd in ("quit", "q"):
                break
            if cmd == "r":
                env.unwrapped.saved_pairs.append(
                    {k: np.asarray(v) for k, v in obs.items()})
                print("Number of pairs collected",
                      len(env.unwrapped.saved_pairs))
                continue
            if cmd == "z":
                env.unwrapped.saveManualPairs()
                continue
            obs, _, done, _ = env.step(
                np.zeros(getattr(cfg, "pretextActionDim", (1,)), np.float32))
            steps += 1
            if done:
                obs = env.reset()
        path = env.unwrapped.saveManualPairs()
        env.close()
        return path

    # -- mode dispatch ---------------------------------------------------------

    def run(self):
        """Collection / training / testing dispatch from config booleans."""
        from var_tpu_torch.config import gym_register

        cfg = self.config
        gym_register(cfg)
        if cfg.pretextManualControl or cfg.pretextManualCollect:
            self.manuallyCollectPretextData()
            return
        if cfg.pretextCollection:
            # under meshShape rank 0 collects and the others wait for it
            if group_rank() == 0:
                self.collectPretextData()
            barrier()
        if cfg.pretextTrain:
            self.trainRepresentation(epoch=cfg.pretextEpoch, lr=cfg.pretextLR)
        elif not cfg.pretextCollection:
            self.testRepresentation()
