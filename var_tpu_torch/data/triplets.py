"""Triplet datasets and shard IO for VAR pretext training (port of
var_tpu/data/triplets.py).

Pickle shards hold dicts {'image' (3,96,96) u8, 'ground_truth' int,
optional 'sound_negative_id' int, optional precomputed 'sound_positive' /
'sound_negative' features}; sounds are paired to images by class:

- VARDataset: the image<->sound association is re-sampled every epoch;
- VARFineTuneDataset: the association is sampled once and frozen;
- class `taskNum` is the empty intent, whose sound feature is zero.

The epoch RNG draws exactly as the JAX package's, so both packages give
the same epoch order and clip ids from one dataset.
"""
from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from var_tpu_torch.data.audio_store import AudioStore


@dataclass
class TripletBatch:
    """One host batch for the streaming path. Images stay uint8 and
    waveforms int16: the /255 and /32768 scalings run on the device, after
    the smaller uploads."""

    image: np.ndarray        # (B, 3, 96, 96) uint8
    pos_wav: np.ndarray      # (B, buf_len) int16 packed waveforms
    pos_len: np.ndarray      # (B,) int32
    pos_zero: np.ndarray     # (B,) bool, empty-intent rows
    neg_wav: np.ndarray
    neg_len: np.ndarray
    neg_zero: np.ndarray
    ground_truth: np.ndarray  # (B,) int32
    # precomputed features (pretextDataHasSound shards, or the host MFCC
    # of heterogeneous presets)
    pos_feat: Optional[np.ndarray] = None  # (B, 1, T, 40)
    neg_feat: Optional[np.ndarray] = None


def load_shard(path: str) -> List[dict]:
    # shards are written by this package's (or var_tpu's) collector only
    with open(path, "rb") as f:
        return pickle.load(f)


def save_shard(path: str, pairs: List[dict]):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(pairs, f, protocol=pickle.HIGHEST_PROTOCOL)


class TripletDataset:
    """VARDataset semantics over concatenated shards."""

    resample_each_epoch = True  # VARDataset; False -> VARFineTuneDataset

    def __init__(self, shard_paths: List[str], config, audio: AudioStore,
                 seed: int = 0):
        self.config = config
        self.audio = audio
        self.rng = np.random.RandomState(seed)

        images, gts, sn_ids, sn_random = [], [], [], []
        pos_feats, neg_feats = [], []
        self.has_sound = False
        for p in shard_paths:
            for item in load_shard(p):
                images.append(np.asarray(item["image"], dtype=np.uint8))
                gt = int(np.asarray(item["ground_truth"]).reshape(()))
                gts.append(gt)
                if "sound_negative" in item:
                    # precomputed features: the streaming path's input
                    self.has_sound = True
                    pos_feats.append(np.asarray(item["sound_positive"],
                                                np.float32))
                    neg_feats.append(np.asarray(item["sound_negative"],
                                                np.float32))
                    sn_ids.append(-1)
                    sn_random.append(False)
                elif "sound_negative_id" in item:
                    sn_ids.append(
                        int(np.asarray(item["sound_negative_id"]).reshape(())))
                    sn_random.append(False)
                else:
                    # no negative id in the shard: this draw is the frozen
                    # association of VARFineTuneDataset; VARDataset redraws
                    # per epoch (_epoch_sn_ids)
                    sn = int(self.rng.randint(0, config.taskNum))
                    if sn == gt:
                        sn = config.taskNum
                    sn_ids.append(sn)
                    sn_random.append(True)
        self.images = (np.stack(images) if images
                       else np.zeros((0, 3, 96, 96), np.uint8))
        self.gts = np.asarray(gts, dtype=np.int32)
        self.sn_ids = np.asarray(sn_ids, dtype=np.int32)
        self._sn_random = np.asarray(sn_random, dtype=bool)
        self.pos_feats = np.stack(pos_feats) if pos_feats else None
        self.neg_feats = np.stack(neg_feats) if neg_feats else None
        # frozen association for fine-tune datasets
        self._frozen_seed = int(self.rng.randint(0, 2**31 - 1))

    def __len__(self):
        return len(self.gts)

    def class_counts(self) -> np.ndarray:
        return np.bincount(self.gts, minlength=self.config.taskNum + 1)

    def _epoch_rng(self, epoch: int) -> np.random.RandomState:
        if self.resample_each_epoch:
            return np.random.RandomState(int(self.rng.randint(0, 2**31 - 1)))
        # fine-tune: identical draws every epoch -> frozen association
        return np.random.RandomState(self._frozen_seed)

    def _epoch_sn_ids(self, rng: np.random.RandomState) -> np.ndarray:
        """Negative-class ids for one epoch; rows whose shard carried no
        'sound_negative_id' are redrawn for VARDataset."""
        if not self.resample_each_epoch or not self._sn_random.any():
            return self.sn_ids
        sn = self.sn_ids.copy()
        rows = self._sn_random
        draws = rng.randint(0, self.config.taskNum, size=int(rows.sum()))
        draws = np.where(draws == self.gts[rows], self.config.taskNum, draws)
        sn[rows] = draws
        return sn

    def epoch_clip_ids(self, class_ranges: np.ndarray, epoch: int):
        """Clip-bank row ids for every item: (pos_ids, pos_zero, neg_ids,
        neg_zero), each aligned to item index."""
        rng = self._epoch_rng(epoch)
        sn_epoch = self._epoch_sn_ids(rng)
        pos_ids, pos_zero = self.audio.sample_clip_ids(
            self.gts, class_ranges, rng)
        neg_ids, neg_zero = self.audio.sample_clip_ids(
            sn_epoch, class_ranges, rng)
        return pos_ids, pos_zero, neg_ids, neg_zero

    def epoch_clip_ids_multi(self, class_entries, n_banks: int, epoch: int):
        """epoch_clip_ids for heterogeneous presets: per-row bank row ids
        and bank selectors (AudioStore.sample_clip_ids_multi). Returns
        ((pos_ids, pos_sel, pos_zero), (neg_ids, neg_sel, neg_zero))."""
        rng = self._epoch_rng(epoch)
        sn_epoch = self._epoch_sn_ids(rng)
        pos = self.audio.sample_clip_ids_multi(
            self.gts, class_entries, n_banks, rng)
        neg = self.audio.sample_clip_ids_multi(
            sn_epoch, class_entries, n_banks, rng)
        return pos, neg

    def iter_epoch(self, batch_size: int, epoch: int, shuffle: bool = True,
                   drop_last: bool = False) -> Iterator[TripletBatch]:
        """Host batches of one epoch, in epoch_order. Shards with features
        yield them; heterogeneous presets yield host MFCC features, each
        clip with its own dataset's params; otherwise packed waveforms,
        drawn per batch (VARDataset) or once over the unshuffled items and
        indexed (VARFineTuneDataset's frozen association)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            # the order varies per epoch even for fine-tune datasets; only
            # the image<->sound association is frozen
            np.random.RandomState(
                hash((self._frozen_seed, epoch)) % (2**31)).shuffle(order)
        clip_rng = self._epoch_rng(epoch)
        sn_epoch = self._epoch_sn_ids(clip_rng)

        if not self.resample_each_epoch:
            pos_all, pos_len_all, pos_zero_all = self.audio.sample_clip_batch(
                self.gts, clip_rng)
            neg_all, neg_len_all, neg_zero_all = self.audio.sample_clip_batch(
                sn_epoch, clip_rng)

        hetero = not self.audio.params_homogeneous()
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            image = self.images[idx]
            gt = self.gts[idx]
            none6 = dict(pos_wav=None, pos_len=None, pos_zero=None,
                         neg_wav=None, neg_len=None, neg_zero=None)
            if self.has_sound:
                yield TripletBatch(
                    image=image, ground_truth=gt, **none6,
                    pos_feat=self.pos_feats[idx],
                    neg_feat=self.neg_feats[idx])
                continue
            sn = sn_epoch[idx]
            if hetero:
                pos_feat = np.stack([
                    self.audio.gen_feat_for_class(int(c), clip_rng)
                    for c in gt])
                neg_feat = np.stack([
                    self.audio.gen_feat_for_class(int(c), clip_rng)
                    for c in sn])
                yield TripletBatch(
                    image=image, ground_truth=gt, **none6,
                    pos_feat=pos_feat.astype(np.float32),
                    neg_feat=neg_feat.astype(np.float32))
                continue
            if self.resample_each_epoch:
                pos_wav, pos_len, pos_zero = self.audio.sample_clip_batch(
                    gt, clip_rng)
                neg_wav, neg_len, neg_zero = self.audio.sample_clip_batch(
                    sn, clip_rng)
            else:
                pos_wav, pos_len, pos_zero = (
                    pos_all[idx], pos_len_all[idx], pos_zero_all[idx])
                neg_wav, neg_len, neg_zero = (
                    neg_all[idx], neg_len_all[idx], neg_zero_all[idx])
            yield TripletBatch(
                image=image, pos_wav=pos_wav, pos_len=pos_len,
                pos_zero=pos_zero, neg_wav=neg_wav, neg_len=neg_len,
                neg_zero=neg_zero, ground_truth=gt)

    def epoch_order(self, epoch: int, shuffle: bool = True) -> np.ndarray:
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(
                hash((self._frozen_seed, epoch)) % (2**31)).shuffle(order)
        return order


class TripletFineTuneDataset(TripletDataset):
    """VARFineTuneDataset semantics: frozen association."""

    resample_each_epoch = False


DATASET_REGISTRY = {
    "VARDataset": TripletDataset,
    "VARFineTuneDataset": TripletFineTuneDataset,
}


def load_env_data(config, audio: Optional[AudioStore] = None,
                  train_test: str = "train", seed: int = 0) -> TripletDataset:
    """Glob '{dir}/{split}/*.pickle' across pretextDataDir entries with
    per-dir file-count caps, concatenate, print per-class counts."""
    if audio is None:
        audio = AudioStore(config)
        audio.loadData()
    load_num = config.pretextDataFileLoadNum
    paths: List[str] = []
    for i, d in enumerate(config.pretextDataDir):
        if not os.path.exists(d):
            raise FileNotFoundError(f"pretext data dir {d!r} does not exist")
        files = sorted(glob.glob(os.path.join(d, train_test, "*.pickle")))
        cap = load_num[i] if i < len(load_num) else "all"
        if cap != "all" and len(files) > int(cap):
            files = list(np.random.RandomState(seed).choice(
                files, size=int(cap), replace=False))
        paths.extend(files)
    dtype = DATASET_REGISTRY[config.pretextDataset]
    ds = dtype(paths, config, audio, seed=seed)
    print("The number of pairs for each object in the dataset is:",
          ds.class_counts().tolist())
    return ds
