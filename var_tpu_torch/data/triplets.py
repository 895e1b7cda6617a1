"""Triplet datasets and shard IO for VAR pretext training (port of
var_tpu/data/triplets.py, the parts the device-resident path uses).

Pickle shards hold dicts {'image' (3,96,96) u8, 'ground_truth' int,
optional 'sound_negative_id' int}; sounds are paired to images by class:

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
from typing import List, Optional

import numpy as np

from var_tpu_torch.data.audio_store import AudioStore


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
        self.has_sound = False
        for p in shard_paths:
            for item in load_shard(p):
                images.append(np.asarray(item["image"], dtype=np.uint8))
                gt = int(np.asarray(item["ground_truth"]).reshape(()))
                gts.append(gt)
                if "sound_negative" in item:
                    # precomputed features: the streaming path's input
                    self.has_sound = True
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
