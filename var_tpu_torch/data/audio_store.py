"""Audio clip store, arm (pybullet-keyed) path (port of
var_tpu/data/audio_store.py).

Loads 16 kHz mono int16 wav clips keyed by intent index and serves per-clip
MFCC features to the host sims, and a packed int16 clip bank to the
pretext trainer, which computes MFCC on the device.

When the wav corpora are not on disk, a deterministic synthetic source
generates class-distinguishable clips with the same RandomState seeds
(1000 + intent) and the same VAR_TPU_SYNTH_CLIPS count as the JAX package,
so both packages hold byte-identical banks. The ai2thor/FSC loaders and the
python_speech_features MFCC branch wait for later slices.
"""
from __future__ import annotations

import glob
import os
import warnings
from typing import Dict, List, Optional

import numpy as np

from var_tpu_torch.ops.audio import (
    PARAM_TABLE,
    STFTParams,
    mfcc_single,
    pack_waveform,
    process_sound_feat,
)

FS = 16000


def synth_clip(class_idx: int, rng: np.random.RandomState,
               min_dur: float = 0.5, max_dur: float = 1.0) -> np.ndarray:
    """Deterministic-per-rng synthetic spoken-command stand-in.

    Class identity is carried by the fundamental frequency and formant
    pattern; utterance-level variation by duration, phase, AM envelope and
    noise. Returns int16 samples at 16 kHz.
    """
    dur = rng.uniform(min_dur, max_dur)
    n = int(dur * FS)
    t = np.arange(n) / FS
    f0 = 160.0 * (1.25 ** class_idx) * rng.uniform(0.95, 1.05)
    sig = np.zeros(n)
    for h, amp in enumerate((1.0, 0.6, 0.35, 0.2), start=1):
        # class-dependent formant emphasis
        a = amp * (1.0 + 0.5 * np.sin(class_idx + h))
        sig += a * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    # slow AM envelope like a spoken word
    env = 0.5 * (1 - np.cos(2 * np.pi * np.minimum(t / dur, 1.0)))
    env *= rng.uniform(0.7, 1.0)
    sig = sig * env + rng.randn(n) * 0.01
    sig = sig / (np.max(np.abs(sig)) + 1e-9)
    return (sig * 20000).astype(np.int16)


class AudioStore:
    """Clip storage + sampling, one instance per process."""

    def __init__(self, config):
        self.config = config
        self.param_dict: Dict[str, STFTParams] = dict(PARAM_TABLE)
        self.fs = FS
        self.words: Dict = {}
        env_folder = getattr(config, "envFolder", "ai2thor")
        head = os.path.split(env_folder)[0]
        self.env_type = head if head else env_folder
        if self.env_type != "pybullet":
            raise NotImplementedError(
                f"the {self.env_type!r} audio store is not ported yet; "
                "only the arm (pybullet-keyed) store is")
        self._loaded = False

    # -- loading ----------------------------------------------------------

    def loadData(self):
        if self._loaded:
            return
        self._load_pybullet()
        self._loaded = True
        print("Sound Loaded")

    def _wav_paths(self, dataset: str, item: str) -> List[str]:
        split = self.config.soundSource.get("train_test", "train")
        folder = os.path.join(self.config.commonMediaPath, dataset, split, item)
        return sorted(glob.glob(os.path.join(folder, "*.wav")))

    def _read_wav(self, path: str) -> Optional[np.ndarray]:
        from scipy.io import wavfile

        try:
            fs, data = wavfile.read(path)
        except (ValueError, OSError) as e:  # corrupt or unreadable file
            warnings.warn(f"failed to read {path}: {e}")
            return None
        if data.ndim > 1:
            data = data[:, 0]
        if fs != FS:
            return None  # 16 kHz mono only
        if np.issubdtype(data.dtype, np.floating):
            # float PCM is in [-1, 1]; scale to the int16 range
            data = np.clip(data * 32768.0, -32768, 32767)
        return data.astype(np.int16)

    def _load_pybullet(self):
        """words[intent][dataset] = [int16 clips]. Missing corpora fall back
        to the synthetic source under dataset key 'Synthetic'."""
        cfg = self.config
        for i in range(cfg.taskNum):
            self.words[i] = {}
        for dataset in cfg.soundSource["dataset"]:
            if dataset == "FSC":
                raise NotImplementedError(
                    "FSC clips for the arm profile are not ported yet")
            items = cfg.soundSource["items"][dataset]
            sizes = cfg.soundSource["size"][dataset]
            max_dur = cfg.soundSource.get("max_sound_dur", {}).get(dataset, 6.0)
            for i, item in enumerate(items):
                if item is None or sizes[i] == 0:
                    continue
                clips = []
                for p in self._wav_paths(dataset, item):
                    clip = self._read_wav(p)
                    if clip is None or len(clip) > max_dur * FS:
                        continue
                    clips.append(clip)
                    if len(clips) >= sizes[i]:
                        break
                if clips:
                    self.words[i][dataset] = clips
        # synthetic fallback for empty intents
        n_synth = int(os.environ.get("VAR_TPU_SYNTH_CLIPS", "64"))
        for i in range(cfg.taskNum):
            if not self.words[i]:
                rng = np.random.RandomState(1000 + i)
                self.words[i]["Synthetic"] = [
                    synth_clip(i, rng) for _ in range(n_synth)
                ]
        if any("Synthetic" in self.words[i] for i in range(cfg.taskNum)):
            warnings.warn(
                "AudioStore: no wav corpora found under "
                f"{cfg.commonMediaPath!r}; using the synthetic source"
            )

    # -- host sampling (env-side) ------------------------------------------

    def getAudioSamples(self, intentIdx: int, rand_fn):
        """Pick a dataset and a clip for an intent; returns
        (clip int16, STFTParams, dataset name)."""
        intentIdx = min(intentIdx, self.config.taskNum - 1)
        datasets = list(self.words[intentIdx].keys())
        ds = datasets[int(rand_fn(0, len(datasets), size=()))]
        clips = self.words[intentIdx][ds]
        clip = clips[int(rand_fn(0, len(clips), size=()))]
        return clip, self.param_dict[ds], ds

    def get_mfcc(self, audioSamples, param: STFTParams,
                 mfcc_from: str = "torchaudio", backend: str = "numpy"):
        """One clip to a padded (1, T, 40) feature (torchaudio semantics)."""
        if mfcc_from != "torchaudio":
            raise NotImplementedError(
                f"mfcc_from={mfcc_from!r} is not ported; only 'torchaudio'")
        feat = mfcc_single(audioSamples, param, backend=backend)
        return process_sound_feat(feat, self.config.sound_dim[1])

    def genSoundFeat(self, intentIdx: int, featType: str, rand_fn,
                     backend: str = "numpy", mfcc_from: str = "torchaudio"):
        """((1, T, 40) feature, raw clip) for an intent."""
        if featType != "MFCC":
            raise NotImplementedError(featType)
        clip, param, _ = self.getAudioSamples(intentIdx, rand_fn)
        feat = self.get_mfcc(clip, param, mfcc_from=mfcc_from,
                             backend=backend)
        return feat, clip

    # -- the trainer's packed clip bank ---------------------------------------

    @property
    def buf_len(self) -> int:
        """Fixed waveform buffer length: enough samples to fill
        sound_dim[1] frames, plus the center padding."""
        param = self._default_param()
        return self.config.sound_dim[1] * param.hop_length + param.n_fft

    def _default_param(self) -> STFTParams:
        ds = self.config.soundSource["dataset"]
        if isinstance(ds, str):
            return self.param_dict[ds]
        return self.param_dict[ds[0]]

    def params_homogeneous(self) -> bool:
        """True when every configured dataset shares one STFT param set
        (the single-bank device path needs one)."""
        ds = self.config.soundSource["dataset"]
        if isinstance(ds, str):
            return True
        return len({self.param_dict[d] for d in ds}) == 1

    def class_clips(self, class_idx: int) -> List[np.ndarray]:
        """All clips of an intent, over its datasets."""
        out = []
        for ds in self.words[class_idx]:
            out.extend(self.words[class_idx][ds])
        return out

    def build_clip_bank(self):
        """Pack every clip of every class into one (M, buf_len) int16 array
        for device residency.

        Returns (bank (M, buf_len) int16 pack_waveform rows, lengths (M,)
        int32, class_ranges (taskNum+1, 2) int32 start/end row per class;
        the empty class taskNum gets the sentinel range [0, 1), its rows
        are zeroed downstream)."""
        param = self._default_param()
        buf_len = self.buf_len
        rows, lengths = [], []
        ranges = np.zeros((self.config.taskNum + 1, 2), dtype=np.int32)
        for c in range(self.config.taskNum):
            start = len(rows)
            for clip in self.class_clips(c):
                max_samples = buf_len - param.n_fft
                if len(clip) > max_samples:
                    clip = clip[:max_samples]
                rows.append(pack_waveform(clip, buf_len, param.n_fft,
                                          keep_int16=True))
                lengths.append(len(clip))
            ranges[c] = (start, len(rows))
        ranges[self.config.taskNum] = (0, 1)
        bank = np.stack(rows).astype(np.int16)
        return bank, np.asarray(lengths, dtype=np.int32), ranges

    def sample_clip_ids(self, class_ids: np.ndarray, class_ranges: np.ndarray,
                        rng: np.random.RandomState):
        """Per-row clip indices into the bank + zero mask (empty class)."""
        class_ids = np.asarray(class_ids)
        lo = class_ranges[class_ids, 0]
        hi = class_ranges[class_ids, 1]
        ids = lo + (rng.rand(len(class_ids)) * (hi - lo)).astype(np.int64)
        zero_mask = class_ids >= self.config.taskNum
        return ids.astype(np.int32), zero_mask
