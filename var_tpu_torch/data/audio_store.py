"""Audio clip store (port of var_tpu/data/audio_store.py).

Loads 16 kHz mono int16 wav clips keyed by intent index (arm) or by
(location, object, action) task vocabulary (ai2thor, the FSC corpus) and
serves per-clip MFCC features to the host sims, packed int16 clip banks
(one per STFT param set when the presets mix them) to the pretext trainer,
which computes MFCC on the device, and packed waveform batches to its
streaming path.

When the wav corpora are not on disk, a deterministic synthetic source
generates class-distinguishable clips with the same RandomState seeds
(1000 + intent for the arm, 2000 + class for ai2thor) and the same
VAR_TPU_SYNTH_CLIPS count as the JAX package, so both packages hold
byte-identical banks. The FSC metadata CSV is read with the csv module
(the JAX package uses pandas) and selects the same rows in the same order,
for the ai2thor vocabulary and for the arm's 'location_object_action'
items. `get_mfcc(mfcc_from='psf')` is the python_speech_features twin
(ops/audio.py::mfcc_psf).
"""
from __future__ import annotations

import csv
import glob
import os
import warnings
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

import numpy as np

from var_tpu_torch.ops.audio import (
    PARAM_TABLE,
    STFTParams,
    mfcc_psf,
    mfcc_single,
    pack_waveform,
    process_sound_feat,
)

# an ai2thor task: (location, object, action) in the env's vocabulary
Task = namedtuple("Task", ["loc", "obj", "act"])

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
        self.transcription: Dict = {}
        env_folder = getattr(config, "envFolder", "ai2thor")
        head = os.path.split(env_folder)[0]
        self.env_type = head if head else env_folder
        if self.env_type not in ("pybullet", "ai2thor"):
            raise NotImplementedError(self.env_type)
        self._loaded = False
        # class list for ai2thor: enumerate tasks in config.allTasks order
        if self.env_type == "ai2thor":
            self.task_tuples: List[Tuple[str, str, str]] = []
            for loc in config.allTasks:
                for obj in config.allTasks[loc]:
                    for act in config.allTasks[loc][obj]:
                        self.task_tuples.append((loc, obj, act))

    # -- loading ----------------------------------------------------------

    def loadData(self):
        if self._loaded:
            return
        if self.env_type == "pybullet":
            self._load_pybullet()
        else:
            self._load_ai2thor()
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
                self._load_fsc_pybullet()
                continue
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

    def _load_fsc_pybullet(self):
        """FSC utterances keyed by arm intent: each entry of
        soundSource['items']['FSC'] is a 'location_object_action' string
        selecting the CSV's rows of that task, in the CSV's order, up to
        soundSource['size']['FSC'][intent] clips of at most
        max_sound_dur['FSC'] seconds."""
        cfg = self.config
        src = cfg.soundSource
        csv_path = os.path.join(cfg.commonMediaPath, "FSC", "data",
                                src.get("FSC_csv",
                                        src.get("train_test", "train")
                                        + "_data.csv"))
        if not os.path.exists(csv_path):
            warnings.warn(f"FSC metadata not found at {csv_path!r}")
            return
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        max_dur = src.get("max_sound_dur", {}).get("FSC", 6.0)
        for i, item in enumerate(src["items"]["FSC"]):
            if item is None:
                continue
            load_size = src["size"]["FSC"][i]
            loc, obj, act = item.split("_")
            clips = []
            for row in rows:
                if (row.get("object"), row.get("action"),
                        row.get("location")) != (obj, act, loc):
                    continue
                clip = self._read_wav(
                    os.path.join(cfg.commonMediaPath, "FSC", row["path"]))
                if clip is None or len(clip) > max_dur * FS:
                    continue
                clips.append(clip)
                if len(clips) >= load_size:
                    break
            if clips:
                self.words[i]["FSC"] = clips

    def _load_ai2thor(self):
        """words[loc][obj][act] = [clips] from the FSC metadata CSV, or the
        synthetic source when the CSV is absent or selects no clip."""
        cfg = self.config
        src = cfg.soundSource
        csv_path = os.path.join(
            cfg.commonMediaPath, "FSC", "data", src.get("FSC_csv", "train_data.csv")
        )
        loaded_real = False
        if os.path.exists(csv_path):
            loaded_real = self._load_fsc_csv(csv_path)
        if not loaded_real:
            warnings.warn(
                f"AudioStore: FSC metadata not found at {csv_path!r}; "
                "using the synthetic source"
            )
            self._load_ai2thor_synthetic()
        else:
            # a partially-populated corpus must not KeyError later
            self._fill_missing_ai2thor_classes()

    def _load_fsc_csv(self, csv_path: str) -> bool:
        """Rows are selected per (location, object, action) in the CSV's
        order, as the JAX package's pandas filters select them."""
        cfg = self.config
        src = cfg.soundSource
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        objs = list(src["FSC_obj_act"].keys())
        rows = [r for r in rows if r.get("object") in objs]
        load_size = src.get("size", -1)
        max_dur = src.get("FSC_max_sound_dur", 6.0)
        any_loaded = False
        fsc_root = os.path.join(cfg.commonMediaPath, "FSC")
        for loc in src["FSC_locations"]:
            loc_rows = [r for r in rows if r.get("location") == loc]
            self.words.setdefault(loc, {})
            self.transcription.setdefault(loc, {})
            for obj in objs:
                obj_rows = [r for r in loc_rows if r["object"] == obj]
                if not obj_rows:
                    continue
                self.words[loc].setdefault(obj, {})
                self.transcription[loc].setdefault(obj, {})
                for act in src["FSC_obj_act"][obj]:
                    clips, trans = [], []
                    for row in obj_rows:
                        if row.get("action") != act:
                            continue
                        if load_size > 0 and len(clips) >= load_size:
                            break
                        clip = self._read_wav(os.path.join(fsc_root, row["path"]))
                        if clip is None or len(clip) > max_dur * FS:
                            continue
                        clips.append(clip)
                        trans.append(row.get("transcription", ""))
                    if clips:
                        self.words[loc][obj][act] = clips
                        self.transcription[loc][obj][act] = trans
                        any_loaded = True
        return any_loaded

    def _synth_ai2thor(self, only_missing: bool) -> List[Tuple[str, str, str]]:
        """Synthetic clips (RandomState(2000 + class), 1-3 s) for every
        (loc, obj, act) class, or only for those left empty; returns the
        classes filled."""
        src = self.config.soundSource
        n_synth = int(os.environ.get("VAR_TPU_SYNTH_CLIPS", "32"))
        class_idx = 0
        filled = []
        for loc in src["FSC_locations"]:
            self.words.setdefault(loc, {})
            self.transcription.setdefault(loc, {})
            for obj, acts in src["FSC_obj_act"].items():
                self.words[loc].setdefault(obj, {})
                self.transcription[loc].setdefault(obj, {})
                for act in acts:
                    if not (only_missing and self.words[loc][obj].get(act)):
                        rng = np.random.RandomState(2000 + class_idx)
                        self.words[loc][obj][act] = [
                            synth_clip(class_idx, rng, 1.0, 3.0)
                            for _ in range(n_synth)]
                        self.transcription[loc][obj][act] = [
                            f"{act} the {obj} ({loc})"] * n_synth
                        filled.append((loc, obj, act))
                    class_idx += 1
        return filled

    def _fill_missing_ai2thor_classes(self):
        """Synthetic back-fill for the classes the real corpus left empty."""
        filled = self._synth_ai2thor(only_missing=True)
        if filled:
            warnings.warn(
                f"AudioStore: corpus missing {len(filled)} (loc,obj,act) "
                f"classes (e.g. {filled[0]}); back-filled synthetically")

    def _load_ai2thor_synthetic(self):
        self._synth_ai2thor(only_missing=False)

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
        """One clip to a padded (1, T, 40) feature: torchaudio's semantics,
        or with any other `mfcc_from` (e.g. 'psf') python_speech_features',
        as the JAX package selects them."""
        if mfcc_from == "torchaudio":
            feat = mfcc_single(audioSamples, param, backend=backend)
        else:
            feat = mfcc_psf(np.asarray(audioSamples), param)
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

    def _resolve_task(self, tsk, rand):
        """Map an env task through the synonym table to FSC vocabulary.
        Draw order: the location synonym, then the object synonym."""
        syn = self.config.synonym
        loc = syn[tsk.loc][rand.randint(0, len(syn[tsk.loc]))]
        obj = syn[tsk.obj][rand.randint(0, len(syn[tsk.obj]))]
        obj_act = self.config.soundSource["FSC_obj_act"][obj]
        act = sorted(set(obj_act).intersection(syn[tsk.act]))[0]
        return loc, obj, act

    def getAudioFromTask(self, random_func, tsk: Task):
        """(feature (1, T, 40), clip, transcription) for an ai2thor task;
        the synonym draws come first, then the clip's."""
        loc, obj, act = self._resolve_task(tsk, random_func)
        clips = self.words[loc][obj][act]
        idx = int(random_func.randint(0, len(clips)))
        clip = clips[idx]
        param = self.param_dict[
            self.config.soundSource["dataset"]
            if isinstance(self.config.soundSource["dataset"], str)
            else "FSC"
        ]
        return (self.get_mfcc(clip, param), clip,
                self.transcription[loc][obj][act][idx])

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

    def gen_feat_for_class(self, class_idx: int,
                           rng: np.random.RandomState) -> np.ndarray:
        """(1, T, 40) host feature for a canonical class index; zeros for
        the empty class."""
        if class_idx >= self.config.taskNum:
            return np.zeros(self.config.sound_dim, np.float32)
        if self.env_type == "pybullet":
            feat, _ = self.genSoundFeat(class_idx, "MFCC", rng.randint)
            return np.asarray(feat, np.float32)
        loc, obj, act = self.task_tuples[class_idx]
        feat, _, _ = self.getAudioFromTask(rng, Task(loc, obj, act))
        return np.asarray(feat, np.float32)

    def class_clips(self, class_idx: int) -> List[np.ndarray]:
        """All clips of a canonical class index: an arm intent's over its
        datasets, or an ai2thor task's over every synonym resolution
        `_resolve_task` can draw, so the bank covers the goals' support."""
        if self.env_type == "pybullet":
            out = []
            for ds in self.words[class_idx]:
                out.extend(self.words[class_idx][ds])
            return out
        loc, obj, act = self.task_tuples[class_idx]
        syn = self.config.synonym
        obj_act = self.config.soundSource["FSC_obj_act"]
        out = []
        for l in syn[loc]:
            for o in syn[obj]:
                acts = sorted(set(obj_act.get(o, [])) & set(syn[act]))
                for a in acts:
                    out.extend(
                        self.words.get(l, {}).get(o, {}).get(a, []))
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

    def sample_clip_batch(self, class_ids: np.ndarray,
                          rng: np.random.RandomState):
        """One clip per class id, packed into fixed-size int16 buffers (the
        streaming path's batches). The empty class gets a zeroed buffer
        and its zero_mask bit. Returns (buffers (B, buf_len) int16,
        lengths (B,) int32, zero_mask (B,) bool)."""
        param = self._default_param()
        buf_len = self.buf_len
        B = len(class_ids)
        bufs = np.zeros((B, buf_len), dtype=np.int16)
        lengths = np.zeros((B,), dtype=np.int32)
        zero_mask = np.zeros((B,), dtype=bool)
        for i, c in enumerate(class_ids):
            c = int(c)
            if c >= self.config.taskNum:
                zero_mask[i] = True
                lengths[i] = param.hop_length  # 1 valid frame; masked anyway
                continue
            clips = self.class_clips(c)
            clip = clips[rng.randint(len(clips))]
            max_samples = buf_len - param.n_fft
            if len(clip) > max_samples:
                clip = clip[:max_samples]
            bufs[i] = pack_waveform(clip, buf_len, param.n_fft,
                                    keep_int16=True)
            lengths[i] = len(clip)
        return bufs, lengths, zero_mask

    # -- heterogeneous presets: one bank per STFT param set -----------------

    def param_sets(self) -> List[STFTParams]:
        """Distinct STFT param sets across the configured datasets, in
        first-appearance order (the arm 'mix' preset, GoogleCommand 512/160
        + UrbanSound 1024/640, has two)."""
        ds = self.config.soundSource["dataset"]
        ds_list = [ds] if isinstance(ds, str) else list(ds)
        seen: List[STFTParams] = []
        for d in ds_list:
            p = self.param_dict[d]
            if p not in seen:
                seen.append(p)
        return seen

    def buf_len_for(self, param: STFTParams) -> int:
        return self.config.sound_dim[1] * param.hop_length + param.n_fft

    def build_clip_banks(self):
        """One packed (M_k, buf_len_k) int16 bank per distinct STFT param
        set, and per class the row ranges of each dataset it has clips in,
        so sampling keeps the host's two levels (a dataset uniformly, then
        a clip). A dataset outside the configured list (the synthetic
        source) takes the first param set.

        Returns (banks, class_entries): banks a list of (param, wav
        (M_k, buf_len_k) int16, lengths (M_k,) int32); class_entries[c] a
        list of (bank index, lo, hi). An empty bank holds one zero row, so
        every bank has a row to gather."""
        if self.env_type != "pybullet":
            raise NotImplementedError(
                "multi-bank packing is only defined for intent-keyed stores")
        params = self.param_sets()
        pidx = {p: k for k, p in enumerate(params)}
        rows: List[list] = [[] for _ in params]
        lens: List[list] = [[] for _ in params]
        class_entries: List[list] = []
        for c in range(self.config.taskNum):
            entries = []
            for ds_name, clips in self.words[c].items():
                p = self.param_dict.get(ds_name, params[0])
                k = pidx.get(p, 0)
                p = params[k]
                lo = len(rows[k])
                buf_len = self.buf_len_for(p)
                for clip in clips:
                    max_samples = buf_len - p.n_fft
                    if len(clip) > max_samples:
                        clip = clip[:max_samples]
                    rows[k].append(pack_waveform(clip, buf_len, p.n_fft,
                                                 keep_int16=True))
                    lens[k].append(len(clip))
                entries.append((k, lo, len(rows[k])))
            class_entries.append(entries)
        banks = []
        for k, p in enumerate(params):
            if not rows[k]:
                rows[k].append(np.zeros(self.buf_len_for(p), np.int16))
                lens[k].append(p.hop_length)
            banks.append((p, np.stack(rows[k]).astype(np.int16),
                          np.asarray(lens[k], dtype=np.int32)))
        return banks, class_entries

    def sample_clip_ids_multi(self, class_ids: np.ndarray, class_entries,
                              n_banks: int, rng: np.random.RandomState):
        """Row ids and bank selectors for the multi-bank step. Returns
        (ids (B, K) int32, the row in each bank, 0 where unselected;
        sel (B, K) bool, one True per non-empty row; zero (B,) bool, the
        empty-intent rows, whose selectors are all False)."""
        class_ids = np.asarray(class_ids)
        B = len(class_ids)
        ids = np.zeros((B, n_banks), np.int32)
        sel = np.zeros((B, n_banks), bool)
        zero = np.zeros((B,), bool)
        for i, c in enumerate(class_ids):
            c = int(c)
            if c >= self.config.taskNum:
                zero[i] = True
                continue
            entries = class_entries[c]
            k, lo, hi = entries[rng.randint(len(entries))]
            ids[i, k] = lo + rng.randint(hi - lo)
            sel[i, k] = True
        return ids, sel, zero
