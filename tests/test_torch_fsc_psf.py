"""The arm profile's FSC clips and the python_speech_features MFCC, the
port against the JAX package on the CPU.

- The arm FSC loader (`AudioStore._load_fsc_pybullet`) on a generated
  FSC-layout corpus: the port reads the metadata with the csv module, the
  JAX package with pandas; both must keep the same clips, in the same
  order, for every intent, and the same clip bank and host features.
  Clips are int16 data: equal, no tolerance.
- `mfcc_psf` and `psf_filterbank`: the same numpy float64 arithmetic on
  both sides, cast to float32 at the end, so held within 1e-6 (absolute),
  below one float32 ulp of the features' magnitudes (log energies up to
  about 30): seeded clips at both STFT param sets, odd lengths, a clip
  shorter than one frame.
"""
import csv
import os

import numpy as np
import pytest
from scipy.io import wavfile

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.ops import audio as jaudio
from var_tpu_torch import config as tconfig
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.ops import audio as taudio

PSF_ATOL = 1e-6
ITEMS = ["none_lights_activate", "kitchen_lights_deactivate",
         "none_music_activate", "none_heat_increase"]


def _corpus(root):
    """Rows out of order, another location's rows for the same object and
    action, a clip too long, a clip at 8 kHz (skipped as in the reference)
    and an intent with no row at all (none_heat_increase)."""
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(root, "FSC", "data"))
    os.makedirs(os.path.join(root, "FSC", "wavs"))
    spec = [("lights", "activate", "none", 1.0, 16000),
            ("music", "activate", "none", 1.3, 16000),
            ("lights", "deactivate", "kitchen", 0.9, 16000),
            ("lights", "activate", "kitchen", 1.1, 16000),
            ("lights", "activate", "none", 7.0, 16000),
            ("lights", "deactivate", "none", 0.7, 16000),
            ("lights", "activate", "none", 0.6, 8000),
            ("lights", "activate", "none", 1.2, 16000),
            ("music", "activate", "none", 0.8, 16000),
            ("lights", "deactivate", "kitchen", 1.4, 16000),
            ("lights", "activate", "none", 0.5, 16000),
            ("music", "activate", "none", 0.9, 16000)]
    rows = []
    for i, (obj, act, loc, dur, fs) in enumerate(spec):
        rel = os.path.join("wavs", f"clip{i}.wav")
        wavfile.write(os.path.join(root, "FSC", rel), fs,
                      (rng.randn(int(dur * fs)) * 3000).astype(np.int16))
        rows.append({"": i, "path": rel, "speakerId": "s",
                     "transcription": f"{act} {obj} {i}", "action": act,
                     "object": obj, "location": loc})
    with open(os.path.join(root, "FSC", "data", "train_data.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _stores(root, sizes=(2, 2, 3, 2)):
    source = {"dataset": ["FSC"], "items": {"FSC": list(ITEMS)},
              "size": {"FSC": list(sizes)}, "max_sound_dur": {"FSC": 6.0},
              "train_test": "train"}
    stores = []
    for mod, store in ((jconfig, jstore), (tconfig, tstore)):
        cfg = mod.main_config(env="arms")
        cfg.override(commonMediaPath=root, soundSource=dict(source))
        audio = store.AudioStore(cfg)
        with pytest.warns(UserWarning, match="synthetic source"):
            audio.loadData()
        stores.append(audio)
    return stores


def test_arm_fsc_loader_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    _corpus(str(tmp_path))
    jaud, taud = _stores(str(tmp_path))
    assert list(taud.words) == list(jaud.words)
    for i, by_ds in jaud.words.items():
        assert list(taud.words[i]) == list(by_ds)
        for ds, clips in by_ds.items():
            assert len(taud.words[i][ds]) == len(clips)
            for a, b in zip(taud.words[i][ds], clips):
                np.testing.assert_array_equal(a, b)
    # clips 0, 7 (not the 7 s one nor the 8 kHz one); kitchen's 2 and 9;
    # music's first three; the heat intent falls back to the synthetic source
    assert [len(c) for c in taud.words[0]["FSC"]] == [16000, 19200]
    assert [len(c) for c in taud.words[1]["FSC"]] == [14400, 22400]
    assert len(taud.words[2]["FSC"]) == 3
    assert list(taud.words[3]) == ["Synthetic"]
    for a, b in zip(taud.build_clip_bank(), jaud.build_clip_bank()):
        np.testing.assert_array_equal(a, b)
    tr, jr = np.random.RandomState(5), np.random.RandomState(5)
    for intent in range(4):
        tf, tc = taud.genSoundFeat(intent, "MFCC", tr.randint)
        jf, jc = jaud.genSoundFeat(intent, "MFCC", jr.randint)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4)


def test_arm_fsc_without_metadata_warns_and_synthesises(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    cfg = tconfig.main_config(env="arms")
    cfg.override(commonMediaPath=str(tmp_path), soundSource={
        "dataset": ["FSC"], "items": {"FSC": list(ITEMS)},
        "size": {"FSC": [2] * 4}, "train_test": "train"})
    audio = tstore.AudioStore(cfg)
    with pytest.warns(UserWarning, match="FSC metadata not found"):
        audio.loadData()
    assert all(list(audio.words[i]) == ["Synthetic"] for i in range(4))


@pytest.mark.parametrize("params", [taudio.STFTParams(512, 400, 160),
                                    taudio.STFTParams(1024, 800, 640)])
def test_psf_filterbank_matches_jax(params):
    n_fft, _, _, fs = params
    np.testing.assert_allclose(taudio.psf_filterbank(40, n_fft, fs),
                               jaudio.psf_filterbank(40, n_fft, fs),
                               rtol=0, atol=PSF_ATOL)


@pytest.mark.parametrize("params", [taudio.STFTParams(512, 400, 160),
                                    taudio.STFTParams(1024, 800, 640)])
@pytest.mark.parametrize("length", [16000, 12345, 801, 399, 57])
def test_mfcc_psf_matches_jax(params, length):
    """Seeded int16 clips; 12345 and 801 are odd, 399 and 57 are shorter
    than a frame at both param sets (one zero-padded frame)."""
    clip = (np.random.RandomState(length).randn(length) * 4000).astype(
        np.int16)
    got = taudio.mfcc_psf(clip, params)
    want = jaudio.mfcc_psf(clip, jaudio.STFTParams(*params))
    assert got.dtype == np.float32 and got.shape == want.shape
    if length < params.win_length:
        assert got.shape[0] == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=PSF_ATOL)


def test_get_mfcc_psf_matches_jax(monkeypatch):
    """get_mfcc(mfcc_from='psf') pads or cuts to sound_dim as the JAX
    store does; a silent clip takes the eps floors."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    stores = []
    for mod, store in ((jconfig, jstore), (tconfig, tstore)):
        stores.append(store.AudioStore(mod.main_config(env="arms")))
    params = taudio.PARAM_TABLE["GoogleCommand"]
    rng = np.random.RandomState(9)
    for clip in ((rng.randn(24001) * 2000).astype(np.int16),
                 np.zeros(3000, np.int16)):
        want = stores[0].get_mfcc(clip, jaudio.STFTParams(*params),
                                  mfcc_from="psf")
        got = stores[1].get_mfcc(clip, params, mfcc_from="psf")
        assert got.shape == want.shape == (1, 100, 40)
        np.testing.assert_allclose(got, want, rtol=0, atol=PSF_ATOL)
