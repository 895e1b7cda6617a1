"""The multi-bank pretext path (heterogeneous STFT presets, the arm 'mix'
preset: GoogleCommand 512/160 + UrbanSound 1024/640) against the JAX
package on the CPU, mirroring tests/test_hetero_bank.py: the banks and
their class entries, the draws of sample_clip_ids_multi and
epoch_clip_ids_multi, a bank row's device MFCC against the host MFCC, and
two epochs of training through trainRepresentation from the same weights.

No wav corpus is in the repo, so the store is built as
tests/test_hetero_bank.py builds it: the synthetic source (bank 0, the
first param set), then 3 synthetic clips per class under 'UrbanSound'
(bank 1, n_fft 1024), then the preset's dataset list.

Tolerances:
- banks, lengths, entries, row ids and selectors: equal (numpy code
  drawing from one RandomState in the same order);
- the device MFCC of a bank row against the host MFCC of its clip at
  atol 2e-3 / rtol 1e-3, tests/test_hetero_bank.py's (the host path is
  numpy float32 with another summation order and framing);
- epoch losses at rtol 1e-4 (float32 both sides, another order of
  summation); 12 triplets, batch 6, 2 steps an epoch, 2 epochs.
"""
import os

import jax
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.data import triplets as jtriplets
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import arm_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.ops.audio import (mfcc_single, process_sound_feat,
                                     sound_features)
from var_tpu_torch.train import pretext as tpretext

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mix_store(config_mod, store_mod, **knobs):
    """(config, store) of the mixed preset, as tests/test_hetero_bank.py
    builds it."""
    cfg = config_mod.main_config(env="arms")
    if knobs:
        cfg.override(**knobs)
    audio = store_mod.AudioStore(cfg)
    audio.loadData()
    rng = np.random.RandomState(7)
    for i in range(cfg.taskNum):
        audio.words[i]["UrbanSound"] = [
            store_mod.synth_clip(i, rng) for _ in range(3)]
    cfg.soundSource["dataset"] = ["Synthetic", "UrbanSound"]
    assert not audio.params_homogeneous()
    return cfg, audio


@pytest.fixture
def stores():
    return (mix_store(jconfig, jstore), mix_store(tconfig, tstore))


def test_build_clip_banks_match_jax(stores):
    (jcfg, jaudio), (tcfg, taudio) = stores
    assert [tuple(p) for p in jaudio.param_sets()] == taudio.param_sets()
    jbanks, jentries = jaudio.build_clip_banks()
    tbanks, tentries = taudio.build_clip_banks()
    assert tentries == jentries
    assert len(tbanks) == 2
    for (jp, jw, jl), (tp, tw, tl) in zip(jbanks, tbanks):
        assert tuple(jp) == tp
        assert tw.shape[1] == taudio.buf_len_for(tp) == jaudio.buf_len_for(jp)
        assert jw.tobytes() == tw.tobytes() and jl.tobytes() == tl.tobytes()
    assert (tbanks[0][0].n_fft, tbanks[1][0].n_fft) == (512, 1024)
    for c in range(tcfg.taskNum):
        assert sorted(k for k, _, _ in tentries[c]) == [0, 1]


def test_sample_clip_ids_multi_match_jax(stores):
    (jcfg, jaudio), (tcfg, taudio) = stores
    _, entries = taudio.build_clip_banks()
    classes = np.array([0, 1, tcfg.taskNum, 2, 3, 3, 0, tcfg.taskNum])
    got = taudio.sample_clip_ids_multi(classes, entries, 2,
                                       np.random.RandomState(0))
    want = jaudio.sample_clip_ids_multi(classes, entries, 2,
                                        np.random.RandomState(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, sel, zero = got
    assert zero.tolist() == [c == tcfg.taskNum for c in classes]
    assert (sel.sum(1) == ~zero).all()  # one bank per real row


def test_bank_row_mfcc_matches_host_mfcc(stores):
    """A row's device MFCC (the multi-bank step's features) equals the
    host MFCC of its clip with that clip's own params."""
    _, (tcfg, taudio) = stores
    banks, entries = taudio.build_clip_banks()
    for c, ds_name in ((0, "UrbanSound"), (1, "Synthetic")):
        p_target = taudio.param_dict[ds_name]
        k, lo, _ = next(e for e in entries[c] if banks[e[0]][0] == p_target)
        p, wav, lens = banks[k]
        dev = sound_features(torch.from_numpy(wav[lo:lo + 1]),
                             torch.from_numpy(lens[lo:lo + 1]),
                             tcfg.sound_dim[1], p, backend="pallas")
        host = process_sound_feat(mfcc_single(taudio.words[c][ds_name][0], p),
                                  tcfg.sound_dim[1])
        np.testing.assert_allclose(dev[0].numpy(), host, atol=2e-3, rtol=1e-3)


def _shard(root, task_num, n=12, seed=1):
    rng = np.random.RandomState(seed)
    items = [{"image": (rng.rand(3, 96, 96) * 255).astype(np.uint8),
              "ground_truth": np.int32(i % (task_num + 1))} for i in range(n)]
    ttriplets.save_shard(os.path.join(str(root), "train", "data_0.pickle"),
                         items)


def twin_trainers(jcfg, jaudio, tcfg, taudio, seed=0):
    """The JAX trainer with fresh parameters and the port's holding them."""
    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    params = jtr.init_model(seed=seed)["params"]
    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr.model = VARPretextNet(tcfg.representationDim)
    ttr.model.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jtr, ttr


def test_two_epochs_match_jax_through_the_multi_bank_path(stores, tmp_path,
                                                          monkeypatch):
    (jcfg, jaudio), (tcfg, taudio) = stores
    _shard(tmp_path, tcfg.taskNum)
    for cfg in (jcfg, tcfg):
        cfg.override(pretextDataDir=[str(tmp_path)],
                     pretextModelSaveDir=str(tmp_path / cfg.__module__),
                     pretextTrainBatchSize=6, pretextModelFineTune=False,
                     audioBackend="pallas")
    jtr, ttr = twin_trainers(jcfg, jaudio, tcfg, taudio)
    steps = []
    multi = tpretext.PretextTrainer._train_step_multi

    def spy(self, bank, *a):
        steps.append(tuple(p.n_fft for p in bank["multi_params"]))
        return multi(self, bank, *a)

    monkeypatch.setattr(tpretext.PretextTrainer, "_train_step_multi", spy)
    jds = jtriplets.load_env_data(jcfg, jaudio)
    tds = ttriplets.load_env_data(tcfg, taudio)
    jlosses = jtr.trainRepresentation(epoch=2, dataset=jds, log_csv=False)
    tlosses = ttr.trainRepresentation(epoch=2, dataset=tds, log_csv=False)
    assert steps == [(512, 1024)] * 4
    assert jtr._multi_params is not None  # JAX took its multi-bank path too
    np.testing.assert_allclose(tlosses, jlosses, **TOL)
    for epoch in range(3):
        got = tds.epoch_clip_ids_multi(taudio.build_clip_banks()[1], 2, epoch)
        want = jds.epoch_clip_ids_multi(jaudio.build_clip_banks()[1], 2,
                                        epoch)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_a_new_upload_takes_the_new_presets(stores, tmp_path):
    """The step reads its STFT params from the upload: after the preset
    list changes, the next upload carries the new param sets."""
    _, (tcfg, taudio) = stores
    _shard(tmp_path, tcfg.taskNum)
    tcfg.override(pretextDataDir=[str(tmp_path)])
    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ds = ttriplets.load_env_data(tcfg, taudio)
    first = ttr._upload_dataset(ds)["multi_params"]
    tcfg.soundSource["dataset"] = ["UrbanSound", "Synthetic"]
    second = ttr._upload_dataset(ds)["multi_params"]
    assert [p.n_fft for p in first] == [512, 1024]
    assert [p.n_fft for p in second] == [1024, 512]
