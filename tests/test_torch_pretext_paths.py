"""Pretext's other paths against the JAX package on the CPU: the chunked
epoch (images larger than the device budget), the streaming epoch (shards
with precomputed features) and iter_epoch's batches, the packed-waveform
step, project_embeddings and testRepresentation's export, and manual
collection. The two trainers start from the same weights (JAX's init,
converted). Sizes: 48 triplets at batch 8 (6 steps an epoch), 4 synthetic
clips per class, the arm profile's widths.

Tolerances:
- losses and embeddings at rtol = atol = 1e-4 (float32 both sides,
  another order of summation);
- a one-chunk epoch against the port's own resident epoch at rtol 1e-5 /
  atol 1e-6, as tests/test_pretext_chunked.py holds JAX's (the same steps
  in the same order);
- batches, epoch orders, shards and collected pairs: equal, byte for byte
  (numpy code drawing from one RandomState in the same order).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.data import triplets as jtriplets
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.cli import build_config, parse_args
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.train import pretext as tpretext
from var_tpu_torch.train.checkpoint import save_checkpoint
from var_tpu_torch.utils import teleop

from test_torch_multibank import twin_trainers

TOL = dict(rtol=1e-4, atol=1e-4)
N_ITEMS, B = 48, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker, the module's fixtures included:
    the tier-1 run puts several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")


def _configs(root, env="arms", **extra):
    """(JAX config, port config): one shard directory, one save dir each."""
    out = []
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env=env)
        cfg.override(**{**dict(
            pretextDataDir=[os.path.join(str(root), "data")],
            pretextModelSaveDir=os.path.join(str(root), tag, "model"),
            pretextModelLoadDir=os.path.join(str(root), tag, "model", "0"),
            pretextTrainBatchSize=B, pretextModelFineTune=False,
            pretextDataset="VARDataset", pretextCollectNum=[2, 2, 2, 2, 4],
            pretextDataEpisode=2, pretextEnvMaxSteps=8, pretextNumEnvs=2,
            pretextDataNumFiles=1, vecEnvBackend="dummy"), **extra})
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _shard(root, task_num, n=N_ITEMS, seed=0):
    rng = np.random.RandomState(seed)
    items = []
    for _ in range(n):
        gt = rng.randint(0, task_num + 1)
        items.append({
            "image": (rng.rand(3, 96, 96) * 50 + gt * 40).astype(np.uint8),
            "ground_truth": np.int32(gt)})
    ttriplets.save_shard(os.path.join(str(root), "data", "train",
                                      "data_0.pickle"), items)


def _datasets(jcfg, tcfg):
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    return (jaudio, jtriplets.load_env_data(jcfg, jaudio),
            taudio, ttriplets.load_env_data(tcfg, taudio))


def _force_chunks(trainer, chunk_items):
    """Chunked residency with chunk_items items a slab, on a dataset that
    fits (tests/test_pretext_chunked.py's patch)."""
    upload = trainer._upload_dataset

    def patched(ds):
        b = upload(ds)
        return {"chunked": True, "wav": b["wav"], "len": b["len"],
                "ranges": b["ranges"],
                "chunk_bytes": chunk_items * ds.images[0].nbytes}

    trainer._upload_dataset = patched


# -- the chunked path ----------------------------------------------------------


def test_budget_selects_the_chunked_upload_as_jax(tmp_path):
    jcfg, tcfg = _configs(tmp_path)
    _shard(tmp_path, tcfg.taskNum)
    jaudio, jds, taudio, tds = _datasets(jcfg, tcfg)
    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    jtr._ensure_audio()
    ttr._ensure_audio()
    assert not ttr._upload_dataset(tds).get("chunked")
    # the clip bank is about 0.5 MB, the images 1.3 MB: 1 MiB forces chunks
    for cfg in (jcfg, tcfg):
        cfg.pretextHBMBudgetMB = 1
    jbank, tbank = jtr._upload_dataset(jds), ttr._upload_dataset(tds)
    assert tbank["chunked"] and jbank["chunked"]
    assert tbank["chunk_bytes"] == jbank["chunk_bytes"] >= 2 ** 20
    assert "images" not in tbank
    # the CLI sets the budget, which the profiles do not list
    args = parse_args(["--env", "arms", "--device", "cpu", "--set",
                       "pretextHBMBudgetMB=3", "pretextEpoch=2"])
    cfg = build_config(args, role="pretext")
    assert (cfg.pretextHBMBudgetMB, cfg.pretextEpoch) == (3, 2)
    assert "pretextHBMBudgetMB" not in vars(tconfig.main_config(env="arms"))


def test_one_chunk_equals_the_resident_epoch(tmp_path):
    _, tcfg = _configs(tmp_path)
    _shard(tmp_path, tcfg.taskNum)
    jcfg, _ = _configs(tmp_path)
    jaudio, _, taudio, tds = _datasets(jcfg, tcfg)
    _, resident = twin_trainers(jcfg, jaudio, tcfg, taudio)
    _, chunked = twin_trainers(jcfg, jaudio, tcfg, taudio)
    _force_chunks(chunked, N_ITEMS)
    # a dataset draws each epoch's clips from its own RandomState, so each
    # run takes a fresh copy of the same shard
    want = resident.trainRepresentation(epoch=1, dataset=tds, log_csv=False)
    got = chunked.trainRepresentation(
        epoch=1, dataset=ttriplets.load_env_data(tcfg, taudio),
        log_csv=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert chunked.step == resident.step == N_ITEMS // B


def test_three_chunks_train_as_jax(tmp_path):
    """16 items a slab: 3 slabs of 2 steps, the next slab's upload on the
    worker thread while the current slab trains."""
    jcfg, tcfg = _configs(tmp_path)
    _shard(tmp_path, tcfg.taskNum)
    jaudio, jds, taudio, tds = _datasets(jcfg, tcfg)
    jtr, ttr = twin_trainers(jcfg, jaudio, tcfg, taudio)
    _force_chunks(jtr, 16)
    _force_chunks(ttr, 16)
    want = jtr.trainRepresentation(epoch=2, dataset=jds, log_csv=False)
    got = ttr.trainRepresentation(epoch=2, dataset=tds, log_csv=False)
    np.testing.assert_allclose(got, want, **TOL)
    assert ttr.step == 2 * 3 * 2 and np.isfinite(got).all()


# -- the streaming path ----------------------------------------------------------


@pytest.mark.parametrize("dataset", ["VARDataset", "VARFineTuneDataset"])
def test_iter_epoch_batches_match_jax(tmp_path, dataset):
    jcfg, tcfg = _configs(tmp_path, pretextDataset=dataset)
    _shard(tmp_path, tcfg.taskNum, n=20)
    _, jds, _, tds = _datasets(jcfg, tcfg)
    for epoch in range(2):
        jb = list(jds.iter_epoch(B, epoch=epoch, shuffle=True))
        tb = list(tds.iter_epoch(B, epoch=epoch, shuffle=True))
        assert len(tb) == len(jb) == 3  # 20 items: the last batch ragged
        for j, t in zip(jb, tb):
            for name in ("image", "pos_wav", "pos_len", "pos_zero", "neg_wav",
                         "neg_len", "neg_zero", "ground_truth"):
                np.testing.assert_array_equal(getattr(t, name),
                                              getattr(j, name), err_msg=name)
            assert t.pos_feat is None and j.pos_feat is None


def test_packed_waveform_step_matches_jax(tmp_path):
    """_train_step_wav on iter_epoch's uploaded batches, step by step."""
    jcfg, tcfg = _configs(tmp_path, audioBackend="pallas")
    _shard(tmp_path, tcfg.taskNum, n=16)
    jaudio, jds, taudio, tds = _datasets(jcfg, tcfg)
    jtr, ttr = twin_trainers(jcfg, jaudio, tcfg, taudio)
    jtr._ensure_audio()
    ttr._ensure_audio()
    jtr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=2)
    params = jtr.variables["params"]
    state = jpretext.TrainState(params, jtr.tx.init(params),
                                jnp.asarray(0, jnp.int32))
    ttr.setup_optimizer(steps_per_epoch=2)
    for jbatch, (tbatch, dev) in zip(jds.iter_epoch(B, epoch=0),
                                     ttr._prefetch_epoch(tds, B, 0)):
        state, jloss = jtr._train_step_wav(state, *jtr._device_batch(jbatch))
        tloss = ttr._train_step_wav(*dev)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert ttr.step == 2


@pytest.fixture(scope="module")
def sound_shards(tmp_path_factory):
    """Shards collected with precomputed features by both packages."""
    root = tmp_path_factory.mktemp("has_sound")
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs(root, pretextDataHasSound=True)
        for cfg in (jcfg, tcfg):
            cfg.override(pretextDataDir=[os.path.join(
                str(root), cfg.__module__.split(".")[0], "data")])
        jtr = jpretext.PretextTrainer(jcfg)
        jtr.collectPretextData()
        ttr = tpretext.PretextTrainer(tcfg, device="cpu")
        ttr.collectPretextData()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return jcfg, tcfg, jtr.audio, ttr.audio


def test_streaming_epochs_match_jax(sound_shards):
    jcfg, tcfg, jaudio, taudio = sound_shards
    jds = jtriplets.load_env_data(jcfg, jaudio)
    tds = ttriplets.load_env_data(tcfg, taudio)
    assert tds.has_sound and jds.has_sound and len(tds) == 12
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_allclose(tds.pos_feats, jds.pos_feats, **TOL)
    np.testing.assert_allclose(tds.neg_feats, jds.neg_feats, **TOL)
    for j, t in zip(jds.iter_epoch(B, epoch=1), tds.iter_epoch(B, epoch=1)):
        np.testing.assert_array_equal(t.ground_truth, j.ground_truth)
        np.testing.assert_allclose(t.pos_feat, j.pos_feat, **TOL)
        assert t.pos_wav is None
    jtr, ttr = twin_trainers(jcfg, jaudio, tcfg, taudio)
    ttr._ensure_audio()
    assert ttr._upload_dataset(tds) is None  # the streaming path
    feat = tpretext.PretextTrainer._train_step_feat
    calls = []
    ttr._train_step_feat = lambda *a: calls.append(1) or feat(ttr, *a)
    want = jtr.trainRepresentation(epoch=2, dataset=jds, log_csv=False)
    got = ttr.trainRepresentation(epoch=2, dataset=tds, log_csv=False)
    np.testing.assert_allclose(got, want, **TOL)
    assert len(calls) == 2 * 2  # 12 items at batch 8: 2 batches an epoch
    assert [n for n, _ in ttr.epoch_stats] == [12, 12]


# -- the embedding export ----------------------------------------------------------


def test_project_embeddings_and_test_representation_match_jax(tmp_path):
    jcfg, tcfg = _configs(tmp_path, audioBackend="pallas",
                          pretextTestBatchSize=16, plotNumBatch=2)
    _shard(tmp_path, tcfg.taskNum, n=40)
    jaudio, jds, taudio, tds = _datasets(jcfg, tcfg)
    jtr, ttr = twin_trainers(jcfg, jaudio, tcfg, taudio)
    want = jtr.project_embeddings(jds)
    got = ttr.project_embeddings(tds)
    for key in ("img", "sound"):
        assert got[key].shape == want[key].shape == (32, 4)  # 2 batches
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    np.testing.assert_array_equal(got["img"][:, -1], tds.gts[:32])

    # run() with neither collection nor training: the export, from the
    # checkpoint at pretextModelLoadDir
    save_checkpoint(tcfg.pretextModelLoadDir,
                    {"params": ttr.model.state_dict(), "step": 0})
    tcfg.override(pretextCollection=False, pretextTrain=False)
    fresh = tpretext.PretextTrainer(tcfg, device="cpu")
    fresh.run()
    saved = np.load(os.path.join(tcfg.pretextModelSaveDir,
                                 "representation.npz"))
    for key in ("img", "sound"):
        np.testing.assert_allclose(saved[key], want[key], err_msg=key, **TOL)


# -- manual collection ---------------------------------------------------------------


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_scripted_manual_collection_matches_jax(tmp_path, env):
    """'r' stores the current pair, 'z' flushes a shard, quitting flushes
    the rest (tests/test_drivers.py's script): the same pairs in the same
    shards, byte for byte."""
    script = ["", "r", "", "r", "z", "", "", "r", "quit"]
    jcfg, tcfg = _configs(tmp_path, env=env)
    for cfg, tag in ((jcfg, "jax"), (tcfg, "port")):
        cfg.override(pretextDataDir=[str(tmp_path / tag / "data")])
    cmds = iter(script)
    jpretext.PretextTrainer(jcfg).manuallyCollectPretextData(
        input_fn=lambda: next(cmds))
    cmds = iter(script)
    path = tpretext.PretextTrainer(tcfg, device="cpu") \
        .manuallyCollectPretextData(input_fn=lambda: next(cmds))
    shards = []
    for tag in ("jax", "port"):
        names = sorted(glob.glob(str(tmp_path / tag / "data" / "train" /
                                     "*.pickle")))
        shards.append([ttriplets.load_shard(p) for p in names])
    assert path == sorted(glob.glob(str(tmp_path / "port" / "data" / "train" /
                                        "*.pickle")))[-1]
    assert [len(s) for s in shards[1]] == [len(s) for s in shards[0]] == [2, 1]
    for js, ts in zip(*shards):
        for a, b in zip(js, ts):
            assert list(a) == list(b)
            for k in a:
                assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()


def test_manual_collection_through_run_and_realtime_refusal(tmp_path,
                                                            monkeypatch):
    _, tcfg = _configs(tmp_path, pretextManualCollect=True)
    monkeypatch.setattr(teleop, "stdin_is_tty", lambda: False)
    lines = iter(["", "r", "q"])
    monkeypatch.setattr("builtins.input", lambda *_: next(lines))
    tpretext.PretextTrainer(tcfg, device="cpu").run()
    (shard,) = glob.glob(os.path.join(tcfg.pretextDataDir[0], "train", "*"))
    assert len(ttriplets.load_shard(shard)) == 1
    tcfg.override(realTimeVec=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.*Options"):
        tpretext.PretextTrainer(tcfg, device="cpu").run()
