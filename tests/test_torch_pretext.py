"""The port's pretext slice (collect -> MFCC -> train) against the JAX
package on the CPU, from the same seeds, shards, banks and converted
parameters.

Tolerances:
- each step's loss at rtol 1e-4: the forward is float32 on both sides and
  differs only in summation order;
- parameters after one Adam step within atol 2.5e-4 with a median
  difference below 1e-6: Adam moves every weight by about +-lr whatever
  the size of its gradient, so a near-zero gradient that rounds to the
  other sign differs by 2*lr (lr 1e-4); the median shows that the rest
  agree.
Collection, datasets, banks and sims are integer/numpy code and must be
identical.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.data import triplets as jtriplets
from var_tpu.envs import arm_sim as jsim
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.cli import build_config, parse_args
from var_tpu_torch.convert import arm_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.device import resolve_device
from var_tpu_torch.envs import arm_sim as tsim
from var_tpu_torch.envs.vec.dummy import DummyVecEnv
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.envs.vec.shmem import ShmemVecEnv
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.train import pretext as tpretext
from var_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint

SMALL = dict(
    pretextCollectNum=[3, 3, 3, 3, 6], pretextDataEpisode=4,
    pretextDataNumFiles=2, pretextEnvMaxSteps=8, pretextNumEnvs=2,
    pretextTrainBatchSize=8, pretextEpoch=2, pretextModelSaveInterval=1,
    pretextModelFineTune=False, pretextDataset="VARDataset",
    vecEnvBackend="dummy",
)


def _configs(root, **extra):
    """(JAX config, port config) with the same knobs."""
    out = []
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env="arms")
        cfg.override(
            pretextDataDir=[os.path.join(str(root), tag, "data")],
            pretextModelSaveDir=os.path.join(str(root), tag, "model"),
            **{**SMALL, **extra})
        out.append(cfg)
    return out


def _collect_both(root, **extra):
    """Both packages' collectors from one seed, and their audio stores."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "8"
    try:
        jcfg, tcfg = _configs(root, **extra)
        jconfig.gym_register(jcfg)
        tconfig.gym_register(tcfg)
        jtr = jpretext.PretextTrainer(jcfg)
        jtr.collectPretextData()
        ttr = tpretext.PretextTrainer(tcfg, device="cpu")
        ttr.collectPretextData()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return jcfg, tcfg, jtr.audio, ttr.audio


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    return _collect_both(tmp_path_factory.mktemp("collect"))


def _shards(cfg):
    d = os.path.join(cfg.pretextDataDir[0], "train")
    return sorted(os.listdir(d)), d


def _assert_identical_shards(jcfg, tcfg):
    jnames, jdir = _shards(jcfg)
    tnames, tdir = _shards(tcfg)
    assert jnames == tnames and jnames
    total = 0
    for name in jnames:
        jitems = jtriplets.load_shard(os.path.join(jdir, name))
        titems = ttriplets.load_shard(os.path.join(tdir, name))
        assert len(jitems) == len(titems)
        for a, b in zip(jitems, titems):
            assert list(a) == list(b) == ["image", "ground_truth",
                                          "sound_negative_id"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        total += len(titems)
    assert total == sum(jcfg.pretextCollectNum)


def test_collection_writes_identical_shards(collected):
    jcfg, tcfg, _, _ = collected
    _assert_identical_shards(jcfg, tcfg)


def test_collection_at_the_recipe_knobs_writes_identical_shards(tmp_path):
    """The arm E2E recipe's VAR knobs (fault F3, step b): a quarter of the
    poses teleport to the outward flank of an end slot
    (pretextEndFlankFrac=0.25), representationDim=8. The flank draws come
    from the sim's RandomState between the walk's, so one draw out of
    order would shift every later pose."""
    jcfg, tcfg, _, _ = _collect_both(
        tmp_path, pretextEndFlankFrac=0.25, representationDim=8,
        pretextCollectNum=[6, 6, 6, 6, 12])
    _assert_identical_shards(jcfg, tcfg)


def test_clip_banks_are_byte_identical(collected):
    _, _, jaudio, taudio = collected
    assert taudio.buf_len == jaudio.buf_len
    assert taudio._default_param() == tuple(jaudio._default_param())
    assert taudio.params_homogeneous() and jaudio.params_homogeneous()
    for a, b in zip(jaudio.build_clip_bank(), taudio.build_clip_bank()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    ranges = taudio.build_clip_bank()[2]
    classes = np.array([0, 4, 2, 3, 1, 4])
    for a, b in zip(jaudio.sample_clip_ids(classes, ranges, rng_a),
                    taudio.sample_clip_ids(classes, ranges, rng_b)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["VARDataset", "VARFineTuneDataset"])
def test_datasets_draw_the_same_epochs(collected, dataset):
    jcfg, tcfg, jaudio, taudio = collected
    jcfg.override(pretextDataset=dataset)
    tcfg.override(pretextDataset=dataset)
    jds = jtriplets.load_env_data(jcfg, jaudio)
    tds = ttriplets.load_env_data(tcfg, taudio)
    np.testing.assert_array_equal(jds.images, tds.images)
    np.testing.assert_array_equal(jds.gts, tds.gts)
    ranges = taudio.build_clip_bank()[2]
    for epoch in range(3):
        np.testing.assert_array_equal(jds.epoch_order(epoch),
                                      tds.epoch_order(epoch))
        for a, b in zip(jds.epoch_clip_ids(ranges, epoch),
                        tds.epoch_clip_ids(ranges, epoch)):
            np.testing.assert_array_equal(a, b)


def test_rl_sim_observations_match(collected):
    """The RL sim (goal sounds through the host MFCC) steps identically."""
    jcfg, tcfg, jaudio, taudio = collected
    jenv = jsim.FourInARowSim(jcfg, jaudio)
    tenv = tsim.FourInARowSim(tcfg, taudio)
    jenv.seed(11)
    tenv.seed(11)
    obs = [(jenv.reset(), tenv.reset())]
    rng = np.random.RandomState(0)
    for _ in range(5):
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        obs.append((jenv.step(a)[0], tenv.step(a)[0]))
    for jo, to in obs:
        assert list(jo) == list(to)
        for k in jo:
            np.testing.assert_array_equal(jo[k], to[k])


@pytest.mark.parametrize("start_step", [0, 29, 31, 95])
def test_multistep_lr_matches_jax(start_step):
    milestones, spe = [10, 30, 50], 3
    jsched = jpretext.multistep_lr(1e-3, milestones, 0.2, spe, start_step)
    tsched = tpretext.multistep_lr(1e-3, milestones, 0.2, spe, start_step)
    for m in milestones:
        b = m * spe - start_step
        for step in (b - 1, b, b + 1, 0, 200):
            if step >= 0:
                np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                           rtol=1e-6)


def _moments(opt_state):
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return [arm_state_dict(jax.tree_util.tree_map(np.asarray, m))
            for m in (adam.mu, adam.nu)]


def test_three_train_steps_match_jax(tmp_path, monkeypatch):
    """Besides the losses and the step-1 parameters, the Adam moments
    after the last step (which see beta1, beta2 and the L2 term, while one
    step's update is about lr*sign(g) whatever they are) and the
    parameters after the LR decay. The L2 weight is raised to 0.05 so that
    its term shows in the moments within three steps."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "6")
    B, steps = 8, 3
    # one step per epoch and a milestone at epoch 1: steps 2 and 3 run at
    # lr * gamma
    jcfg, tcfg = _configs(tmp_path, audioBackend="pallas",
                          pretextLRDecayEpoch=[1], pretextTrainBatchSize=B,
                          pretextAdamL2=0.05)
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    bank, lengths, ranges = taudio.build_clip_bank()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (12, 3, 96, 96)).astype(np.uint8)
    img_idx = rng.randint(0, 12, (steps, B))
    pos_cls = rng.randint(0, 5, (steps, B))
    neg_cls = rng.randint(0, 5, (steps, B))
    pos_ids, pos_zero = taudio.sample_clip_ids(pos_cls.ravel(), ranges, rng)
    neg_ids, neg_zero = taudio.sample_clip_ids(neg_cls.ravel(), ranges, rng)
    idx = [a.reshape(steps, B) for a in (img_idx, pos_ids, pos_zero,
                                         neg_ids, neg_zero)]

    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    jtr._ensure_audio()
    params0 = jtr.init_model(seed=0)["params"]
    jtr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=1)
    state = jpretext.TrainState(params0, jtr.tx.init(params0),
                                jnp.asarray(0, jnp.int32))
    sd0 = arm_state_dict(jax.tree_util.tree_map(np.asarray, params0))

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = VARPretextNet(3)
    ttr.model.load_state_dict(sd0)
    ttr.setup_optimizer(steps_per_epoch=1)
    tbank = {"images": torch.from_numpy(images),
             "wav": torch.from_numpy(bank), "len": torch.from_numpy(lengths)}

    def assert_params_match(atol):
        want = arm_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
        got = ttr.model.state_dict()
        diffs = []
        for k, v in want.items():
            d = (got[k] - v).abs()
            assert d.max().item() <= atol, k
            diffs.append(d.ravel())
        assert torch.cat(diffs).median().item() < 1e-6

    for s in range(steps):
        state, jloss = jtr._train_step_indexed(
            state, jnp.asarray(images), jnp.asarray(bank),
            jnp.asarray(lengths), *(jnp.asarray(a[s]) for a in idx))
        tloss = ttr._train_step_indexed(
            tbank, *(torch.from_numpy(a[s].astype(
                np.int64 if a.dtype != bool else bool)) for a in idx))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
        if s == 0:
            assert_params_match(2.5e-4)
    assert ttr.step == steps
    # two more sign flips at most, each 2 * lr * gamma
    assert_params_match(2.5e-4 + 2 * 2 * 2e-5)
    named = dict(ttr.model.named_parameters())
    for key, want in zip(("exp_avg", "exp_avg_sq"), _moments(state.opt_state)):
        for k, v in want.items():
            got = ttr.optimizer.state[named[k]][key]
            scale = v.abs().max().item()
            torch.testing.assert_close(got, v, rtol=1e-3, atol=1e-3 * scale,
                                       msg=f"{key} {k}")


def test_slice_end_to_end_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "8")
    _, cfg = _configs(tmp_path, audioBackend="pallas")
    trainer = tpretext.PretextTrainer(cfg, device="cpu")
    trainer.run()
    with open(os.path.join(cfg.pretextModelSaveDir, "progress.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["avg_loss"] and len(rows) == 3
    assert np.isfinite([float(r[0]) for r in rows[1:]]).all()
    assert latest_checkpoint(cfg.pretextModelSaveDir).endswith(os.sep + "1")
    ckpt = load_checkpoint(os.path.join(cfg.pretextModelSaveDir, "1"))
    assert ckpt["step"] == trainer.step == 2 * 3  # 24 pairs / batch 8
    assert ckpt["opt_state"]["state"]
    fresh = tpretext.PretextTrainer(cfg, device="cpu")
    fresh.loadPretextModel(cfg.pretextModelSaveDir)  # newest: 1/
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_cli_builds_the_config_and_rejects_unknown_knobs():
    args = parse_args(["--env", "arms", "--device", "cpu", "--set",
                       'audioBackend="pallas"', "pretextEpoch=3"])
    cfg = build_config(args, role="pretext")
    assert (args.device, cfg.audioBackend, cfg.pretextEpoch) == (
        "cpu", "pallas", 3)
    with pytest.raises(SystemExit):
        build_config(parse_args(["--env", "arms", "--set", "noSuchKnob=1"]),
                     role="pretext")


def test_config_knobs_match_jax():
    jcfg, tcfg = jconfig.main_config(env="arms"), tconfig.main_config(env="arms")
    assert vars(tcfg) == vars(jcfg)
    assert tcfg.audioBackend == "fft"
    assert vars(tconfig.main_config(env="ai2thor")) == vars(
        jconfig.main_config(env="ai2thor"))


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    cfg = tconfig.main_config(env="arms")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpretext.PretextTrainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_vec_env_factory_backends(tmp_path):
    """As the JAX factory: 'auto' and 'shmem' give ShmemVecEnv at 2 envs,
    'auto' gives DummyVecEnv at 1, 'dummy' always; an unknown name
    raises."""
    _, cfg = _configs(tmp_path)
    tconfig.gym_register(cfg)
    audio = tstore.AudioStore(cfg)
    audio.loadData()
    cfg.override(vecEnvContext="fork")  # the cheap start; forkserver is
    # the default, tested in tests/test_torch_shmem.py
    for backend, n, kind in (("auto", 2, ShmemVecEnv),
                             ("shmem", 2, ShmemVecEnv),
                             ("auto", 1, DummyVecEnv),
                             ("dummy", 2, DummyVecEnv)):
        cfg.override(vecEnvBackend=backend)
        envs = make_vec_envs(cfg.pretextEnvName, 1, n, None, True, cfg,
                             audio=audio)
        try:
            assert type(envs) is kind and envs.num_envs == n
        finally:
            envs.close()
    with pytest.raises(ValueError, match="frozen VAR"):
        make_vec_envs(cfg.pretextEnvName, 1, 2, None, False, cfg, audio=audio)
    cfg.override(vecEnvBackend="subproc")
    with pytest.raises(ValueError, match="unknown vecEnvBackend"):
        make_vec_envs(cfg.pretextEnvName, 1, 2, None, True, cfg, audio=audio)
