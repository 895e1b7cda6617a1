"""The port's ai2thor profile against the JAX package on the CPU: the
config, the FSC audio store (synthetic bank and the CSV loader), the
bidirectional GRU, the CRNN VAR (ai2thor_VARPretextNet) and a training
step, the ai2thor policy; and the profile's runs through the entry points
(pretext, RL on both paths, the E2E runner) at SKILL sizes. The grid sims
and the RL engines are held in tests/test_torch_grid_sim.py.

Tolerances:
- the CRNN's outputs (the sound branch and what reads it: sound
  embeddings, losses) at rtol 1e-3 / atol 2e-4, BASELINE.md's allowance
  for the ai2thor CRNN only: its 11x11 convolutions and 73-step BiGRU sum
  in another order on each side, and the errors compound through the
  recurrence;
- everything else at rtol = atol = 1e-4 (IEEE float32 on both sides,
  only the order of summation differs);
- parameters after one Adam step within 2.5e-4 with a median difference
  below 1e-6 (Adam moves a weight by about lr whatever its gradient, so a
  near-zero gradient that rounds to the other sign differs by 2*lr);
- clip banks, shards, labels and sim observations are integer/numpy code
  and must be identical.
Reduced sizes: batch 2-4, sound (1, 100, 40) for the VAR step (the CRNN
runs at any length; 600 frames for the encoders and the bank), policy GRU
32.
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import VARPretextNet as JaxVAR
from var_tpu.ops import gru as jgru
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_policy_state_dict, ai2thor_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.envs import spaces as tspaces
from var_tpu_torch.models import policy as tpolicy
from var_tpu_torch.models.encoders import (VARPretextNet, build_pretext_model,
                                           conv)
from var_tpu_torch.ops import gru as tgru
from var_tpu_torch.rl import main as rl_main
from var_tpu_torch.tools import e2e_run
from var_tpu_torch.train import pretext as tpretext

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _configs(**knobs):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="ai2thor")
        if knobs:
            cfg.override(**knobs)
        out.append(cfg)
    return out


# -- config and audio store -------------------------------------------------


def test_config_knobs_match_jax():
    jcfg, tcfg = _configs()
    assert vars(tcfg) == vars(jcfg)
    assert (tcfg.audioBackend, tcfg.sound_dim, tcfg.RLRecurrentSize) == (
        "fft", (1, 600, 40), 1024)


def test_synthetic_clip_bank_is_byte_identical(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "5")
    jcfg, tcfg = _configs()
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    assert taudio.task_tuples == jaudio.task_tuples
    assert taudio.transcription == jaudio.transcription
    for c in range(tcfg.taskNum):
        for a, b in zip(taudio.class_clips(c), jaudio.class_clips(c)):
            np.testing.assert_array_equal(a, b)
    tb, jb = taudio.build_clip_bank(), jaudio.build_clip_bank()
    assert tb[0].shape[1] == 600 * 160 + 512 and tb[0].dtype == np.int16
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    # the goal draws: synonyms, then the clip, from one RandomState
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for c in (0, 1, 2, 3, 4, 1):
        np.testing.assert_array_equal(taudio.gen_feat_for_class(c, tr),
                                      jaudio.gen_feat_for_class(c, jr))
    assert tr.randint(1 << 30) == jr.randint(1 << 30)


def _fsc_corpus(root):
    """A tiny FSC-layout corpus: wavs under FSC/wavs, the metadata CSV under
    FSC/data; rows out of order, other objects and locations, a clip too
    long and a missing class (music/deactivate)."""
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "FSC", "data"))
    os.makedirs(os.path.join(root, "FSC", "wavs"))
    rows = []
    spec = [("lights", "activate", "none", 1.0), ("lamp", "deactivate", "none", 1.5),
            ("lights", "deactivate", "none", 0.8), ("heat", "increase", "none", 1.0),
            ("lights", "activate", "kitchen", 1.0), ("music", "activate", "none", 2.0),
            ("lights", "activate", "none", 7.0), ("lights", "activate", "none", 1.2),
            ("lamp", "activate", "none", 1.1), ("lights", "deactivate", "none", 0.9)]
    for i, (obj, act, loc, dur) in enumerate(spec):
        rel = os.path.join("wavs", f"clip{i}.wav")
        wavfile.write(os.path.join(root, "FSC", rel), 16000,
                      (rng.randn(int(dur * 16000)) * 3000).astype(np.int16))
        rows.append({"": i, "path": rel, "speakerId": "s", "transcription":
                     f"{act} {obj} {i}", "action": act, "object": obj,
                     "location": loc})
    with open(os.path.join(root, "FSC", "data", "train_data.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_fsc_csv_loader_matches_pandas(tmp_path, monkeypatch):
    """The csv-module loader selects the same rows, in the same order, as
    the JAX package's pandas loader; the missing class is back-filled."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    _fsc_corpus(str(tmp_path))
    knobs = dict(commonMediaPath=str(tmp_path))
    jcfg, tcfg = _configs(**knobs)
    jcfg.soundSource["size"] = tcfg.soundSource["size"] = 2
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    with pytest.warns(UserWarning, match="back-filled"):
        taudio.loadData()
    with pytest.warns(UserWarning, match="back-filled"):
        jaudio.loadData()
    assert taudio.transcription == jaudio.transcription
    assert taudio.transcription["none"]["lights"]["activate"] == [
        "activate lights 0", "activate lights 7"]
    for loc, objs in jaudio.words.items():
        for obj, acts in objs.items():
            assert set(taudio.words[loc][obj]) == set(acts)
            for act, clips in acts.items():
                for a, b in zip(taudio.words[loc][obj][act], clips):
                    np.testing.assert_array_equal(a, b)
    for a, b in zip(taudio.build_clip_bank(), jaudio.build_clip_bank()):
        np.testing.assert_array_equal(a, b)


# -- the bidirectional GRU and the CRNN VAR ----------------------------------


def test_bigru_final_matches_jax():
    rng = np.random.RandomState(0)
    D, H = 12, 16

    def params():
        s = 1.0 / np.sqrt(H)
        return [rng.uniform(-s, s, shape).astype(np.float32) for shape in
                ((3 * H, D), (3 * H, H), (3 * H,), (3 * H,))]

    fwd, bwd = params(), params()
    xs = rng.randn(3, 9, D).astype(np.float32)
    want = jgru.bigru_final(jgru.GRUParams(*map(jnp.asarray, fwd)),
                            jgru.GRUParams(*map(jnp.asarray, bwd)),
                            jnp.asarray(xs))
    got = tgru.bigru_final(tgru.GRUParams(*map(_t, fwd)),
                           tgru.GRUParams(*map(_t, bwd)), _t(xs))
    _close(got, want, **CRNN_TOL)


@pytest.fixture(scope="module")
def var_pair():
    """The JAX ai2thor VAR at full width, its port with the JAX parameters,
    and numpy-seeded inputs (sounds at the profile's 600 frames)."""
    rng = np.random.RandomState(0)
    img = rng.rand(2, 3, 96, 96).astype(np.float32)
    snd = (rng.randn(2, 1, 600, 40) * 3).astype(np.float32)
    jmodel = JaxVAR(variant="ai2thor", representation_dim=3)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(img),
                                     jnp.asarray(snd), jnp.asarray(snd))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = VARPretextNet(3, "ai2thor")
    model.load_state_dict(ai2thor_state_dict(params))
    return jmodel, variables, params, model, img, snd


def test_state_dict_covers_every_parameter(var_pair):
    _, _, params, model, _, _ = var_pair
    sd = ai2thor_state_dict(params)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


@pytest.mark.parametrize("which", ["image", "sound"])
def test_branches_and_encoders_match_jax(var_pair, which):
    jmodel, variables, _, model, img, snd = var_pair
    x = img if which == "image" else snd
    jraw, jfeat = jax.jit(jmodel.apply, static_argnames="method")(
        variables, jnp.asarray(x),
        method=getattr(JaxVAR, f"encode_{which}"))
    with torch.no_grad():
        raw, feat = getattr(model, f"encode_{which}")(_t(x))
    tol = TOL if which == "image" else CRNN_TOL
    # the image's raw features are the port's CHW flatten of JAX's HWC one
    if which == "image":
        raw = raw.reshape(2, 128, 3, 3).permute(0, 2, 3, 1).reshape(2, -1)
    _close(raw, jraw, **tol)
    _close(feat, jfeat, **tol)


def test_registry_builds_the_crnn():
    _, tcfg = _configs()
    model = build_pretext_model(tcfg)
    assert isinstance(model.sound_branch, type(VARPretextNet(3, "ai2thor")
                                               .sound_branch))
    tcfg.override(computeDtype="bfloat16")
    model = build_pretext_model(tcfg)
    assert model.dtype == torch.bfloat16
    snd = torch.randn(2, 1, 100, 40)
    with torch.no_grad():
        # the CRNN's convs run in bf16, its GRU in float32 (state cast back)
        assert conv(model.sound_branch.convs[0], snd,
                    model.sound_branch.dtype).dtype == torch.bfloat16
        assert model.encode_image(torch.rand(2, 3, 96, 96))[0].dtype == \
            torch.bfloat16
        raw, feat = model.encode_sound(snd)
    assert raw.dtype == torch.bfloat16 and feat.dtype == torch.float32


def test_one_train_step_matches_jax(monkeypatch):
    """One pretext step (gathers, MFCC through the plain mel-log-DCT,
    CRNN forward and backward, L2 Adam) from the same parameters, bank and
    indices: the loss within the CRNN's tolerance, the parameters within
    the Adam bound."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    B = 4
    knobs = dict(audioBackend="pallas", sound_dim=(1, 100, 40),
                 pretextTrainBatchSize=B)
    jcfg, tcfg = _configs(**knobs)
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    bank, lengths, ranges = taudio.build_clip_bank()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (6, 3, 96, 96)).astype(np.uint8)
    img_idx = rng.randint(0, 6, B)
    pos_ids, pos_zero = taudio.sample_clip_ids(rng.randint(0, 5, B), ranges, rng)
    neg_ids, neg_zero = taudio.sample_clip_ids(rng.randint(0, 5, B), ranges, rng)
    idx = (img_idx, pos_ids, pos_zero, neg_ids, neg_zero)

    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    jtr._ensure_audio()
    params0 = jtr.init_model(seed=0)["params"]
    jtr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=1)
    state = jpretext.TrainState(params0, jtr.tx.init(params0),
                                jnp.asarray(0, jnp.int32))
    # read before the step, which donates the state's buffers
    sd0 = ai2thor_state_dict(jax.tree_util.tree_map(np.asarray, params0))
    state, jloss = jtr._train_step_indexed(
        state, jnp.asarray(images), jnp.asarray(bank), jnp.asarray(lengths),
        *(jnp.asarray(a) for a in idx))

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = VARPretextNet(3, "ai2thor")
    ttr.model.load_state_dict(sd0)
    ttr.setup_optimizer(steps_per_epoch=1)
    tbank = {"images": torch.from_numpy(images),
             "wav": torch.from_numpy(bank), "len": torch.from_numpy(lengths)}
    tloss = ttr._train_step_indexed(tbank, *(torch.from_numpy(
        a.astype(bool if a.dtype == bool else np.int64)) for a in idx))
    np.testing.assert_allclose(tloss.item(), float(jloss), **CRNN_TOL)
    want = ai2thor_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    got = ttr.model.state_dict()
    diffs = []
    for k, v in want.items():
        d = (got[k] - v).abs()
        assert d.max().item() <= 2.5e-4, k
        diffs.append(d.ravel())
    assert torch.cat(diffs).median().item() < 1e-6


# -- the ai2thor policy -------------------------------------------------------


class SmallCfg:
    RLPolicyBase = "ai2thor_VAR"
    representationDim = 3
    RLRecurrentPolicy = True
    RLRecurrentInputSize = 16
    RLRecurrentSize = 32
    RLActionHiddenSize = 32
    RLVisibleGrid = 9
    computeDtype = "float32"
    img_dim = (3, 96, 96)


def _obs(rng, n):
    return {
        "image": rng.randint(0, 256, (n, 3, 96, 96)).astype(np.uint8),
        "occupancy": rng.choice([0, 128, 255], (n, 1, 9, 9)).astype(np.uint8),
        "image_feat": rng.randn(n, 3).astype(np.float32),
        "goal_sound_feat": rng.randn(n, 3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def policies():
    cfg = SmallCfg()
    jpol = jpolicy.build_policy(cfg, JDiscrete(8))
    obs = {k: jnp.asarray(v) for k, v in _obs(np.random.RandomState(0), 4).items()}
    variables = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(0), obs, jnp.zeros((4, 32)), jnp.ones((4, 1)), 1)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tpol = tpolicy.build_policy(cfg, tspaces.Discrete(8))
    sd = ai2thor_policy_state_dict(params)
    assert set(sd) == set(tpol.state_dict())
    tpol.load_state_dict(sd)
    return jpol, variables, tpol


def test_policy_act_with_gumbel_noise_matches_jax(policies):
    jpol, variables, tpol = policies
    rng = np.random.RandomState(1)
    N = 4
    obs = _obs(rng, N)
    hx = rng.randn(N, 32).astype(np.float32)
    masks = np.array([[1.0], [0.0], [1.0], [1.0]], np.float32)
    key = jax.random.PRNGKey(5)
    jstep = jpolicy.act(jpol, variables, {k: jnp.asarray(v) for k, v in
                                          obs.items()},
                        jnp.asarray(hx), jnp.asarray(masks), key)
    # jax.random.categorical adds Gumbel noise drawn from this key
    gumbel = np.asarray(jax.random.gumbel(key, (N, 8), jnp.float32))
    step = tpolicy.act(tpol, {k: _t(v) for k, v in obs.items()}, _t(hx),
                       _t(masks), noise=_t(gumbel))
    np.testing.assert_array_equal(step.action.numpy(), np.asarray(jstep.action))
    for got, want in zip(step, jstep):
        _close(got, want)


def test_policy_evaluate_actions_matches_jax(policies):
    jpol, variables, tpol = policies
    rng = np.random.RandomState(9)
    T, N = 3, 4
    obs = _obs(rng, T * N)
    hx = rng.randn(N, 32).astype(np.float32)
    masks = np.ones((T * N, 1), np.float32)
    masks[N:N + 2] = 0.0
    actions = rng.randint(0, 8, (T * N, 1)).astype(np.int32)
    jv, jlp, jent = jpolicy.evaluate_actions(
        jpol, variables, {k: jnp.asarray(v) for k, v in obs.items()},
        jnp.asarray(hx), jnp.asarray(masks), jnp.asarray(actions), T)
    tv, tlp, tent = tpolicy.evaluate_actions(
        tpol, {k: _t(v) for k, v in obs.items()}, _t(hx), _t(masks),
        _t(actions), T)
    _close(tv, jv)
    _close(tlp, jlp)
    _close(tent, jent)


# -- the entry points, at SKILL sizes ------------------------------------------


@pytest.fixture(scope="module")
def var_checkpoint(tmp_path_factory):
    """A port ai2thor VAR checkpoint from the pretext entry point."""
    from var_tpu_torch.pretext import main as pretext_main

    root = tmp_path_factory.mktemp("grid")
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        pretext_main([
            "--env", "ai2thor", "--device", "cpu", "--set",
            f'pretextDataDir=["{root / "data"}"]',
            f'pretextModelSaveDir="{root / "var"}"',
            "pretextCollectNum=[3,3,3,3,6]", "pretextDataEpisode=4",
            "pretextDataNumFiles=1", "pretextEnvMaxSteps=8",
            "pretextNumEnvs=2", "pretextEpoch=2", "pretextModelSaveInterval=2",
            "pretextTrainBatchSize=8", 'audioBackend="pallas"',
            "sound_dim=(1, 100, 40)", 'vecEnvBackend="dummy"'])
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return root


@pytest.mark.parametrize("device_sim", [False, True])
def test_rl_train_and_eval_through_the_cli(var_checkpoint, device_sim):
    """SKILL stages 2-3 with --env ai2thor on the CPU: the fused host path
    or the device sim; checkpoints, progress.csv and the eval CSV."""
    root = var_checkpoint
    save = root / ("rl_dev" if device_sim else "rl")
    common = [
        f'pretextModelLoadDir="{root / "var" / "1"}"',
        f'RLModelSaveDir="{save}"', "RLModelFineTune=False",
        "RLNumEnvs=2", "RLEnvMaxSteps=6", "ppoNumSteps=6",
        "RLRecurrentSize=32", "RLRecurrentInputSize=16",
        "sound_dim=(1, 100, 40)", 'vecEnvBackend="dummy"']
    train = rl_main(["--env", "ai2thor", "--device", "cpu", "--set",
                     *common, "RLTrain=True", "RLTotalSteps=24",
                     "RLModelSaveInterval=1", "RLLogInterval=1",
                     f"RLDeviceSimRollout={device_sim}"])
    assert len(train.update_stats) == 2
    assert sorted(p for p in os.listdir(save) if p.isdigit()) == [
        "00000", "00001"]
    with open(save / "progress.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    rl_main(["--env", "ai2thor", "--device", "cpu", "--set", *common,
             "RLTrain=False", "testEpisodesPerClass=1",
             f"RLDeviceSimEval={device_sim}",
             f'skillInfos=[{{"path": "{save / "00001"}", "actionDim": 8}}]'])
    name = "test_00001_devicesim.csv" if device_sim else "test_00001.csv"
    with open(save / name) as f:
        rows = list(csv.DictReader(f))
    assert [r["objIdx"] for r in rows] == ["0", "1", "2", "3"]


def test_e2e_runner_rehearses_the_grid_stages(tmp_path):
    out = tmp_path / "E2E_port.json"
    result = e2e_run.main([
        str(tmp_path / "work"), "--env", "ai2thor", "--device", "cpu",
        "--device-sim", "--num-envs", "2", "--rl-steps", "8",
        "--collect-per-class", "2", "--var-epochs", "1",
        "--eval-per-class", "1", "--eval-envs", "1",
        "--device-eval-per-class", "2", "--device-eval-envs", "2",
        "--out", str(out), "--set", "RLEnvMaxSteps=4",
        "RLRecurrentSize=32", "RLRecurrentInputSize=16",
        "sound_dim=(1, 100, 40)", "pretextEnvMaxSteps=8"])
    assert result["device_sim"] and result["num_envs"] == 2
    assert result["eval_episodes"] == 4
    assert result["device_eval"]["eval_episodes"] == 8
    for r in (result, result["device_eval"]):
        assert 0.0 <= r["success_rate"] <= 1.0 and r["ci95"] > 0
    with open(out) as f:
        assert "ai2thor" in json.load(f)["profiles"]
