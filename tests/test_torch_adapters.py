"""The simulator adapters (var_tpu_torch/envs/adapters/: PyBullet for the
arm, AI2-THOR's iTHOR for the grid house) against the JAX package's
(var_tpu/envs/adapters/), on the CPU under stand-ins for the simulators.

Neither simulator is installed here. tests/fake_backends.py puts recording
stand-ins into sys.modules (the JAX package's contract tests drive its
adapters through them); tests/torch_adapter_standins.py subclasses them
so that a ray test hits the object under the gripper and iTHOR's objects
are visible from where the agent stands and looks, which a whole pretext
collection needs. Both packages' adapters run on the same stand-ins with
the same seeds and actions:

- a twin of each of the 16 contract tests of tests/test_adapters_contract.py
  (the camera ones also on seeded random frames, so that the resize is
  exercised): the recorded call logs equal, call for call with their
  arguments, and the returned arrays equal;
- whole episodes of all four adapter classes: every observation key,
  reward, done and info equal at every step, and the call logs equal;
- the slice at a small size, for each adapter: both packages'
  collectPretextData write byte-identical shards; one VAR step on them
  agrees with JAX at BASELINE.md's 1e-4 (the arm) and the CRNN's rtol
  1e-3 / atol 2e-4 (ai2thor), the parameters within the one-step Adam
  bound (2 lr + 5e-5, median below 1e-6); the port's fused trainer takes
  one PPO update over adapter envs, and the observations it stored equal,
  step by step, what JAX's adapter envs give for the same seeds and
  actions;
- without the simulator and with vecEnvBackend='auto', the adapters'
  ImportError reaches the parent from its worker processes within 60 s;
- the twins of tests/test_real_adapters_smoke.py, which skip without the
  simulators as JAX's do.

Everything compared is equal, not close, but for the VAR step: the host
code of the two packages is the same numpy, and the port's camera resize
is cv2's fixed-point INTER_LINEAR (envs/recording.py::resize_linear_u8).
"""
import filecmp
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from tests.fake_backends import (
    FakeBulletClient,
    FakeThorController,
    install_fake_ai2thor,
    install_fake_pybullet,
)
from tests.torch_adapter_standins import (
    SysModules,
    install_labelling_ai2thor,
    install_labelling_pybullet,
)
from var_tpu.data import audio_store as jstore
from var_tpu.data import triplets as jtriplets
from var_tpu.envs import make_entry_points as jmake_entry_points
from var_tpu.envs.adapters import ithor as jthor
from var_tpu.envs.adapters import pybullet_arm as jpb
from var_tpu.envs.vec.factory import make_vec_envs as jmake_vec_envs
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_state_dict, arm_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.envs import make_entry_points
from var_tpu_torch.envs.adapters import ithor as tthor
from var_tpu_torch.envs.adapters import pybullet_arm as tpb
from var_tpu_torch.envs.recording import resize_linear_u8
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.train import pretext as tpretext
from var_tpu_torch.train import rl as trl

# (config module, PyBullet adapter module, iTHOR adapter module)
PKGS = {"jax": (jconfig, jpb, jthor), "port": (tconfig, tpb, tthor)}
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
BACKEND = {"arms": "pybullet", "ai2thor": "ithor"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _synthetic_clips(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")


def _same(a, b, where="") -> None:
    """a and b equal: arrays by dtype, shape and value, containers item
    by item, everything else by type and ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b), (where, type(a), type(b))
        assert a == b or (a != a and b != b), (where, a, b)


def _cfg(tag, env, **over):
    cfg = PKGS[tag][0].main_config(env=env)
    cfg.override(**over)
    return cfg


# -- the contract twins: PyBullet -------------------------------------------


@pytest.fixture
def pb_pair(monkeypatch):
    """The JAX and the port RL adapter, connected to one stock stand-in
    module: [(env, client, cfg)] for jax, port."""
    install_fake_pybullet(monkeypatch)
    out = []
    for tag in PKGS:
        cfg = _cfg(tag, "arms", RLTrain=True, RLModelFineTune=False)
        env = PKGS[tag][1].PyBulletFourInARow(cfg, audio=None)
        env._connect()
        out.append((env, FakeBulletClient.instances[-1], cfg))
    assert out[0][1] is not out[1][1]
    return out


def test_pybullet_connect_loads_models_matches_jax(pb_pair):
    (jenv, jc, _), (tenv, tc, cfg) = pb_pair
    _same(jc.calls, tc.calls, "calls")
    assert tc.connection_mode == FakeBulletClient.DIRECT
    assert (tenv.robotId, tenv.tableUid, tenv.objUids) == (
        jenv.robotId, jenv.tableUid, jenv.objUids)
    assert len(tenv.objUids) == len(cfg.objList)
    _same(jenv._ee_orn, tenv._ee_orn)


def test_pybullet_ik_nullspace_contract_matches_jax(pb_pair):
    (jenv, jc, _), (tenv, tc, cfg) = pb_pair
    for env in (jenv, tenv):
        env._move_ee(0.6, 0.12)
    _same(jc.calls, tc.calls, "calls")
    _same(jenv.ee, tenv.ee)
    (ik,) = tc.calls_named("calculateInverseKinematics")
    assert ik[1][2] == [0.6, 0.12, cfg.endEffectorHeight]
    assert ik[2]["restPoses"] == cfg.ik_rp
    assert len(tc.calls_named("stepSimulation")) == cfg.frameSkip


def test_pybullet_action_clipping_matches_jax(pb_pair):
    (jenv, jc, _), (tenv, tc, _) = pb_pair
    for env in (jenv, tenv):
        env.ee = np.array([0.55, 0.0])
        env._apply_action_rl(np.array([5.0, -5.0]))
    _same(jc.calls, tc.calls, "calls")
    (ik,) = tc.calls_named("calculateInverseKinematics")
    assert np.allclose(ik[1][2][:2], [0.57, -0.02])


def test_pybullet_raytest_uid_mapping_matches_jax(pb_pair):
    got = []
    for env, client, _ in pb_pair:
        client.ray_hit_uid = env.objUids[2]
        hit = env.ray_test()
        client.ray_hit_uid = env.tableUid
        got.append((hit, env.ray_test()))
    assert got[0] == got[1] == (2, -1)
    _same(pb_pair[0][1].calls, pb_pair[1][1].calls, "calls")
    assert pb_pair[1][1].calls_named("rayTest")[-1][1][1][2] == -0.1


@pytest.mark.parametrize("frame", ["ramp", "random"])
def test_pybullet_camera_crop_resize_matches_jax(pb_pair, frame):
    """The stand-in's ramp, and seeded random RGBA frames (the ramp's
    columns are an affine map that bilinear weights keep exact)."""
    pytest.importorskip("cv2")  # the JAX adapter resizes with cv2
    (jenv, jc, cfg), (tenv, tc, _) = pb_pair
    h, w, _ = cfg.robotCamRenderSize
    rng = np.random.RandomState(5)
    for _ in range(3 if frame == "random" else 1):
        if frame == "random":
            rgba = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
            jc.camera_image, tc.camera_image = rgba, rgba.copy()
        want, got = jenv.get_image(), tenv.get_image()
        _same(want, got, "image")
        assert got.shape == (96, 96, 3)
        np.testing.assert_array_equal(
            got, resize_linear_u8(tc.camera_image[:, 12:87, :3], 96, 96))
    _same(jc.calls, tc.calls, "calls")


def _episode_pair(env_name, cls_name, monkeypatch, install, over, actions,
                  episodes=1):
    """Both packages' adapter class `cls_name` under one stand-in install,
    seeded alike, driven by `actions(rng)` from reset until done,
    `episodes` times. Returns [(records, client or controller)]."""
    install(monkeypatch)
    stand_in = (FakeBulletClient if env_name == "arms"
                else FakeThorController)
    out = []
    for tag in PKGS:
        mod = PKGS[tag][1 if env_name == "arms" else 2]
        cfg = _cfg(tag, env_name, **over)
        env = getattr(mod, cls_name)(cfg, audio=None)
        env.seed(11)
        rng = np.random.RandomState(3)
        records = []
        for _ in range(episodes):
            records.append(("reset", env.reset()))
            done = False
            while not done:
                obs, reward, done, info = env.step(actions(rng))
                records.append(("step", obs, reward, done, info))
        client = stand_in.instances[-1]
        env.close()
        out.append((records, client))
    return out


def test_pybullet_full_episode_matches_jax(monkeypatch):
    (jrec, jc), (trec, tc) = _episode_pair(
        "arms", "PyBulletFourInARow", monkeypatch, install_fake_pybullet,
        dict(RLTrain=True, RLModelFineTune=False, RLEnvMaxSteps=3),
        lambda rng: np.array([0.5, -0.5]))
    _same(jrec, trec, "episode")
    _same(jc.calls, tc.calls, "calls")
    assert len(trec) == 4 and trec[-1][3] is True
    assert tc.calls_named("disconnect")


def test_pybullet_pretext_episode_matches_jax(monkeypatch):
    (jrec, jc), (trec, tc) = _episode_pair(
        "arms", "PyBulletFourInARowPretext", monkeypatch,
        install_fake_pybullet, dict(pretextEnvMaxSteps=2),
        lambda rng: np.zeros(2, np.float32))
    _same(jrec, trec, "episode")
    _same(jc.calls, tc.calls, "calls")
    assert set(trec[0][1]) >= {"image", "ground_truth", "sound_negative_id"}


def test_pybullet_debug_draw_helpers_match_jax(pb_pair):
    lines = []
    for env, client, _ in pb_pair:
        client.calls.clear()
        rect, grid = [], []
        env.drawRectangleDebug(rect, 0.0, 1.0, -0.5, 0.5, 0.2)
        env.drawGrid(grid, 0.25, 0.0, 1.0, 0.0, 1.0, 0.1)
        env.drawAABB(((0.0, 0.0, 0.0), (1.0, 2.0, 3.0)))
        lines.append((rect, grid))
    _same(lines[0], lines[1], "item ids")
    _same(pb_pair[0][1].calls, pb_pair[1][1].calls, "calls")
    drawn = pb_pair[1][1].calls_named("addUserDebugLine")
    assert len(drawn) == 4 + 6 + 12
    assert [c[1][2] for c in drawn[-12:]].count((1, 1, 1)) == 8


# -- the contract twins: iTHOR ---------------------------------------------


@pytest.fixture
def thor_pair(monkeypatch):
    """The JAX and the port iTHOR RL adapter on one stock stand-in module,
    world built at FloorPlan201: [(env, controller, cfg)]."""
    install_fake_ai2thor(monkeypatch)
    out = []
    for tag in PKGS:
        cfg = _cfg(tag, "ai2thor", RLTrain=True, RLModelFineTune=False,
                   renderUnity=False)
        env = PKGS[tag][2].ITHOREnv(cfg, audio=None)
        env.floor_plan = 201
        env._build_world()
        out.append((env, FakeThorController.instances[-1], cfg))
    return out


def test_ithor_controller_init_contract_matches_jax(thor_pair):
    (_, jc, _), (_, tc, cfg) = thor_pair
    _same(jc.init_kwargs, tc.init_kwargs, "init kwargs")
    assert tc.init_kwargs["scene"] == "FloorPlan201"
    assert tc.init_kwargs["platform"] is not None
    assert tc.init_kwargs["width"] == cfg.img_dim[2]
    _same(jc.calls, tc.calls, "calls")


def test_ithor_occupancy_grid_from_reachable_matches_jax(thor_pair):
    (jenv, _, _), (tenv, tc, cfg) = thor_pair
    _same(jenv.occupancy_grid, tenv.occupancy_grid, "grid")
    _same(jenv.min_xz[201], tenv.min_xz[201], "min_xz")
    _same(jenv.reachable, tenv.reachable, "reachable")
    _same(jenv.robotY, tenv.robotY, "robotY")
    assert int((tenv.occupancy_grid == 0).sum()) == len(tc.reachable)


def test_ithor_teleport_lands_on_reachable_matches_jax(thor_pair):
    for env, _, _ in thor_pair:
        env.np_random = np.random.RandomState(3)
        for _ in range(5):
            env._random_teleport()
    (_, jc, _), (_, tc, cfg) = thor_pair
    _same(jc.calls, tc.calls, "calls")
    _same(jc.agent, tc.agent, "agent")
    assert tc.agent["rotation"]["y"] % cfg.rotateStepDegrees == 0


def test_ithor_setup_task_forces_opposite_state_matches_jax(thor_pair):
    from var_tpu_torch.data.audio_store import Task

    done = []
    for env, ctrl, _ in thor_pair:
        env.np_random = np.random.RandomState(0)
        env.task = Task("livingRoom", "FloorLamp", "ToggleObjectOn")
        ctrl.objects["FloorLamp"]["isToggled"] = True
        env._setup_task()
        first = env.check_task_done()
        ctrl.objects["FloorLamp"]["isToggled"] = True
        ctrl.step(action="Pass")
        done.append((first, env.check_task_done()))
    assert done[0] == done[1] == (False, True)
    _same(thor_pair[0][1].calls, thor_pair[1][1].calls, "calls")


def test_ithor_toggle_targets_visible_object_matches_jax(thor_pair):
    for env, ctrl, _ in thor_pair:
        ctrl.objects["FloorLamp"]["visible"] = True
        ctrl.objects["Television"]["visible"] = False
        env._exe_action("ToggleObjectOn")
        for a in ("MoveAhead", "RotateLeft", "ToggleObjectOff"):
            env._exe_action(a)
    (_, jc, _), (_, tc, _) = thor_pair
    _same(jc.calls, tc.calls, "calls")
    toggles = [c for c in tc.calls if c[0] == "ToggleObjectOn"]
    assert toggles[-1][1]["objectId"] == "FloorLamp|1"
    assert tc.calls[-1][0] == "Pass"


def test_ithor_local_occupancy_map_matches_jax(thor_pair):
    """Every reachable cell at every heading of the adapter's rotate step."""
    maps = []
    for env, ctrl, cfg in thor_pair:
        got = []
        for p in ctrl.reachable:
            for y in np.arange(0, 360, cfg.rotateStepDegrees):
                ctrl.agent["position"] = dict(p)
                ctrl.agent["rotation"] = {"x": 0.0, "y": float(y), "z": 0.0}
                ctrl.step(action="Pass")
                got.append(env.get_local_occupancy_map())
        maps.append(got)
    _same(maps[0], maps[1], "maps")
    n = thor_pair[1][2].RLVisibleGrid
    assert maps[1][0].shape == (n, n) and maps[1][0][n // 2, n // 2] == 128


@pytest.mark.parametrize("frame", ["stand-in", "random"])
def test_ithor_image_resized_matches_jax(thor_pair, frame):
    """The stand-in's blank frame, and seeded random 300 x 300 frames."""
    pytest.importorskip("cv2")  # the JAX adapter resizes with cv2
    rng = np.random.RandomState(9)
    for _ in range(3 if frame == "random" else 1):
        if frame == "random":
            img = rng.randint(0, 256, (300, 300, 3)).astype(np.uint8)
            for _, ctrl, _ in thor_pair:
                ctrl.last_event.frame = img.copy()
        want, got = (env.get_image() for env, _, _ in thor_pair)
        _same(want, got, "image")
        assert got.shape == (96, 96, 3)


def test_ithor_domain_randomization_toggles_matches_jax(thor_pair):
    for env, _, _ in thor_pair:
        env.np_random = np.random.RandomState(1)
        env._domain_randomization()
    (jenv, jc, _), (tenv, tc, _) = thor_pair
    _same(jc.calls, tc.calls, "calls")
    _same(jenv.objMeta, tenv.objMeta, "objMeta")
    names = [c[0] for c in tc.calls]
    assert "Teleport" in names
    assert any(n in ("ToggleObjectOn", "ToggleObjectOff") for n in names)


# -- whole episodes under the labelling stand-ins ----------------------------

EPISODES = {
    "PyBulletFourInARow": (
        "arms", install_labelling_pybullet,
        dict(RLTrain=False, RLEnvMaxSteps=12),
        lambda rng: rng.uniform(-1, 1, 2)),
    "PyBulletFourInARowPretext": (
        "arms", install_labelling_pybullet, dict(pretextEnvMaxSteps=50),
        lambda rng: np.zeros(2, np.float32)),
    "ITHOREnv": (
        "ai2thor", install_labelling_ai2thor,
        dict(RLTrain=False, RLEnvMaxSteps=12, renderUnity=False),
        lambda rng: rng.randint(8)),
    "ITHORPretextEnv": (
        "ai2thor", install_labelling_ai2thor,
        dict(pretextEnvMaxSteps=15, renderUnity=False),
        lambda rng: 0),
}


@pytest.mark.parametrize("cls", list(EPISODES))
def test_whole_episodes_match_jax(monkeypatch, cls):
    """Two episodes from reset until done: every observation, reward,
    done and info equal at every step, and the call logs. The pretext
    classes' labels cover more than the empty class."""
    env_name, install, over, actions = EPISODES[cls]
    (jrec, jc), (trec, tc) = _episode_pair(
        env_name, cls, monkeypatch, install, over, actions, episodes=2)
    _same(jrec, trec, "episodes")
    _same(jc.calls, tc.calls, "calls")
    if "Pretext" in cls:
        cfg = _cfg("port", env_name)
        labels = {int(r[1]["ground_truth"][0]) for r in trec}
        assert labels - {cfg.taskNum}, labels
    else:
        assert "goal_area_count" in trec[-1][4]


# -- the slice at a small size ---------------------------------------------

QUOTA = [2, 2, 2, 2, 4]
COLLECT = dict(pretextCollectNum=QUOTA, pretextDataEpisode=4,
               pretextDataNumFiles=1, pretextEnvMaxSteps=10,
               pretextNumEnvs=2, vecEnvBackend="dummy")
# env steps (over both envs) within which every class must fill its quota
STEP_BOUND = 800


def _slice_configs(env, root, **over):
    extra = dict(sound_dim=(1, 100, 40)) if env == "ai2thor" else {}
    out = []
    for tag in PKGS:
        cfg = _cfg(tag, env, simBackend=BACKEND[env],
                   pretextDataDir=[os.path.join(str(root), tag, "data")],
                   pretextModelSaveDir=os.path.join(str(root), tag, "var"),
                   **COLLECT, **extra, **over)
        PKGS[tag][0].gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _install(env, patch):
    (install_labelling_pybullet if env == "arms"
     else install_labelling_ai2thor)(patch)


@pytest.fixture(scope="module", params=["arms", "ai2thor"])
def collected(request, tmp_path_factory):
    """Both packages' collections through the adapter under the labelling
    stand-ins: (env, jcfg, tcfg, env steps the port took)."""
    env = request.param
    patch = SysModules()
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        _install(env, patch)
        jcfg, tcfg = _slice_configs(env, tmp_path_factory.mktemp(env))
        shards = tpretext.PretextTrainer(tcfg, device="cpu") \
            .collectPretextData() + 1
        jpretext.PretextTrainer(jcfg).collectPretextData()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
        patch.undo()  # a later test installs its own stand-ins
    steps = (shards * tcfg.pretextDataEpisode * tcfg.pretextEnvMaxSteps
             * tcfg.pretextNumEnvs)
    return env, jcfg, tcfg, steps


def test_slice_collection_writes_identical_shards(collected):
    env, jcfg, tcfg, steps = collected
    jdir = os.path.join(jcfg.pretextDataDir[0], "train")
    tdir = os.path.join(tcfg.pretextDataDir[0], "train")
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(jdir, name), os.path.join(tdir, name),
                           shallow=False), name
    items = [x for n in names for x in ttriplets.load_shard(
        os.path.join(tdir, n))]
    counts = np.bincount([int(x["ground_truth"][0]) for x in items],
                         minlength=len(QUOTA))
    assert counts.tolist() == QUOTA
    print(f"{env}: quotas {QUOTA} filled within {steps} env steps")
    assert steps <= STEP_BOUND


@pytest.mark.slow
def test_slice_var_step_matches_jax(collected):
    """One VAR step on the collected triplets, from JAX's initial weights:
    the datasets equal, the loss within BASELINE's tolerance, the
    parameters within the Adam bound. `slow`: JAX's compiles of its init
    and step take most of the file's time."""
    env, jcfg, tcfg, _ = collected
    B = 4
    # the port's MFCC through the kernel's wrapper (its plain version on the
    # CPU), JAX's through its default 'fft' path
    jcfg.override(pretextTrainBatchSize=B)
    tcfg.override(audioBackend="pallas", pretextTrainBatchSize=B)
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    jds = jtriplets.load_env_data(jcfg, jaudio)
    tds = ttriplets.load_env_data(tcfg, taudio)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.gts, jds.gts)
    bank, lengths, ranges = taudio.build_clip_bank()
    img = tds.epoch_order(0, shuffle=True)[:B]
    pos, pos_zero, neg, neg_zero = (a[img] for a in
                                    tds.epoch_clip_ids(ranges, 0))
    idx = (img, pos, pos_zero, neg, neg_zero)
    to_sd = arm_state_dict if env == "arms" else ai2thor_state_dict

    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    jtr._ensure_audio()
    # JAX's initial draw (init_model's, the same values) under jit: the
    # CRNN's eager init takes about three times as long
    zeros = [jnp.zeros((1,) + tuple(d), jnp.float32)
             for d in (jcfg.img_dim, jcfg.sound_dim, jcfg.sound_dim)]
    params0 = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), *zeros)["params"]
    jtr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=1)
    state = jpretext.TrainState(params0, jtr.tx.init(params0),
                                jnp.asarray(0, jnp.int32))
    sd0 = to_sd(jax.tree_util.tree_map(np.asarray, params0))
    state, jloss = jtr._train_step_indexed(
        state, jnp.asarray(jds.images), jnp.asarray(bank),
        jnp.asarray(lengths), *(jnp.asarray(a) for a in idx))

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = VARPretextNet(3, "arm" if env == "arms" else "ai2thor")
    ttr.model.load_state_dict(sd0)
    ttr.setup_optimizer(steps_per_epoch=1)
    tbank = {"images": torch.from_numpy(tds.images),
             "wav": torch.from_numpy(bank), "len": torch.from_numpy(lengths)}
    tloss = ttr._train_step_indexed(tbank, *(torch.from_numpy(
        a.astype(bool if a.dtype == bool else np.int64)) for a in idx))
    tol = dict(rtol=1e-4, atol=1e-4) if env == "arms" else CRNN_TOL
    np.testing.assert_allclose(tloss.item(), float(jloss), **tol)
    want = to_sd(jax.tree_util.tree_map(np.asarray, state.params))
    got = ttr.model.state_dict()
    diffs = torch.cat([(got[k] - v).abs().ravel() for k, v in want.items()])
    assert diffs.max().item() <= 2 * jcfg.pretextLR + 5e-5
    assert diffs.median().item() < 1e-6


def test_slice_fused_ppo_update_stores_jax_observations(collected,
                                                       monkeypatch, tmp_path):
    """The port's fused trainer (trainRL, fusedRollout) takes one PPO
    update over 2 adapter envs (6 steps, episodes of 4, so one auto-reset
    inside the rollout); its stored images, extra observations and masks
    equal what JAX's adapter envs give from the same seeds under the
    actions the port drew."""
    env, jcfg, tcfg, _ = collected
    _install(env, monkeypatch)
    T, N = 6, 2
    knobs = dict(RLTrain=True, RLModelFineTune=False, fusedRollout=True,
                 RLNumEnvs=N, RLEnvMaxSteps=4, ppoNumSteps=T,
                 RLTotalSteps=T * N, ppoNumMiniBatch=1, ppoEpoch=1,
                 RLRecurrentSize=32, RLRecurrentInputSize=16,
                 RLModelSaveDir=str(tmp_path / "rl"), renderUnity=False)
    if env == "arms":
        knobs.pop("renderUnity")
    for cfg in (jcfg, tcfg):
        cfg.override(**knobs)
    trainer = trl.RLTrainer(tcfg, device="cpu")
    var = VARPretextNet(3, "arm" if env == "arms" else "ai2thor")
    var.reset_parameters(torch.Generator().manual_seed(0))
    trainer.pretext_model = var.eval().requires_grad_(False)
    stored, update = [], trainer.update

    def record(engine, perms=None):
        stored.append({k: v.clone() for k, v in
                       engine.buffers.as_dict().items()})
        return update(engine, perms)

    trainer.update = record
    trainer.trainRL()
    assert len(stored) == 1
    b = stored[0]
    assert all(np.isfinite(v) for v in trainer.update_stats[0])
    extra = "robot_pose" if env == "arms" else "occupancy"
    envs = jmake_vec_envs(env_name=jcfg.RLEnvName, seed=jcfg.RLEnvSeed,
                          num_processes=N, gamma=None, randomCollect=True,
                          config=jcfg)
    obs = envs.reset()
    dones = 0
    for t in range(T + 1):
        np.testing.assert_array_equal(b["obs_image"][t].numpy(), obs["image"],
                                      err_msg=f"image {t}")
        np.testing.assert_array_equal(
            b["obs_extra"][t].numpy(),
            np.asarray(obs[extra], b["obs_extra"].numpy().dtype),
            err_msg=f"{extra} {t}")
        if t == T:
            break
        action = b["actions"][t].numpy()
        obs, _, done, _ = envs.step(action if env == "arms"
                                    else action.astype(np.int64))
        np.testing.assert_array_equal(b["masks"][t + 1].numpy(),
                                      (~done).astype(np.float32))
        dones += int(done.sum())
    envs.close()
    assert dones == N  # every env reset once inside the rollout


# -- the entry points and the missing simulators ----------------------------


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_make_entry_points_builds_the_adapters(env):
    pretext, rl = make_entry_points(_cfg("port", env,
                                         simBackend=BACKEND[env]), env)
    jpre, jrl = jmake_entry_points(_cfg("jax", env, simBackend=BACKEND[env]),
                                  env)
    assert (pretext.__name__, rl.__name__) == (jpre.__name__, jrl.__name__)
    mod = tpb if env == "arms" else tthor
    assert pretext.__module__ == mod.__name__ == rl.__module__
    builtin = make_entry_points(_cfg("port", env), env)
    assert all(c.__module__.startswith("var_tpu_torch.envs.")
               and "adapters" not in c.__module__ for c in builtin)


@pytest.mark.parametrize("backend", [None, "pybullet", "ithor"])
def test_make_entry_points_refuses_an_unknown_env(backend):
    """An env neither package has raises what the JAX package raises:
    NotImplementedError with the env's name as its one argument."""
    over = {} if backend is None else {"simBackend": backend}
    errors = []
    for tag, make in (("jax", jmake_entry_points),
                      ("port", make_entry_points)):
        with pytest.raises(NotImplementedError) as e:
            make(_cfg(tag, "arms", **over), "kitchen")
        errors.append((type(e.value), e.value.args))
    assert errors[0] == errors[1] == (NotImplementedError, ("kitchen",))


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_missing_simulator_raises_jax_import_error(env):
    """No stand-in, no simulator: the first reset raises the ImportError
    the JAX adapter raises, word for word; nothing falls back."""
    msgs = []
    for tag in PKGS:
        cfg = _cfg(tag, env, simBackend=BACKEND[env], renderUnity=False) \
            if env == "ai2thor" else _cfg(tag, env, simBackend="pybullet")
        cls = (PKGS[tag][1].PyBulletFourInARow if env == "arms"
               else PKGS[tag][2].ITHOREnv)
        with pytest.raises(ImportError) as err:
            cls(cfg, audio=None).reset()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_missing_simulator_reaches_the_parent_from_workers(env, tmp_path):
    """vecEnvBackend='auto' starts a worker per env (ShmemVecEnv); the
    adapter's ImportError in the workers reaches the parent, which stops
    them, within 60 s (the collection runs in a thread the test waits on
    that long)."""
    cfg = _cfg("port", env, simBackend=BACKEND[env], pretextNumEnvs=2,
               vecEnvBackend="auto", pretextCollectNum=[1] * 5,
               pretextDataDir=[str(tmp_path / "data")])
    tconfig.gym_register(cfg, env=env)
    raised = []

    def collect():
        try:
            tpretext.PretextTrainer(cfg, device="cpu").collectPretextData()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            raised.append(e)

    thread = threading.Thread(target=collect, daemon=True)
    thread.start()
    thread.join(60)
    assert not thread.is_alive(), "the parent still waits on its workers"
    assert len(raised) == 1 and isinstance(raised[0], ImportError), raised
    assert str(raised[0]).startswith(f"simBackend='{BACKEND[env]}' requires")


# -- the real simulators (tests/test_real_adapters_smoke.py's twins) --------


def _check_rl_obs(obs, cfg, extra_key):
    assert obs["image"].shape == tuple(cfg.img_dim)
    assert obs["image"].dtype == np.uint8
    assert obs["goal_sound"].shape == tuple(cfg.sound_dim)
    assert obs["goal_sound_feat"].shape == (cfg.representationDim,)
    assert extra_key in obs


@pytest.mark.slow
def test_pybullet_arm_adapter_real():
    pytest.importorskip("pybullet")
    pytest.importorskip("pybullet_data")
    cfg = _cfg("port", "arms", simBackend="pybullet", RLTrain=True)
    sdf = os.path.join(cfg.mediaPath, "kuka", "kuka_with_gripper2.sdf")
    if not os.path.exists(sdf):
        pytest.skip(f"reference URDF/SDF assets not found under "
                    f"{cfg.mediaPath!r}")
    env = tpb.PyBulletFourInARow(cfg)
    env.seed(0)
    try:
        obs = env.reset()
        _check_rl_obs(obs, cfg, "robot_pose")
        pose0 = obs["robot_pose"].copy()
        for _ in range(3):
            obs, rew, done, info = env.step(np.asarray([1.0, 0.0]))
            _check_rl_obs(obs, cfg, "robot_pose")
            assert np.isfinite(rew)
        assert not np.allclose(obs["robot_pose"], pose0)
        assert -1 <= env.ray_test() < len(cfg.objList)
    finally:
        env.close()


@pytest.mark.slow
def test_ithor_adapter_real():
    pytest.importorskip("ai2thor")
    cfg = _cfg("port", "ai2thor", simBackend="ithor", RLTrain=True,
               renderUnity=False)
    env = tthor.ITHOREnv(cfg)
    env.seed(0)
    try:
        try:
            obs = env.reset()
        except Exception as e:  # the Unity runtime is a separate install
            if "Unity" in str(e) or "display" in str(e).lower():
                pytest.skip(f"ai2thor Unity runtime unavailable: {e}")
            raise
        _check_rl_obs(obs, cfg, "occupancy")
        assert obs["occupancy"].shape == (
            1, cfg.RLVisibleGrid, cfg.RLVisibleGrid)
        for action in (0, 4, 5):
            obs, rew, done, info = env.step(action)
            _check_rl_obs(obs, cfg, "occupancy")
            assert not np.isfinite(obs["goal_sound"]).any()
    finally:
        env.close()
