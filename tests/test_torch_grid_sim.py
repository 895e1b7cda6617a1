"""The port's grid (ai2thor-profile) sims against the JAX package and the
host sim on the CPU: the host GridHouseSim and GridHousePretextSim and the
collection on them, the device sim's plan bank, render, visibility,
occupancy crop, actions and resets (envs/grid_sim_device.py), and the card
checks of the grid paths rehearsed on the CPU. The engines that run on
these sims are held in tests/test_torch_grid_rl.py.

Tolerances:
- host-sim observations, images, occupancy crops, positions, headings,
  toggles, labels, visibility, success bits and counts: equal. The host sim
  is the ground truth for the device sim; the port samples rays and lines
  of sight in float64 as the host does, and equals it everywhere. JAX
  samples its rays in float32 and differs from the host at a few pixels of
  about a fifth of the states (within its own bound, 0.2% of an image,
  tests/test_grid_sim_device.py:87); where it agrees with the host the port
  is held against it too;
- the card checks' own tolerances are stated in
  var_tpu_torch/tools/rl_check.py; with the CPU in the card's place they
  find no difference at all.
Reduced sizes: T = 6 steps, N = 4 envs, GRU 32, GRU input 16, sound
(1, 100, 40) (the CRNN runs at any length), 3 synthetic clips per class.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.envs import grid_sim as jgrid
from var_tpu.envs import grid_sim_device as jdev
from var_tpu_torch import config as tconfig
from var_tpu_torch.envs import grid_sim as tgrid
from var_tpu_torch.envs import grid_sim_device as tdev
from var_tpu_torch.tools.rl_check import (card_against_cpu,
                                          device_sim_card_against_cpu,
                                          render_card_against_host)

TOL = dict(rtol=1e-4, atol=1e-4)
T, N, A = 6, 4, 8  # steps, envs, actions
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
             RLRecurrentSize=32, RLRecurrentInputSize=16,
             sound_dim=(1, 100, 40), vecEnvBackend="dummy")


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """One torch thread per test worker; 3 synthetic clips per class."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**extra):
    """(JAX config, port config) with the same knobs, envs registered."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="ai2thor")
        cfg.override(**{**SMALL, **extra})
        mod.gym_register(cfg, env="ai2thor")
        out.append(cfg)
    return out


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


@pytest.fixture
def jax_numpy_render(monkeypatch):
    """Both packages' host sims on their numpy raycast: the JAX sim's
    get_image patched to its `_render_numpy`, the port's through
    VAR_TPU_NO_NATIVE. By default both render natively (byte for byte the
    same library, tests/test_torch_native.py), so the tests without this
    fixture hold the default paths to each other; the tests with it hold
    the port's plain render to JAX's on purpose, because the device sims
    copy that render (envs/grid_sim_device.py) and a user may ask for it."""
    monkeypatch.setattr(jgrid.GridHouseSim, "get_image",
                        jgrid.GridHouseSim._render_numpy)
    monkeypatch.setenv("VAR_TPU_NO_NATIVE", "1")


def _assert_obs_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the host sims ----------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_host_rl_sim_matches_jax(train):
    """Seeded episodes with every action, both sims on their default
    (native) render: observations byte-identical, rewards, dones and the
    eval's goal_area_count equal."""
    _rl_episodes_match(train)


def test_host_rl_sim_numpy_render_matches_jax(jax_numpy_render):
    """The same on both packages' numpy raycast."""
    _rl_episodes_match(True)


def _rl_episodes_match(train):
    jcfg, tcfg = _configs(RLTrain=train)
    jenv, tenv = jgrid.GridHouseSim(jcfg), tgrid.GridHouseSim(tcfg)
    for env in (jenv, tenv):
        env.seed(11)
    _assert_obs_equal(tenv.reset(), jenv.reset())
    rng = np.random.RandomState(0)
    for _ in range(3 * T):
        a = rng.randint(A)
        tout, jout = tenv.step(a), jenv.step(a)
        _assert_obs_equal(tout[0], jout[0])
        assert tout[1:] == jout[1:]
        assert (tenv.pos == jenv.pos).all() and tenv.rot == jenv.rot
        if tout[2]:
            _assert_obs_equal(tenv.reset(), jenv.reset())
    assert jenv.episodeCounter == tenv.episodeCounter == 3


def test_host_pretext_sim_matches_jax():
    jcfg, tcfg = _configs(pretextEnvMaxSteps=5)
    jenv = jgrid.GridHousePretextSim(jcfg)
    tenv = tgrid.GridHousePretextSim(tcfg)
    for env in (jenv, tenv):
        env.seed(3)
    _assert_obs_equal(tenv.reset(), jenv.reset())
    labels = []
    for _ in range(30):
        tout, jout = tenv.step(0), jenv.step(0)
        _assert_obs_equal(tout[0], jout[0])
        labels.append(int(tout[0]["ground_truth"][0]))
        if tout[2]:
            _assert_obs_equal(tenv.reset(), jenv.reset())
    assert len(set(labels)) >= 3  # objects in view, and the empty class


def test_pretext_collection_matches_jax(tmp_path):
    """Both packages' collectors from one seed write identical shards (on
    DummyVecEnv; tests/test_torch_shmem.py collects at the defaults)."""
    from var_tpu.train import pretext as jpretext
    from var_tpu_torch.data.triplets import load_shard
    from var_tpu_torch.train import pretext as tpretext

    knobs = dict(pretextCollectNum=[2, 2, 2, 2, 4], pretextDataEpisode=3,
                 pretextDataNumFiles=1, pretextEnvMaxSteps=6,
                 pretextNumEnvs=2)
    jcfg, tcfg = _configs(**knobs)
    for cfg, tag in ((jcfg, "jax"), (tcfg, "port")):
        cfg.override(pretextDataDir=[str(tmp_path / tag)])
    jpretext.PretextTrainer(jcfg).collectPretextData()
    tpretext.PretextTrainer(tcfg, device="cpu").collectPretextData()
    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert names == sorted(os.listdir(tmp_path / "port" / "train"))
    for name in names:
        want = load_shard(str(tmp_path / "jax" / "train" / name))
        got = load_shard(str(tmp_path / "port" / "train" / name))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_obs_equal(g, w)


# -- the device sim's functions -----------------------------------------------


@pytest.fixture(scope="module")
def banks():
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        jcfg, tcfg = _configs()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return jcfg, tcfg, jdev.build_plan_bank(jcfg), tdev.build_plan_bank(tcfg)


def test_plan_bank_matches_jax(banks):
    _, _, jbank, tbank = banks
    for name in jdev.PlanBank._fields:
        np.testing.assert_array_equal(_np(getattr(tbank, name)),
                                      np.asarray(getattr(jbank, name)),
                                      err_msg=name)


def _states(tcfg, n, seed):
    """n seeded states of the host sim (its own world build, teleport,
    heading and object states), and the host sim."""
    host = tgrid.GridHouseSim(tcfg)
    host.seed(seed)
    plans = list(tcfg.allScene["livingRoom"])
    states = []
    for _ in range(n):
        k = int(host.np_random.randint(len(plans)))
        host.floor_plan = plans[k]
        host._build_world()
        host._domain_randomization()
        states.append((k, *host.pos, int(host.rot) // 45,
                       *(host.objects[o]["isToggled"] for o in tdev.OBJ_NAMES)))
    return np.asarray(states, np.int64), host


def _sync(host, tcfg, st):
    host.floor_plan = list(tcfg.allScene["livingRoom"])[st[0]]
    host._build_world()
    host.pos = np.array(st[1:3])
    host.rot = 45.0 * st[3]
    for i, o in enumerate(tdev.OBJ_NAMES):
        host.objects[o]["isToggled"] = bool(st[4 + i])


def _split(states):
    st = torch.from_numpy(states)
    return st[:, 0], st[:, 1:3], st[:, 3], st[:, 4:6].bool()


def _jsplit(states):
    return (jnp.asarray(states[:, 0], jnp.int32),
            jnp.asarray(states[:, 1:3], jnp.int32),
            jnp.asarray(states[:, 3], jnp.int32),
            jnp.asarray(states[:, 4:6].astype(bool)))


def test_render_visibility_and_occupancy_match_host_and_jax(banks):
    """300 seeded states: the port's render, occupancy crop and visibility
    equal the host sim's at every one (the render against its plain
    `_render_numpy`, which the device sim copies); JAX's where JAX equals
    the host."""
    jcfg, tcfg, jbank, tbank = banks
    states, host = _states(tcfg, 300, 7)
    plan, pos, rot, tog = _split(states)
    img = _np(tdev.render_chw(tbank, plan, pos, rot, tog))
    occ = _np(tdev.local_occupancy(tbank, plan, pos, rot, 9))[:, 0]
    vis = _np(tdev.visible_mask(tbank, plan, pos, rot,
                                tcfg.RLVisibilityDistance))
    jimg = np.asarray(jdev.render_chw(jbank, *_jsplit(states), jcfg))
    jocc = np.asarray(jdev.local_occupancy(jbank, *_jsplit(states)[:3],
                                           jcfg))[:, 0]
    jvis = np.asarray(jdev.visible_mask(jbank, *_jsplit(states)[:3], jcfg))
    jax_exact = 0
    for i, st in enumerate(states):
        _sync(host, tcfg, st)
        want = np.transpose(host._render_numpy(), (2, 0, 1))
        np.testing.assert_array_equal(img[i], want, err_msg=f"state {i}")
        np.testing.assert_array_equal(occ[i], host.get_local_occupancy_map())
        host_vis = [o in host.visible_objects() for o in tdev.OBJ_NAMES]
        np.testing.assert_array_equal(vis[i], host_vis)
        np.testing.assert_array_equal(occ[i], jocc[i])
        np.testing.assert_array_equal(vis[i], jvis[i])
        # JAX's float32 rays: within its own bound of the host's image
        assert (jimg[i] != want).any(0).mean() <= 0.002
        jax_exact += bool((jimg[i] == want).all())
    assert jax_exact >= len(states) // 2  # the JAX comparison means much
    assert vis.any(1).sum() >= 20  # objects in view at many states


def test_exe_action_matches_host_and_jax(banks):
    """Every action at 60 seeded states (moves into walls and objects,
    rotations, toggles with and without an object in view): the port's
    position, heading and toggles equal the host's _exe_action, and JAX's
    where JAX equals the host."""
    jcfg, tcfg, jbank, tbank = banks
    states, host = _states(tcfg, 60, 19)
    states = np.repeat(states, A, 0)
    actions = np.tile(np.arange(A), len(states) // A)
    plan, pos, rot, tog = _split(states)
    npos, nrot, ntog = map(_np, tdev.exe_action(
        tbank, plan, pos, rot, tog, torch.from_numpy(actions),
        tcfg.RLVisibilityDistance))
    jpos, jrot, jtog = map(np.asarray, jdev.exe_action(
        jbank, *_jsplit(states), jnp.asarray(actions, jnp.int32), jcfg))
    jax_off, toggled = 0, 0
    for i, st in enumerate(states):
        _sync(host, tcfg, st)
        host._exe_action(tcfg.allActions[actions[i]])
        want = (host.pos, host.rot // 45,
                [host.objects[o]["isToggled"] for o in tdev.OBJ_NAMES])
        got = (npos[i], nrot[i], ntog[i])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        toggled += bool((ntog[i] != st[4:6].astype(bool)).any())
        if (jpos[i] == want[0]).all() and jrot[i] == want[1] \
                and list(jtog[i]) == want[2]:
            continue
        jax_off += 1
    assert jax_off <= max(1, len(states) // 50)
    assert toggled >= 5 and (npos != states[:, 1:3]).any(1).sum() >= 60


def _jax_reset_draws(key, n, bank):
    """The draws var_tpu's reset_with_task makes from `key`
    (var_tpu/envs/grid_sim_device.py:318-324), as the port's ResetDraws."""
    k2, k3, k4, k5 = jax.random.split(key, 4)
    return tdev.ResetDraws(*map(_t, (
        jax.random.randint(k2, (n,), 0, bank.grids.shape[0]),
        jax.random.uniform(k3, (n,)),
        jax.random.randint(k4, (n,), 0, 8),
        jax.random.bernoulli(k5, 0.5, (n, 2)))))


def test_reset_from_jax_draws_matches_random_reset(banks):
    jcfg, _, jbank, tbank = banks
    task_obj, task_on = [0, 0, 1, 1], [True, False, True, False]
    key = jax.random.PRNGKey(4)
    want = jdev.random_reset(jbank, key, 256, 4, jnp.asarray(task_obj),
                             jnp.asarray(task_on), jcfg)
    k1, krest = jax.random.split(key)
    task = _t(jax.random.randint(k1, (256,), 0, 4)).long()
    got = tdev.reset_from_draws(tbank, _jax_reset_draws(krest, 256, tbank),
                                task, torch.tensor(task_obj),
                                torch.tensor(task_on))
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(task), np.asarray(want[4]))
    assert _np(tdev.free_at(tbank, got[0], got[1])).all()
    # the port's own draws: every plan and heading, forced toggles
    own = tdev.reset_from_draws(
        tbank, tdev.draw_reset(torch.Generator().manual_seed(0), tbank, 256),
        task, torch.tensor(task_obj), torch.tensor(task_on))
    assert _np(tdev.free_at(tbank, own[0], own[1])).all()
    assert len(set(_np(own[0]))) == 20 and len(set(_np(own[2]))) == 8
    obj = np.asarray(task_obj)[_np(task)]
    assert (_np(own[3])[np.arange(256), obj]
            == ~np.asarray(task_on)[_np(task)]).all()


# -- the card checks, rehearsed ---------------------------------------------


def test_card_checks_rehearse_on_the_cpu():
    """chip_smoke.py phase 18's comparisons with the CPU in the card's
    place: every one runs and finds no difference."""
    _, tcfg = _configs(RLTrain=True, RLNumEnvs=2, RLEnvMaxSteps=3,
                       ppoNumSteps=6)
    report = card_against_cpu(tcfg, card="cpu")
    assert report["ok"] and report["param_max_diff"] == 0.0
    tcfg.override(RLEnvMaxSteps=6)
    report = device_sim_card_against_cpu(tcfg, card="cpu")
    assert report["ok"] and report["pixels"] == report["occupancy"] == 0
    render = render_card_against_host(tcfg, n=40, card="cpu")
    assert render == {"states": 40, "states_differing": 0,
                      "occupancy_differing": 0, "visibility_differing": 0,
                      "ok": True}
