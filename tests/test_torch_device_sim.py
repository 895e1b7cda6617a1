"""The port's device-resident arm sim (envs/arm_sim_device.py), its engine
(rl/device_sim.py) and the trainer's device-sim paths, against the JAX
package on the CPU. Reduced widths as tests/test_device_eval.py: T = 6
steps, N = 4 envs, GRU 32, GRU input 16; 96x96 images, 4 synthetic clips
per class. Weights go across through var_tpu_torch/convert.py.

Tolerances:
- images, pixel by pixel, with `==`: rendering is integer work on float32
  pixel coordinates computed in the JAX order from the same Python-float
  constants, so it is exact (a flip at a pixel edge would change a whole
  image encoding, and no tolerance could absorb it);
- ray tests, the reset from the same draws, success bits and goal counts:
  exact;
- gripper poses along a rollout at atol 1e-6: the policy's actions differ
  in the last bits (float32, another order of summation) and move the
  gripper by 0.02 * action;
- everything else (features, values, log-probs, rewards, returns, the
  return-RMS state, raw reward sums, losses) at rtol = atol = 1e-4, the
  port's float32 contract;
- parameters after a PPO update within 2 * lr per optimizer step + 5e-5
  with a median below 1e-6 (the Adam-step tolerance of
  tests/test_torch_ppo.py, which states its reason).

Boundary cases. The JAX and torch random streams differ, so the port is fed
JAX's draws, re-made from the same key splits (var_tpu/rl/device_sim.py:167,
:220, :292). Each rollout then runs free in both packages, and a gripper
pose within a last-bit difference of a pixel edge (or of an object's hit
box, for the success bit) could flip a pixel in one package only. So the
rollout comparisons first assert that every pixel coordinate of the
trajectory lies at least EDGE_MARGIN pixels from an edge, and every
gripper at least 1e-6 m from a hit-box face: with the seeds here they do,
and a seed that did not would fail that assertion by name rather than as a
pixel difference. Render parity at edges is tested separately, at states
placed on the edges (against JAX; the host sim rounds in float64 there).
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.envs import arm_sim_device as jsim
from var_tpu.envs.spaces import Box as JBox
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import DeviceSimEngine as JEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import arm_policy_state_dict, arm_state_dict
from var_tpu_torch.envs import arm_sim_device as tsim
from var_tpu_torch.envs.arm_sim import FourInARowSim
from var_tpu_torch.envs.spaces import Box
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.rl import main as rl_main
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import (CollectDraws, DeviceSimEngine,
                                         EvalDraws, GridDeviceSimEngine,
                                         init_rms)
from var_tpu_torch.tools import e2e_run
from var_tpu_torch.tools.rl_check import device_sim_card_against_cpu
from var_tpu_torch.train import rl as trl
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

TOL = dict(rtol=1e-4, atol=1e-4)
T, N = 6, 4
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
             RLRecurrentSize=32, RLRecurrentInputSize=16,
             vecEnvBackend="dummy")
EDGE_MARGIN = 1e-3  # pixels
# _train_device_sim's progress.csv (var_tpu/train/rl.py:225-241)
PROGRESS_COLUMNS = [
    "misc/nupdates", "misc/total_timesteps", "fps", "eprewmean", "min", "max",
    "loss/policy_entropy", "loss/policy_loss", "loss/value_loss", "lr",
    "perf/collect_ms", "perf/ppo_update_ms", "perf/host_rss_gb"]
EVAL_COLUMNS = ["objIdx", "goal area count", "rewards", "results"]
ONE_CLIP_PER_CLASS = {
    "dataset": ["GoogleCommand"], "max_sound_dur": {"GoogleCommand": 6.0},
    "items": {"GoogleCommand": ["zero", "one", "two", "three"]},
    "size": {"GoogleCommand": [1, 1, 1, 1]}, "train_test": "train"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores,
    and the small eager ops here then slow down more than tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _synthetic_clips(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")


def _configs(**extra):
    """(JAX config, port config) with the same knobs, envs registered."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="arms")
        cfg.override(**{**SMALL, **extra})
        mod.gym_register(cfg, env="arms")
        out.append(cfg)
    return out


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


@pytest.fixture(scope="module")
def engines():
    """One JAX engine and its port twin from the same weights."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs()
        var_model = build_pretext_model(jcfg)
        var_params = jax.jit(lambda key: init_pretext_params(
            var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
        jpol = jpolicy.build_policy(jcfg, JBox(-np.ones(2), np.ones(2)))
        obs = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
               "image_feat": jnp.zeros((N, 3)),
               "robot_pose": jnp.zeros((N, 2)),
               "goal_sound_feat": jnp.zeros((N, 3))}
        policy_params = jax.jit(jpol.init, static_argnums=4)(
            jax.random.PRNGKey(1), obs, jnp.zeros((N, 32)), jnp.ones((N, 1)),
            1)["params"]
        jeng = JEngine(var_model, var_params, jpol, jcfg, T, N)

        tvar = VARPretextNet(3)
        tvar.load_state_dict(arm_state_dict(
            jax.tree_util.tree_map(np.asarray, var_params)))
        tvar.eval().requires_grad_(False)
        tpol = build_policy(tcfg, Box(-np.ones(2), np.ones(2)))
        tpol.load_state_dict(arm_policy_state_dict(
            jax.tree_util.tree_map(np.asarray, policy_params)))
        teng = DeviceSimEngine(tvar, tpol, tcfg, T, N)
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return jcfg, tcfg, jeng, policy_params, teng


# -- the sim ---------------------------------------------------------------


def _host_states(cfg, n, seed):
    """n states of the port's host sim (its own reset, the gripper uniform
    over the workspace), as tests/test_arm_sim_device.py:31 makes them."""
    host = FourInARowSim(cfg)
    host.seed(3)
    rng = np.random.RandomState(seed)
    poses, orders, ees = [], [], []
    for _ in range(n):
        host._randomize()
        host.ee = np.array([rng.uniform(cfg.xMin, cfg.xMax),
                            rng.uniform(cfg.yMin, cfg.yMax)])
        poses.append(host.objPose.copy())
        orders.append([host.objOrder[i] for i in range(4)])
        ees.append(host.ee.copy())
    return (np.asarray(poses, np.float32), np.asarray(orders, np.int32),
            np.asarray(ees, np.float32), host)


@pytest.mark.parametrize("n,seed", [(12, 7), (600, 21)])
def test_render_matches_jax_and_host(n, seed):
    """The JAX suite's states (n=12, seed 7) and many more: every pixel
    equal to JAX's render and to the host sim's get_image."""
    _, tcfg = _configs()
    poses, _, ees, host = _host_states(tcfg, n, seed)
    k = tsim.consts_from_config(tcfg)
    got = tsim.render(torch.from_numpy(poses), torch.from_numpy(ees), k)
    want = jsim.render(jnp.asarray(poses), jnp.asarray(ees),
                       jsim.consts_from_config(tcfg))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    chw = tsim.render_chw(torch.from_numpy(poses), torch.from_numpy(ees), k)
    assert chw.is_contiguous()
    np.testing.assert_array_equal(_np(chw), np.transpose(_np(got),
                                                         (0, 3, 1, 2)))
    for i in range(n):
        host.objPose = poses[i].astype(np.float64)
        host.ee = ees[i].astype(np.float64)
        np.testing.assert_array_equal(_np(got[i]), host.get_image())


def test_render_at_pixel_edges_matches_jax():
    """Grippers on every row's and column's edge in float32 and one and two
    ulps beside it: the pixel coordinate rounds as XLA's does."""
    _, tcfg = _configs()
    k = tsim.consts_from_config(tcfg)
    x0, x1, y0, y1, _, _ = tsim._render_consts(k)
    edges = []
    for lo, hi, fixed, axis in ((x0, x1, 0.05, 0), (y0, y1, 0.6, 1)):
        for r in range(96):
            v = np.float32(lo + r / 95 * (hi - lo))
            for _ in range(3):
                for side in (-np.inf, np.inf):
                    w = np.nextafter(v, np.float32(side))
                    edges.append((w, fixed) if axis == 0 else (fixed, w))
                v = np.nextafter(v, np.float32(np.inf))
    ees = np.asarray(edges, np.float32)
    poses = np.repeat(_host_states(tcfg, 1, 0)[0], len(ees), 0)
    got = tsim.render(torch.from_numpy(poses), torch.from_numpy(ees), k)
    want = jsim.render(jnp.asarray(poses), jnp.asarray(ees),
                       jsim.consts_from_config(tcfg))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_ray_test_and_apply_action_match_jax():
    _, tcfg = _configs()
    poses, _, ees, _ = _host_states(tcfg, 32, 11)
    # grippers on objects, so that hits occur (test_arm_sim_device.py:62)
    ees = np.concatenate([ees, poses[:, 0, :] + np.float32([0.01, -0.012]),
                          poses[:, 2, :]])
    poses = np.concatenate([poses, poses, poses])
    got = tsim.ray_test(torch.from_numpy(poses), torch.from_numpy(ees))
    want = np.asarray(jsim.ray_test(jnp.asarray(poses), jnp.asarray(ees)))
    np.testing.assert_array_equal(_np(got), want)
    assert (want >= 0).sum() >= 64 and (want < 0).any()

    k = tsim.consts_from_config(tcfg)
    act = np.random.RandomState(5).uniform(-1.6, 1.6, (len(ees), 2)
                                           ).astype(np.float32)
    got = tsim.apply_action(torch.from_numpy(ees), torch.from_numpy(act), k)
    want = jsim.apply_action(jnp.asarray(ees), jnp.asarray(act),
                             jsim.consts_from_config(tcfg))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _jax_reset_draws(key, n, k):
    """The draws var_tpu's randomize makes from `key`
    (var_tpu/envs/arm_sim_device.py:94-115), as the port's ResetDraws."""
    k_rx, k_ry, k_perm, k_jx, k_jy, k_ee = jax.random.split(key, 6)
    u = jax.random.uniform

    def jitter(kk, lo, hi):
        return u(kk, (n, k.n_obj), minval=lo, maxval=hi) if hi > lo \
            else jnp.zeros((n, k.n_obj))

    perm = jax.vmap(lambda kk: jax.random.permutation(kk, k.n_obj))(
        jax.random.split(k_perm, n))
    ee = jnp.stack([
        u(k_ee, (n,), minval=k.ee_x_lo, maxval=k.ee_x_hi),
        u(jax.random.fold_in(k_ee, 1), (n,), minval=k.ee_y_lo,
          maxval=k.ee_y_hi)], axis=-1)
    return tsim.ResetDraws(*map(_t, (
        u(k_rx, (n, 1), minval=k.rand_x_lo, maxval=k.rand_x_hi),
        u(k_ry, (n, 1), minval=k.rand_y_lo, maxval=k.rand_y_hi), perm,
        jitter(k_jx, k.objs_x_lo, k.objs_x_hi),
        jitter(k_jy, k.objs_y_lo, k.objs_y_hi), ee)))


@pytest.mark.parametrize("jitter", [False, True])
def test_reset_from_jax_draws_matches_randomize(jitter):
    """The pure part of randomize, fed JAX's draws, equals JAX's randomize;
    with per-object jitter too (the default config has none)."""
    _, tcfg = _configs(**({"objsXRand": [-0.01, 0.01],
                           "objsYRand": [-0.02, 0.0]} if jitter else {}))
    k = tsim.consts_from_config(tcfg)
    key = jax.random.PRNGKey(9)
    got = tsim.reset_from_draws(_jax_reset_draws(key, 64, k), k)
    want = jsim.randomize(key, 64, jsim.consts_from_config(tcfg))
    for g, w in zip(got, want):
        assert g.dtype == _t(w).dtype
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_port_draws_stay_in_range():
    """The port's own draws (test_arm_sim_device.py:85 twin)."""
    _, c = _configs()
    k = tsim.consts_from_config(c)
    pose, order, ee = map(_np, tsim.randomize(
        torch.Generator().manual_seed(0), 256, k))
    assert pose[..., 0].min() >= c.xMin + c.objXRand[0] - 1e-6
    assert pose[..., 0].max() <= c.xMax + c.objXRand[1] + 1e-6
    assert (np.sort(order, axis=1) == np.arange(4)).all()
    rel = pose[..., 1] - order.astype(np.float32) * c.objInterval
    np.testing.assert_allclose(rel, rel[:, :1].repeat(4, 1), atol=1e-5)
    assert rel.min() >= c.yMin + c.objYRand[0] - 1e-6
    assert rel.max() <= c.yMax + c.objYRand[1] + 1e-6
    assert ee[:, 0].min() >= c.xMin + c.eeXInitRand[0] - 1e-6
    assert ee[:, 0].max() <= c.xMax + c.eeXInitRand[1] + 1e-6
    assert ee[:, 1].min() >= c.yMin + c.eeYInitRand[0] - 1e-6
    assert ee[:, 1].max() <= c.yMax + c.eeYInitRand[1] + 1e-6
    assert len({tuple(o) for o in order}) > 4  # shuffled across envs


# -- the engine --------------------------------------------------------------


def test_goal_bank_matches_jax(engines):
    _, _, jeng, _, teng = engines
    assert teng.goal_bank.shape == jeng.goal_bank.shape == (4, 4, 3)
    np.testing.assert_allclose(_np(teng.goal_bank),
                               np.asarray(jeng.goal_bank), **TOL)


def _pixel_margin(obj_pose, ees, k):
    """Smallest distance, in pixels, of any float32 pixel coordinate of the
    objects and grippers from a pixel edge."""
    x0, x1, y0, y1, _, _ = tsim._render_consts(k)
    pts = np.concatenate([np.asarray(obj_pose).reshape(-1, 2),
                          np.asarray(ees).reshape(-1, 2)]).astype(np.float32)
    px = np.stack([(pts[:, 0] - np.float32(x0)) / np.float32(x1 - x0),
                   (pts[:, 1] - np.float32(y0)) / np.float32(y1 - y0)]) * 95
    return float(np.abs(px - np.round(px)).min())


def _jax_collect_draws(key, k):
    kr, ki, kc, ka, ks = jax.random.split(key, 5)
    noise = [jax.random.normal(ka, (N, 2))] + [
        jax.random.normal(s, (N, 2)) for s in jax.random.split(ks, T)]
    return CollectDraws(
        _jax_reset_draws(kr, N, k),
        _t(jax.random.randint(ki, (N,), 0, 4)).long(),
        _t(jax.random.randint(kc, (N,), 0, 4)).long(),
        _t(jnp.stack(noise)))


@pytest.fixture(scope="module")
def collected(engines):
    """One rollout in each package from the same key and weights."""
    jcfg, tcfg, jeng, policy_params, teng = engines
    key = jax.random.PRNGKey(2)
    jrms, jbatch, jstats = jeng.collect(jinit_rms(N), policy_params, key)
    draws = _jax_collect_draws(key, teng.k)
    trms, tbatch, tstats = teng.collect(init_rms(N), draws)
    return jrms, jbatch, jstats, trms, tbatch, tstats, draws


def test_collect_matches_jax(engines, collected):
    _, tcfg, _, _, teng = engines
    jrms, jbatch, jstats, trms, tbatch, tstats, draws = collected
    obj_pose = tsim.reset_from_draws(draws.reset, teng.k)[0]
    ees = _np(tbatch["obs"]["robot_pose"])
    final = tsim.apply_action(tbatch["obs"]["robot_pose"][-1],
                              tbatch["actions"][-1], teng.k)
    assert _pixel_margin(obj_pose, np.concatenate([ees.reshape(-1, 2),
                                                   _np(final)]),
                         teng.k) > EDGE_MARGIN, "a state lies on a pixel edge"

    np.testing.assert_array_equal(_np(tbatch["obs"]["image"]),
                                  np.asarray(jbatch["obs"]["image"]))
    np.testing.assert_allclose(ees, np.asarray(jbatch["obs"]["robot_pose"]),
                               rtol=0, atol=1e-6)
    for name in ("image_feat", "goal_sound_feat"):
        np.testing.assert_allclose(_np(tbatch["obs"][name]),
                                   np.asarray(jbatch["obs"][name]), **TOL)
    for name in ("actions", "value_preds", "returns", "masks",
                 "old_log_probs", "rnn_hx0"):
        np.testing.assert_allclose(_np(tbatch[name]),
                                   np.asarray(jbatch[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(_np(tstats), np.asarray(jstats), **TOL)
    for got, want in zip(trms, jrms):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # JAX's batch holds no normalised rewards: they are re-made from its
    # GAE returns (r_t = A_t - g*l*A_t+1 - g*v_t+1 + v_t inside the
    # episode, r_T-1 = returns_T-1 at its end)
    ret, val = (np.asarray(jbatch[k], np.float64)
                for k in ("returns", "value_preds"))
    adv, g, lam = ret - val, tcfg.RLGamma, tcfg.ppoGAELambda
    want = ret.copy()
    want[:-1] = adv[:-1] - g * lam * adv[1:] - g * val[1:] + val[:-1]
    np.testing.assert_allclose(_np(teng.rewards), want, **TOL)
    assert not np.allclose(_np(tbatch["actions"][0]), 0.0)


def test_ppo_update_of_collected_batches_matches_jax(engines, collected):
    """One PPO.update on each package's batch, with the same env
    permutations (re-made from the JAX update's key, ppo.py:205-208)."""
    jcfg, tcfg, jeng, policy_params, teng = engines
    _, jbatch, _, _, tbatch, _, _ = collected
    jp = jppo.PPO(jeng.policy, jppo.PPOConfig.from_config(jcfg))
    key = jax.random.PRNGKey(11)
    perms, k = [], key
    for _ in range(jcfg.ppoEpoch):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))
    # the update donates its state: hand it a copy of the shared params
    jstate, jmetrics = jp.update(jp.init_state(jax.tree_util.tree_map(
        jnp.array, policy_params)), jbatch, key)

    saved = {k: v.clone() for k, v in teng.policy.state_dict().items()}
    port = tppo.PPO(teng.policy, tppo.PPOConfig.from_config(tcfg))
    try:
        state, metrics = port.update(port.init_state(), tbatch,
                                     torch.from_numpy(np.stack(perms)).long())
        for name, v in metrics.items():
            np.testing.assert_allclose(_np(v), np.asarray(jmetrics[name]),
                                       **TOL)
        want = arm_policy_state_dict(jax.tree_util.tree_map(
            np.asarray, jstate.params))
        atol = 2 * tcfg.RLLr * tcfg.ppoEpoch * tcfg.ppoNumMiniBatch + 5e-5
        diffs = torch.cat([(state.params[k].detach() - v).abs().ravel()
                           for k, v in want.items()])
        assert diffs.max().item() <= atol
        assert diffs.median().item() < 1e-6
    finally:
        teng.policy.load_state_dict(saved)


def _jax_eval_draws(key, k):
    kr, kc, _ = jax.random.split(key, 3)
    return EvalDraws(_jax_reset_draws(kr, N, k),
                     _t(jax.random.randint(kc, (N,), 0, 4)).long())


def _eval_trajectory(teng, draws, actions):
    """The gripper poses an eval batch visits, from its applied actions."""
    obj_pose, obj_order, ee = tsim.reset_from_draws(draws.reset, teng.k)
    ees = [ee]
    for t in range(T):
        ees.append(tsim.apply_action(ees[-1], actions[t], teng.k))
    return obj_pose, obj_order, torch.stack(ees)


@pytest.mark.parametrize("intent", [[0, 1, 2, 3], [3, 3, 1, 0]])
def test_eval_batch_matches_jax(engines, intent):
    jcfg, tcfg, jeng, policy_params, teng = engines
    key = jax.random.PRNGKey(13)
    jsucc, jcounts, jraw = jeng.eval_batch(
        policy_params, jnp.asarray(intent, jnp.int32), key)
    draws = _jax_eval_draws(key, teng.k)
    succ, counts, raw = teng.eval_batch(torch.tensor(intent), draws)
    obj_pose, _, ees = _eval_trajectory(teng, draws, teng.eval_actions)
    assert _pixel_margin(obj_pose, ees, teng.k) > EDGE_MARGIN
    face = (obj_pose - ees[-1][:, None]).abs() - torch.tensor(
        [tsim.OBJ_HALF_X, tsim.OBJ_HALF_Y])
    assert face.abs().min().item() > 1e-6, "a gripper on a hit-box face"
    np.testing.assert_array_equal(_np(succ), np.asarray(jsucc))
    np.testing.assert_array_equal(_np(counts), np.asarray(jcounts))
    np.testing.assert_allclose(_np(raw), np.asarray(jraw), **TOL)


def test_eval_trajectory_matches_host_replay(engines):
    """test_device_eval.py:43 on the port: the eval batch's success bits,
    counts and raw reward sums equal a replay that renders with the host
    FourInARowSim.get_image, steps with _apply_action_rl and ray-tests
    with FourInARowSim.ray_test, from the same initial state, goal
    embeddings and policy."""
    _, tcfg, _, _, teng = engines
    intent = torch.tensor([0, 1, 2, 3])
    gen = torch.Generator().manual_seed(5)
    draws = EvalDraws(tsim.draw_reset(gen, N, teng.k),
                      torch.randint(0, 4, (N,), generator=gen))
    succ, counts, raw = teng.eval_batch(intent, draws)
    obj_pose, obj_order, ee0 = tsim.reset_from_draws(draws.reset, teng.k)
    obj_pose, obj_order = _np(obj_pose), _np(obj_order)
    goal_feat = teng.goal_bank[intent, draws.clip]

    host = FourInARowSim(tcfg)

    def render_host(ee):
        frames = []
        for e in range(N):
            host.objPose = obj_pose[e].astype(np.float64)
            host.ee = ee[e].astype(np.float64)
            frames.append(np.transpose(host.get_image(), (2, 0, 1)))
        return torch.from_numpy(np.stack(frames))

    ee = _np(ee0).copy()
    img = render_host(ee)
    hx = torch.zeros((N, teng.hidden))
    raw_sum = torch.zeros(N)
    with torch.no_grad():
        for _ in range(T):
            ifeat = teng._encode_image(img)
            _, action, _, hx = teng._act(torch.from_numpy(ee), img, ifeat,
                                         goal_feat, hx, None, True)
            for e in range(N):
                host.ee = ee[e].astype(np.float64).copy()
                host._apply_action_rl(_np(action[e]))
                ee[e] = np.asarray(host.ee, np.float32)
            img = render_host(ee)
            raw_sum += torch.sum(teng._encode_image(img)[:, :3] * goal_feat,
                                 dim=1)
    want = []
    for e in range(N):
        host.objPose = obj_pose[e].astype(np.float64)
        host.objOrder = {i: int(obj_order[e, i]) for i in range(4)}
        host.ee = ee[e].astype(np.float64)
        hit = host.ray_test()
        want.append(bool(hit >= 0 and host.objOrder[hit] == int(intent[e])))
    np.testing.assert_array_equal(_np(succ), want)
    np.testing.assert_array_equal(_np(counts), np.asarray(want, np.int32))
    np.testing.assert_allclose(_np(raw), _np(raw_sum), **TOL)


# -- refusals --------------------------------------------------------------


def test_refusals_name_their_reason(engines):
    """The env-axis mesh is ported (tests/test_torch_parallel.py holds it):
    an env count that does not divide by the mesh's dp is refused, as
    XLA's uneven shard is, naming dp."""
    from var_tpu_torch.parallel.mesh import Mesh

    _, tcfg, _, _, teng = engines
    uneven = Mesh({"dp": 3}, 0, 3, None, 0, torch.device("cpu"), None)
    for engine in (DeviceSimEngine, GridDeviceSimEngine):
        with pytest.raises(ValueError, match="RLNumEnvs 4 .*dp=3"):
            engine(teng.var_model, teng.policy, tcfg, T, N, mesh=uneven)
    _, sound = _configs(RLRewardSoundSound=True)
    with pytest.raises(NotImplementedError, match="RLRewardSoundSound"):
        DeviceSimEngine(teng.var_model, teng.policy, sound, T, N)


def test_device_eval_refuses_adapter_backend():
    """test_device_eval.py:308 twin."""
    _, tcfg = _configs(RLTrain=False, RLDeviceSimEval=True)
    trainer = trl.RLTrainer(tcfg, device="cpu")
    # set after the trainer registers the envs, so that the refusal
    # comes from testRL and not from an adapter asking for pybullet
    tcfg.override(simBackend="pybullet")
    with pytest.raises(ValueError, match="simBackend"):
        trainer.testRL(policy_path="/nonexistent")


def test_device_sim_needs_one_rollout_per_episode():
    _, tcfg = _configs(RLTrain=True, RLDeviceSimRollout=True, ppoNumSteps=3)
    trainer = trl.RLTrainer(tcfg, device="cpu")
    trainer.pretext_model = VARPretextNet(3)
    with pytest.raises(ValueError, match="ppoNumSteps == RLEnvMaxSteps"):
        trainer.trainRL()


# -- the trainer -----------------------------------------------------------


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_device_sim_eval_csv(engines, tmp_path):
    """test_device_eval.py:255 twin: the rate, the CSV at
    test_<ckpt>_devicesim.csv with the round-robin objIdx blocks scaled by
    num_envs, and a missing checkpoint raising."""
    _, tcfg = _configs(RLTrain=False, RLEnvMaxSteps=4, ppoNumSteps=4,
                       RLDeviceSimEval=True, soundSource=ONE_CLIP_PER_CLASS)
    trainer = trl.RLTrainer(tcfg, device="cpu")
    trainer.pretext_model = engines[4].var_model
    with pytest.raises(FileNotFoundError):
        trainer.testRL(policy_path=str(tmp_path / "nope"))
    ckpt = str(tmp_path / "policy_ckpt")
    save_checkpoint(ckpt, {"params": engines[4].policy.state_dict()})
    rate = trainer.testRL(policy_path=ckpt, num_envs=2)
    assert 0.0 <= rate <= 1.0
    head, rows = _read_csv(str(tmp_path / "test_policy_ckpt_devicesim.csv"))
    assert head == EVAL_COLUMNS and len(rows) == 8  # 4 slots x 2 envs
    assert [int(r[0]) for r in rows] == list(np.repeat(np.arange(4), 2))
    assert rate == np.mean([int(r[3]) for r in rows])
    assert not os.path.exists(str(tmp_path / "test_policy_ckpt.csv"))
    # num_episodes tiles the round robin and truncates
    trainer.testRL(policy_path=ckpt, num_envs=2, num_episodes=11)
    _, rows = _read_csv(str(tmp_path / "test_policy_ckpt_devicesim.csv"))
    assert [int(r[0]) for r in rows] == [0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1]


def _skill_args(root, *extra):
    return [
        "--env", "arms", "--device", "cpu", "--set",
        f'pretextModelLoadDir="{root}/var_model/2"',
        f'RLModelSaveDir="{root}/rl_model"', 'vecEnvBackend="dummy"',
        "RLEnvMaxSteps=6", "ppoNumSteps=6", "RLRecurrentSize=64",
        "RLRecurrentInputSize=32", *extra]


STAGE2 = ("RLTrain=True", "RLModelFineTune=False", "RLNumEnvs=2",
          "RLTotalSteps=48", "ppoNumMiniBatch=2", "ppoEpoch=2",
          "RLModelSaveInterval=1", "RLLogInterval=1",
          "RLDeviceSimRollout=True")


@pytest.fixture
def var_checkpoint(tmp_path):
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "var_model" / "2"),
                    {"params": model.state_dict(), "step": 0})
    return tmp_path


def test_skill_stages_2_and_3_on_the_device_sim(var_checkpoint):
    """SKILL.md stage 2 with RLDeviceSimRollout=True, then stage 3 with
    RLDeviceSimEval=True, through `python -m var_tpu_torch.rl --device
    cpu`'s main."""
    root = var_checkpoint
    trainer = rl_main(_skill_args(root, *STAGE2))
    assert trainer.device.type == "cpu" and len(trainer.update_stats) == 4
    saved = sorted(os.listdir(root / "rl_model"))
    assert saved == ["00000", "00001", "00002", "00003", "config.json",
                     "progress.csv"]
    head, rows = _read_csv(str(root / "rl_model" / "progress.csv"))
    assert head == PROGRESS_COLUMNS and len(rows) == 4
    assert all(np.isfinite(float(r[head.index(c)])) for r in rows
               for c in ("loss/value_loss", "loss/policy_loss",
                         "loss/policy_entropy"))
    start = build_policy(trainer.config, Box(-np.ones(2), np.ones(2)))
    start.reset_parameters(torch.Generator().manual_seed(40))
    final = load_checkpoint(str(root / "rl_model" / "00003"))["params"]
    assert max((final[k] - v).abs().max().item()
               for k, v in start.state_dict().items()) > 0

    rl_main(_skill_args(
        root, "RLTrain=False", "RLModelFineTune=False",
        "RLDeviceSimEval=True",
        f'skillInfos=[{{"path": "{root}/rl_model/00003", "actionDim": 2}}]',
        f"soundSource={ONE_CLIP_PER_CLASS!r}"))
    head, rows = _read_csv(str(root / "rl_model" /
                                "test_00003_devicesim.csv"))
    assert head == EVAL_COLUMNS
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3]


def test_device_sim_resume_continues_labels(var_checkpoint):
    root = var_checkpoint
    first = rl_main(_skill_args(root, *STAGE2, "RLTotalSteps=24"))
    ckpt = load_checkpoint(str(root / "rl_model" / "00001"))
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2 * 2 * 2
    for k, mu in first.state.opt_state.mu.items():
        torch.testing.assert_close(ckpt["opt_state"]["mu"][k], mu,
                                   rtol=0, atol=0)
    args = _skill_args(root, *STAGE2, "RLTotalSteps=12",
                       f'RLModelLoadDir="{root}/rl_model/00001"')
    args[args.index("RLModelFineTune=False")] = "RLModelFineTune=True"
    resumed = rl_main(args)
    assert len(resumed.update_stats) == 1
    assert sorted(p for p in os.listdir(root / "rl_model")
                  if p.isdigit()) == ["00000", "00001", "00002"]
    ckpt2 = load_checkpoint(str(root / "rl_model" / "00002"))
    assert ckpt2["step"] == 3 and ckpt2["opt_state"]["count"] == 12


def test_e2e_runner_rehearses_the_arm_stages(tmp_path):
    """tools/e2e_run.py's collect, var, rl (device sim) and eval stages and
    the device evaluator, on the CPU at tiny sizes."""
    work, out = tmp_path / "work", tmp_path / "e2e.json"
    result = e2e_run.main([
        str(work), "--device", "cpu", "--device-sim", "--num-envs", "2",
        "--rl-steps", "16", "--collect-per-class", "4", "--var-epochs", "1",
        "--eval-per-class", "2", "--eval-envs", "2",
        "--device-eval-per-class", "2", "--device-eval-envs", "2",
        "--out", str(out), "--set", "RLEnvMaxSteps=4", "RLRecurrentSize=32",
        "RLRecurrentInputSize=16", "pretextEnvMaxSteps=8"])
    assert set(result["timings_s"]) == {"collect_s", "var_train_s",
                                        "rl_train_s", "eval_s"}
    assert result["device_sim"] and result["num_envs"] == 2
    assert result["eval_episodes"] == 8
    assert result["device_eval"]["eval_episodes"] == 8
    for r in (result, result["device_eval"]):
        assert 0.0 <= r["success_rate"] <= 1.0 and r["ci95"] > 0
    assert result["hardware"] == "cpu"
    assert os.path.exists(work / "rl_model" / "test_00001_devicesim.csv")
    assert os.path.exists(work / "rl_model" / "test_00001.csv")
    with open(out) as f:
        assert "arms" in json.load(f)["profiles"]
    assert e2e_run.binom_ci95(0.5, 100) == pytest.approx(0.098)
    with pytest.raises(SystemExit):  # a profile the runner does not know
        e2e_run.main([str(work), "--env", "kuka", "--device", "cpu",
                      "--out", str(out)])
    with pytest.raises(SystemExit):
        e2e_run.main([str(work), "--device", "cpu", "--out",
                      os.path.join(e2e_run.ROOT, "E2E_r05.json")])


def test_device_sim_card_check_rehearses_on_the_cpu():
    """chip_smoke.py phase 13's comparison with the CPU in the card's
    place: every comparison runs and finds no difference."""
    _, tcfg = _configs(RLTrain=True, RLNumEnvs=2)
    report = device_sim_card_against_cpu(tcfg, card="cpu")
    assert report["ok"] and report["param_max_diff"] == 0.0
    assert report["pixels"] == report["poses"] == report["success"] == 0
    assert report["losses"] == report["returns"] == 0.0
