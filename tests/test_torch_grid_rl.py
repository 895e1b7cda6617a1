"""The port's grid device-sim engine (rl/device_sim.py::
GridDeviceSimEngine) and the fused grid RL step (rl/rollout_device.py with
the occupancy observation) against the JAX package on the CPU: the goal
bank, one collect, its PPO update and eval batches from JAX's draws; 2 x T
fused steps over host grid envs and a PPO update. The sim's functions are
held in tests/test_torch_grid_sim.py.

Tolerances:
- images, occupancy crops, actions (Gumbel noise, argmax), success bits
  and counts: equal. JAX's grid render samples its rays in float32 and
  differs from the host sim at a few pixels of about a fifth of the states
  (tests/test_torch_grid_sim.py); the JAX engine here renders through a
  callback into the port's render, which equals the host sim's, so that
  the rest of its rollout is held against the port step by step;
- the CRNN's goal embeddings, and in the fused step what reads them
  (rewards, the return-RMS, returns), at rtol 1e-3 / atol 2e-4
  (BASELINE.md); the engine tests load the JAX goal bank into the port's
  engine after comparing the two, so that what follows is held at 1e-4;
- everything else at rtol = atol = 1e-4 (IEEE float32 both sides, only the
  order of summation differs);
- parameters after a PPO update within 2 * lr per optimizer step + 5e-5
  with a median below 1e-6 (tests/test_torch_ppo.py states why).
Reduced sizes: T = 6 steps, N = 4 envs, GRU 32, GRU input 16, 2 PPO
epochs, sound (1, 100, 40) (the CRNN runs at any length), 3 synthetic clips
per class, 8 goal draws per task.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data.audio_store import AudioStore as JAudioStore
from var_tpu.envs import grid_sim_device as jdev
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import GridDeviceSimEngine as JGridEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu.rl.rollout_device import DeviceRolloutEngine as JEngine
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_policy_state_dict, ai2thor_state_dict
from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs import grid_sim_device as tdev
from var_tpu_torch.envs.spaces import Discrete
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import (GridCollectDraws,
                                         GridDeviceSimEngine, GridEvalDraws,
                                         init_rms)
from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine as TEngine

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
T, N, A = 6, 4, 8
# 2 PPO epochs (4 by default): on the CPU the JAX update unrolls its
# epoch x minibatch loop, and its compile time grows with it
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T, ppoEpoch=2,
             RLRecurrentSize=32, RLRecurrentInputSize=16,
             sound_dim=(1, 100, 40), vecEnvBackend="dummy")


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
    """3 synthetic clips per class."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")


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


def _jax_reset_draws(key, n, bank):
    """The draws var_tpu's reset_with_task makes from `key`
    (var_tpu/envs/grid_sim_device.py:318-324), as the port's ResetDraws."""
    k2, k3, k4, k5 = jax.random.split(key, 4)
    return tdev.ResetDraws(*map(_t, (
        jax.random.randint(k2, (n,), 0, bank.grids.shape[0]),
        jax.random.uniform(k3, (n,)),
        jax.random.randint(k4, (n,), 0, 8),
        jax.random.bernoulli(k5, 0.5, (n, 2)))))


@pytest.fixture(scope="module")
def jax_nets():
    """One JAX ai2thor VAR and policy (and one PPO learner, whose jitted
    update compiles once) shared by the engine tests, and a builder of
    their port twins."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        jcfg, tcfg = _configs()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    var_model = build_pretext_model(jcfg)
    var_params = jax.jit(lambda key: init_pretext_params(
        var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
    jpol, policy_params = _jax_policy(jcfg, 1)
    jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
    return jcfg, tcfg, var_model, var_params, jpol, policy_params, jp


def _jax_update(jp, policy_params, jbatch, seed):
    """JAX's PPO.update from fresh state, and the env permutations it draws
    (re-made from its key, var_tpu/rl/ppo.py)."""
    key = jax.random.PRNGKey(seed)
    perms, k = [], key
    for _ in range(jp.cfg.ppo_epoch):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))
    # the update donates its state: hand it a copy of the shared params
    jstate, jmetrics = jp.update(jp.init_state(jax.tree_util.tree_map(
        jnp.array, policy_params)), jbatch, key)
    return jstate, jmetrics, torch.from_numpy(np.stack(perms)).long()


def _assert_update_matches(tcfg, tpol, tbatch, jstate, jmetrics, perms):
    """The port's PPO.update of `tbatch` against JAX's; restores tpol."""
    saved = {k: v.clone() for k, v in tpol.state_dict().items()}
    port = tppo.PPO(tpol, tppo.PPOConfig.from_config(tcfg))
    try:
        state, metrics = port.update(port.init_state(), tbatch, perms)
        for name, v in metrics.items():
            np.testing.assert_allclose(_np(v), np.asarray(jmetrics[name]),
                                       err_msg=name, **TOL)
        want = ai2thor_policy_state_dict(jax.tree_util.tree_map(
            np.asarray, jstate.params))
        atol = 2 * tcfg.RLLr * tcfg.ppoEpoch * tcfg.ppoNumMiniBatch + 5e-5
        diffs = torch.cat([(state.params[k].detach() - v).abs().ravel()
                           for k, v in want.items()])
        assert diffs.max().item() <= atol
        assert diffs.median().item() < 1e-6
    finally:
        tpol.load_state_dict(saved)


def _jax_policy(jcfg, seed):
    jpol = jpolicy.build_policy(jcfg, JDiscrete(A))
    obs = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
           "occupancy": jnp.zeros((N, 1, 9, 9), jnp.uint8),
           "image_feat": jnp.zeros((N, 3)),
           "goal_sound_feat": jnp.zeros((N, 3))}
    params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(seed), obs, jnp.zeros((N, 32)), jnp.ones((N, 1)),
        1)["params"]
    return jpol, params


def _port_nets(tcfg, var_params, policy_params):
    tvar = VARPretextNet(3, "ai2thor")
    tvar.load_state_dict(ai2thor_state_dict(
        jax.tree_util.tree_map(np.asarray, var_params)))
    tvar.eval().requires_grad_(False)
    tpol = build_policy(tcfg, Discrete(A))
    tpol.load_state_dict(ai2thor_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, policy_params)))
    return tvar, tpol


def _host_render_for_jax(tbank):
    """A stand-in for var_tpu's grid render_chw that calls back into the
    port's render (equal to the host sim's at every state above)."""

    def render_chw(bank, plan, pos, rot_idx, toggled, config):
        def host(plan, pos, rot, tog):
            args = [torch.from_numpy(np.asarray(a, np.int64))
                    for a in (plan, pos, rot)]
            return _np(tdev.render_chw(tbank, *args,
                                       torch.from_numpy(np.asarray(tog))))

        shape = jax.ShapeDtypeStruct((pos.shape[0], 3, 96, 96), jnp.uint8)
        return jax.pure_callback(host, shape, plan, pos, rot_idx, toggled)

    return render_chw


GOAL_SAMPLES = 8  # goal draws per task in the engine tests (64 by default)


@pytest.fixture(scope="module")
def engines(jax_nets):
    """The JAX grid engine (rendering as the host sim does, see the module
    docstring) and its port twin from the same weights and audio, with
    GOAL_SAMPLES goal draws per task; the port's goal bank, once compared,
    is JAX's."""
    jcfg, tcfg, var_model, var_params, jpol, policy_params, _ = jax_nets
    build_bank = JGridEngine._build_goal_bank
    patch = pytest.MonkeyPatch()
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        patch.setattr(jdev, "render_chw", _host_render_for_jax(
            tdev.build_plan_bank(tcfg)))
        patch.setattr(JGridEngine, "_build_goal_bank",
                      lambda self, audio=None: build_bank(
                          self, audio, samples_per_task=GOAL_SAMPLES))
        patch.setattr(GridDeviceSimEngine, "SAMPLES_PER_TASK", GOAL_SAMPLES)
        jaudio, taudio = JAudioStore(jcfg), AudioStore(tcfg)
        jaudio.loadData()
        taudio.loadData()
        jeng = JGridEngine(var_model, var_params, jpol, jcfg, T, N,
                           audio=jaudio)
        tvar, tpol = _port_nets(tcfg, var_params, policy_params)
        teng = GridDeviceSimEngine(tvar, tpol, tcfg, T, N, audio=taudio)
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    port_bank = teng.goal_bank
    teng.goal_bank = _t(jeng.goal_bank)
    yield jcfg, tcfg, jeng, policy_params, teng, port_bank
    patch.undo()


def test_goal_bank_matches_jax(engines):
    """getAudioFromTask draws per task from RandomState(RLEnvSeed + 101),
    host MFCC, the CRNN: the port's own bank at the CRNN's tolerance."""
    _, _, jeng, _, _, port_bank = engines
    assert port_bank.shape == jeng.goal_bank.shape == (4, GOAL_SAMPLES, 3)
    np.testing.assert_allclose(_np(port_bank), np.asarray(jeng.goal_bank),
                               **CRNN_TOL)


def _jax_collect_draws(key, bank):
    kr, kc, ka, ks = jax.random.split(key, 4)
    k1, krest = jax.random.split(kr)
    noise = [jax.random.gumbel(ka, (N, A))] + [
        jax.random.gumbel(s, (N, A)) for s in jax.random.split(ks, T)]
    return GridCollectDraws(
        _jax_reset_draws(krest, N, bank),
        _t(jax.random.randint(k1, (N,), 0, 4)).long(),
        _t(jax.random.randint(kc, (N,), 0, GOAL_SAMPLES)).long(),
        _t(jnp.stack(noise)))


@pytest.fixture(scope="module")
def collected(engines):
    _, _, jeng, policy_params, teng, _ = engines
    key = jax.random.PRNGKey(2)
    jrms, jbatch, jstats = jeng.collect(jinit_rms(N), policy_params, key)
    trms, tbatch, tstats = teng.collect(
        init_rms(N), _jax_collect_draws(key, teng.bank))
    return jrms, jbatch, jstats, trms, tbatch, tstats


def test_collect_matches_jax(engines, collected):
    _, tcfg, _, _, teng, _ = engines
    jrms, jbatch, jstats, trms, tbatch, tstats = collected
    for name in ("image", "occupancy"):
        np.testing.assert_array_equal(_np(tbatch["obs"][name]),
                                      np.asarray(jbatch["obs"][name]))
    for name in ("image_feat", "goal_sound_feat"):
        np.testing.assert_allclose(_np(tbatch["obs"][name]),
                                   np.asarray(jbatch["obs"][name]), **TOL)
    np.testing.assert_array_equal(_np(tbatch["actions"]),
                                  np.asarray(jbatch["actions"]))
    for name in ("value_preds", "returns", "masks", "old_log_probs",
                 "rnn_hx0"):
        np.testing.assert_allclose(_np(tbatch[name]),
                                   np.asarray(jbatch[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(_np(tstats), np.asarray(jstats), **TOL)
    for got, want in zip(trms, jrms):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the rollout moved and turned: not a frozen sim
    assert len(set(_np(tbatch["actions"]).ravel())) >= 4
    assert (_np(tbatch["obs"]["image"][0]) != _np(tbatch["obs"]["image"][-1])
            ).any()


def test_ppo_update_of_collected_batches_matches_jax(jax_nets, engines,
                                                    collected):
    """One PPO.update on each package's batch, with the same permutations."""
    jp = jax_nets[-1]
    _, tcfg, _, policy_params, teng, _ = engines
    _, jbatch, _, _, tbatch, _ = collected
    _assert_update_matches(tcfg, teng.policy, tbatch,
                           *_jax_update(jp, policy_params, jbatch, 11))


@pytest.mark.parametrize("task", [[0, 1, 2, 3], [3, 3, 1, 0]])
def test_eval_batch_matches_jax(engines, task):
    _, _, jeng, policy_params, teng, _ = engines
    key = jax.random.PRNGKey(13)
    jsucc, jcounts, jraw = jeng.eval_batch(
        policy_params, jnp.asarray(task, jnp.int32), key)
    kr, kc, _ = jax.random.split(key, 3)
    draws = GridEvalDraws(_jax_reset_draws(kr, N, teng.bank),
                          _t(jax.random.randint(kc, (N,), 0,
                                                GOAL_SAMPLES)).long())
    succ, counts, raw = teng.eval_batch(torch.tensor(task), draws)
    np.testing.assert_array_equal(_np(succ), np.asarray(jsucc))
    np.testing.assert_array_equal(_np(counts), np.asarray(jcounts))
    np.testing.assert_allclose(_np(raw), np.asarray(jraw), **TOL)


def test_eval_success_rule_counts_every_step(engines):
    """Forced toggles: ToggleObjectOn at every step with the commanded
    object (the FloorLamp) alone in view turns it on at step 1, and the
    count then grows by one each step, as the host sim's goal_area_count
    does."""
    _, tcfg, _, _, teng, _ = engines
    bank = teng.bank
    # every free cell of every plan, at every heading
    plan, cell = [], []
    for p in range(bank.grids.shape[0]):
        n = int(bank.free_count[p])
        plan += [p] * n
        cell.append(bank.free_cells[p, :n])
    plan = torch.tensor(plan).repeat_interleave(8)
    cell = torch.cat(cell).repeat_interleave(8, 0)
    rot = torch.arange(8).repeat(len(plan) // 8)
    vis = _np(tdev.visible_mask(bank, plan, cell, rot,
                                tcfg.RLVisibilityDistance))
    rows = np.flatnonzero(vis[:, 0] & ~vis[:, 1])[::97][:N]
    assert len(rows) == N
    # free_u picks the row's cell: (index + 0.5) / count
    fidx = [int(np.flatnonzero((_np(bank.free_cells[plan[r]]) == _np(cell[r]))
                               .all(1))[0]) for r in rows]
    u = ((torch.tensor(fidx, dtype=torch.float32) + 0.5)
         / bank.free_count[plan[rows]].float())
    draws = GridEvalDraws(
        tdev.ResetDraws(plan[rows], u, rot[rows],
                        torch.zeros((N, 2), dtype=torch.bool)),
        torch.zeros(N, dtype=torch.int64))
    task = torch.zeros(N, dtype=torch.int64)  # FloorLamp ToggleObjectOn
    on = tcfg.allActions.index("ToggleObjectOn")
    succ, counts, _ = teng.eval_batch(
        task, draws, actions=torch.full((T, N, 1), on, dtype=torch.int32))
    np.testing.assert_array_equal(_np(counts), [T] * N)
    assert _np(succ).all()


# -- the fused grid RL step ---------------------------------------------------------


def test_fused_grid_engine_and_update_match_jax(jax_nets):
    """2 x T steps of the fused engine over host grid envs (the JAX engine's
    actions drive them), with a rollout boundary, then one PPO update of
    each package's second rollout."""
    jcfg, tcfg, var_model, var_params, jpol, policy_params, jp = jax_nets
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        cfg.override(RLTrain=True)
    tvar, tpol = _port_nets(tcfg, var_params, policy_params)
    envs = make_vec_envs(tcfg.RLEnvName, tcfg.RLEnvSeed, N, None, True, tcfg)
    common = (T, N, "occupancy", (1, 9, 9))
    jengine = JEngine(var_model, var_params, jpol, jcfg, *common, jnp.uint8,
                      (1,), jnp.int32, gamma=0.99)
    jengine.set_policy_params(policy_params)
    tengine = TEngine(tvar, tpol, tcfg, *common, torch.uint8, (1,),
                      torch.int32, gamma=0.99)
    key = jax.random.PRNGKey(5)

    def noise(k):  # the Gumbel draw jax.random.categorical makes from k
        return _t(jax.random.gumbel(k, (N, A)))

    raw_obs = envs.reset()
    key, sub = jax.random.split(key)
    action = jengine.init(raw_obs, sub)
    np.testing.assert_array_equal(tengine.init(raw_obs, noise(sub)), action)
    for rollout in range(2):
        for t in range(T):
            raw_obs, env_rew, done, infos = envs.step(action)
            bad = np.asarray([0.0 if "bad_transition" in i else 1.0
                              for i in infos], np.float32)
            key, sub = jax.random.split(key)
            action, jrew = jengine.step(t, raw_obs, env_rew, done, bad, sub)
            taction, trew = tengine.step(t, raw_obs, env_rew, done, bad,
                                         noise(sub))
            np.testing.assert_array_equal(taction, action)
            # the rewards read the CRNN's goal embeddings
            np.testing.assert_allclose(trew, jrew, **CRNN_TOL)
        assert done.all()  # every env started a fresh episode here
        for name, got in tengine.buffers.as_dict().items():
            want = np.asarray(getattr(jengine.buffers, name))
            if got.dtype in (torch.uint8, torch.int32):
                np.testing.assert_array_equal(_np(got), want, err_msg=name)
            else:
                np.testing.assert_allclose(_np(got), want, err_msg=name,
                                           **CRNN_TOL)
        for engine in (jengine, tengine):
            engine.compute_returns(True, 0.99, 0.95, False)
        np.testing.assert_allclose(_np(tengine.device_batch()["returns"]),
                                   np.asarray(jengine._returns), **CRNN_TOL)
        if rollout == 0:
            for engine in (jengine, tengine):
                engine.after_update()
    envs.close()
    # one PPO update of JAX's batch on both sides, so that the update alone
    # is held at 1e-4
    jbatch = jengine.device_batch()
    tbatch = jax.tree_util.tree_map(_t, jbatch)
    _assert_update_matches(tcfg, tpol, tbatch,
                           *_jax_update(jp, policy_params, jbatch, 17))
