"""Fault F1, step A1: one cycle of the grid's shared RL path at the recipe's
width, the port against the JAX package on the CPU.

The earlier chain test (tests/test_torch_grid_chain.py) ran N = 4 envs,
T = 6 steps, GRU 32, sound (1, 100, 40), LR 7e-4, a random VAR, JAX's goal
bank in both engines and the port's render in JAX's. Here, at the recipe's
knobs (var_tpu/config/ai2thor.py: GRU 1024, sound 1x600x40,
representationDim 3, 50-step episodes; LR 6e-5 with RLLrDecay='linear'
over the 10M-step horizon, 4 epochs x 2 minibatches):
- the VAR is a trained JAX grid VAR (2 epochs on a small grid collection,
  20 triplets), carried across with var_tpu_torch/convert.py;
- each engine builds its own goal bank (draws per task from
  RandomState(RLEnvSeed + 101) through its own host MFCC and CRNN) and its
  own plan bank; the plan banks are held equal byte for byte on every field
  both hold;
- one GridDeviceSimEngine.collect from JAX's draws, each package's batch
  held to the other's; then one PPO update of JAX's batch on both sides
  with JAX's permutations, from the same policy weights (JAX's init at
  RLEnvSeed, converted); every minibatch's gradient global norm and clip
  factor are held too (JAX's by replaying its update with its own loss,
  optax chain and permutations);
- then the fused host path: rl/rollout_device.py over envs/grid_sim.py, one
  T-step rollout driven by JAX's actions and one PPO update of JAX's
  rollout;
- the same collect through JAX's own device render, held to the port's;
- JAX's initial draws, written as the port's checkpoint directories, load
  through the port's own fine-tune knobs (the file's end writes them from
  the command line, for runs that start the recipe from them).
Tier-1 runs 8 envs x 50 steps with 8 goal draws per task; the recipe's 64
envs and 64 draws carry `slow`:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_grid_fullwidth.py -m slow

Tolerances, each with its reason:
- plan banks, pixels, occupancy crops and actions: equal. JAX's device
  render samples its rays in float32 and differs from the host sim at a few
  pixels of about a fifth of the states (tests/test_torch_grid_sim.py); the
  JAX engine here renders through a callback into the port's render, which
  equals the host sim's, over the bank held equal above. The same collect
  through JAX's own render is held separately, at the bounds
  test_jax_own_render_on_the_collect states;
- the goal banks, and what reads them (rewards, the return-RMS, returns,
  values, log-probs), at the CRNN's rtol 1e-3 / atol 2e-4 (BASELINE.md);
- the PPO losses and the first minibatch's gradient norm and clip factor
  at rtol = atol = 1e-4 (IEEE float32 both sides, another order of
  summation, on one batch); each later minibatch's norm and clip factor at
  rtol 5e-3: it is taken at parameters Adam has already moved within its
  bound (2 lr where a near-zero gradient rounds to the other sign), which
  moves a norm by up to about 1e-3 here;
- parameters after the update within 2 * lr per optimizer step + 5e-5,
  median below 1e-6 (tests/test_torch_ppo.py states why).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.envs import grid_sim_device as jdev
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import GridDeviceSimEngine as JGridEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu.rl.rollout_device import DeviceRolloutEngine as JEngine
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_policy_state_dict, ai2thor_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.envs import grid_sim_device as tdev
from var_tpu_torch.envs.spaces import Discrete
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import (GridCollectDraws,
                                         GridDeviceSimEngine, init_rms)
from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine as TEngine
from var_tpu_torch.train import pretext as tpretext

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
LATER_NORM_TOL = dict(rtol=5e-3, atol=0)
T, A = 50, 8
RECIPE = dict(RLLr=6e-5, RLLrDecay="linear", RLTotalSteps=10_000_000,
              vecEnvBackend="dummy")
# (envs, goal draws per task): tier-1's reduced case, the recipe's
WIDTHS = [(8, 8), pytest.param((64, 64), marks=pytest.mark.slow)]


@pytest.fixture(autouse=True)
def _threads():
    """Two torch threads per test worker: the machine is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.array(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(**extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="ai2thor")
        cfg.override(**{**RECIPE, **extra})
        mod.gym_register(cfg, env="ai2thor")
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def trained_var(tmp_path_factory):
    """A JAX grid VAR trained 2 epochs on a small grid collection (the
    port's collector; the shards are byte for byte JAX's,
    tests/test_torch_shmem.py), and both packages' audio stores."""
    work = tmp_path_factory.mktemp("grid_var")
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        jcfg, tcfg = _configs(
            pretextDataDir=[str(work / "triplets")],
            pretextModelSaveDir=str(work / "var"),
            pretextCollectNum=[2, 2, 4, 4, 8], pretextDataEpisode=200,
            pretextDataNumFiles=1, pretextNumEnvs=2, pretextEpoch=2,
            pretextTrainBatchSize=4, pretextModelSaveInterval=100,
            pretextModelFineTune=False, pretextDataset="VARDataset")
        jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
        jaudio.loadData()
        taudio.loadData()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    tpretext.PretextTrainer(tcfg, device="cpu",
                            audio=taudio).collectPretextData()
    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    losses = jtr.trainRepresentation(log_csv=False)
    assert losses[-1] < losses[0]  # it learned
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    return build_pretext_model(jcfg), params, jaudio, taudio


def _policies(jcfg, tcfg, n):
    """JAX's policy from PRNGKey(RLEnvSeed) and the port's twin."""
    jpol = jpolicy.build_policy(jcfg, JDiscrete(A))
    obs = {"image": jnp.zeros((n, 3, 96, 96), jnp.uint8),
           "occupancy": jnp.zeros((n, 1, 9, 9), jnp.uint8),
           "image_feat": jnp.zeros((n, 3)),
           "goal_sound_feat": jnp.zeros((n, 3))}
    params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(jcfg.RLEnvSeed), obs,
        jnp.zeros((n, jcfg.RLRecurrentSize)), jnp.ones((n, 1)), 1)["params"]
    tpol = build_policy(tcfg, Discrete(A))
    tpol.load_state_dict(ai2thor_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return jpol, params, tpol


def _port_var(var_params):
    tvar = VARPretextNet(3, "ai2thor")
    tvar.load_state_dict(ai2thor_state_dict(var_params))
    return tvar.eval().requires_grad_(False)


def _host_render_for_jax(tbank):
    """var_tpu's render_chw, answered by the port's render (the host sim's
    frame) through a callback."""

    def render_chw(bank, plan, pos, rot_idx, toggled, config):
        def host(plan, pos, rot, tog):
            args = [torch.from_numpy(np.asarray(a, np.int64))
                    for a in (plan, pos, rot)]
            return _np(tdev.render_chw(tbank, *args,
                                       torch.from_numpy(np.asarray(tog))))

        shape = jax.ShapeDtypeStruct((pos.shape[0], 3, 96, 96), jnp.uint8)
        return jax.pure_callback(host, shape, plan, pos, rot_idx, toggled)

    return render_chw


def _jax_collect_draws(key, bank, n, samples):
    """The draws var_tpu's GridDeviceSimEngine._collect makes from `key`,
    as the port's GridCollectDraws."""
    kr, kc, ka, ks = jax.random.split(key, 4)
    k1, krest = jax.random.split(kr)
    k2, k3, k4, k5 = jax.random.split(krest, 4)
    reset = tdev.ResetDraws(*map(_t, (
        jax.random.randint(k2, (n,), 0, bank.grids.shape[0]),
        jax.random.uniform(k3, (n,)),
        jax.random.randint(k4, (n,), 0, 8),
        jax.random.bernoulli(k5, 0.5, (n, 2)))))
    noise = [jax.random.gumbel(ka, (n, A))] + [
        jax.random.gumbel(s, (n, A)) for s in jax.random.split(ks, T)]
    return GridCollectDraws(
        reset, _t(jax.random.randint(k1, (n,), 0, 4)).long(),
        _t(jax.random.randint(kc, (n,), 0, samples)).long(),
        _t(jnp.stack(noise)))


def _perms(key, n, epochs):
    """The env permutations var_tpu's PPO.update draws from `key`."""
    perms, k = [], key
    for _ in range(epochs):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    return np.stack(perms)


def _jax_update(jp, params, batch, perms):
    """var_tpu's PPO.update (var_tpu/rl/ppo.py: mb_body over the epoch x
    minibatch index sets) run minibatch by minibatch with its own loss,
    optax chain and the given permutations, so that what the jitted update
    keeps inside can be read: each minibatch's gradient global norm.
    Returns (params, metrics, norms)."""
    cfg = jp.cfg
    Tb, N = batch["returns"].shape
    n = N // cfg.num_mini_batch
    adv = batch["returns"] - batch["value_preds"]
    adv = (adv - adv.mean()) / (adv.std(ddof=1) + 1e-5)
    grad_fn = jax.jit(jax.value_and_grad(jp._minibatch_loss, has_aux=True),
                      static_argnums=9)
    opt_state, norms, stats = jp.tx.init(params), [], []
    for env_idx in jnp.asarray(perms).reshape(-1, n):
        def take(x, axis=1):
            x = jnp.take(x, env_idx, axis=axis)
            return x if axis == 0 else x.reshape((Tb * n,) + x.shape[2:])

        (_, aux), grads = grad_fn(
            params, {k: take(v) for k, v in batch["obs"].items()},
            take(batch["rnn_hx0"], 0), take(batch["masks"]),
            take(batch["actions"]), take(batch["value_preds"]),
            take(batch["returns"]), take(batch["old_log_probs"]), take(adv),
            Tb)
        norms.append(float(optax.global_norm(grads)))
        stats.append(np.asarray(aux))
        updates, opt_state = jp.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    mean = np.mean(stats, axis=0)
    metrics = dict(zip(("value_loss", "action_loss", "dist_entropy"), mean))
    return params, metrics, np.asarray(norms)


def _port_update(tcfg, tpol, batch, perms, monkeypatch):
    """The port's PPO.update with each minibatch's gradient norm read from
    clip_by_global_norm_."""
    norms = []
    clip = tppo.clip_by_global_norm_

    def recording(grads, max_norm):
        g = clip(grads, max_norm)
        norms.append(g.item())
        return g

    monkeypatch.setattr(tppo, "clip_by_global_norm_", recording)
    port = tppo.PPO(tpol, tppo.PPOConfig.from_config(tcfg))
    state, metrics = port.update(port.init_state(), batch,
                                 torch.from_numpy(perms).long())
    return state, metrics, np.asarray(norms), port


def _assert_update(tcfg, jparams, jmetrics, jnorms, state, metrics, norms):
    for name, v in metrics.items():
        np.testing.assert_allclose(_np(v), jmetrics[name], err_msg=name,
                                   **TOL)
    steps = tcfg.ppoEpoch * tcfg.ppoNumMiniBatch
    assert len(norms) == len(jnorms) == steps
    clip = tcfg.RLMaxGradNorm
    # the first minibatch from the same parameters at 1e-4; the later ones
    # from parameters Adam has moved, within its bound, by up to 2 lr where
    # a near-zero gradient rounds to the other sign
    for i, tol in enumerate([TOL] + [LATER_NORM_TOL] * (steps - 1)):
        np.testing.assert_allclose(norms[i], jnorms[i], err_msg=str(i), **tol)
        np.testing.assert_allclose(min(1, clip / norms[i]),
                                   min(1, clip / jnorms[i]), err_msg=str(i),
                                   **tol)
    want = ai2thor_policy_state_dict(jax.tree_util.tree_map(
        np.asarray, jparams))
    atol = 2 * tcfg.RLLr * steps + 5e-5
    diffs = torch.cat([(state.params[k].detach() - v).abs().ravel()
                       for k, v in want.items()])
    assert diffs.max().item() <= atol
    assert diffs.median().item() < 1e-6


def test_plan_banks_are_equal_byte_for_byte():
    jcfg, tcfg = _configs()
    jbank, tbank = jdev.build_plan_bank(jcfg), tdev.build_plan_bank(tcfg)
    common = [f for f in jbank._fields if f in tbank._fields]
    assert len(common) == len(jbank._fields) == 8
    for name in common:
        want, got = np.asarray(getattr(jbank, name)), _np(getattr(tbank, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- the grid device sim ---------------------------------------------------------


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda w: f"{w[0]}envs")
def device_cycle(request, trained_var):
    """Both engines with their own goal banks, one collect from JAX's draws,
    JAX's PPO update, its replay, and the permutations."""
    n, samples = request.param
    var_model, var_params, jaudio, taudio = trained_var
    jcfg, tcfg = _configs(RLNumEnvs=n)
    jpol, params, tpol = _policies(jcfg, tcfg, n)
    patch = pytest.MonkeyPatch()
    build_bank = JGridEngine._build_goal_bank
    try:
        patch.setattr(GridDeviceSimEngine, "SAMPLES_PER_TASK", samples)
        teng = GridDeviceSimEngine(_port_var(var_params), tpol, tcfg, T, n,
                                   audio=taudio)
        patch.setattr(jdev, "render_chw", _host_render_for_jax(teng.bank))
        patch.setattr(JGridEngine, "_build_goal_bank",
                      lambda self, audio=None: build_bank(
                          self, audio, samples_per_task=samples))
        jeng = JGridEngine(var_model, jax.tree_util.tree_map(
            jnp.asarray, var_params), jpol, jcfg, T, n, audio=jaudio)
        key = jax.random.PRNGKey(2)
        jrms, jbatch, jstats = jeng.collect(jinit_rms(n), params, key)
        trms, tbatch, tstats = teng.collect(
            init_rms(n), _jax_collect_draws(key, teng.bank, n, samples))
        perms = _perms(jax.random.PRNGKey(11), n, jcfg.ppoEpoch)
        jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
        jupdate = _jax_update(jp, params, jbatch, perms)
    finally:
        patch.undo()
    # the same collect through JAX's own device render: a copy of the
    # engine (its jitted collect is cached per engine) traced unpatched
    _, jown, _ = copy.copy(jeng).collect(jinit_rms(n), params, key)
    return dict(n=n, samples=samples, jcfg=jcfg, tcfg=tcfg, jeng=jeng,
                teng=teng, jout=(jrms, jbatch, jstats),
                tout=(trms, tbatch, tstats), jown=jown, perms=perms,
                jupdate=jupdate)


def test_goal_banks_match_jax(device_cycle):
    jeng, teng = device_cycle["jeng"], device_cycle["teng"]
    shape = (4, device_cycle["samples"], 3)
    assert tuple(teng.goal_bank.shape) == jeng.goal_bank.shape == shape
    np.testing.assert_allclose(_np(teng.goal_bank),
                               np.asarray(jeng.goal_bank), **CRNN_TOL)


def test_collect_matches_jax(device_cycle):
    jrms, jbatch, jstats = device_cycle["jout"]
    trms, tbatch, tstats = device_cycle["tout"]
    for name in ("image", "occupancy"):
        np.testing.assert_array_equal(_np(tbatch["obs"][name]),
                                      np.asarray(jbatch["obs"][name]),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(tbatch["actions"]),
                                  np.asarray(jbatch["actions"]))
    for name in ("image_feat", "goal_sound_feat"):
        np.testing.assert_allclose(_np(tbatch["obs"][name]),
                                   np.asarray(jbatch["obs"][name]),
                                   err_msg=name, **CRNN_TOL)
    for name in ("value_preds", "returns", "old_log_probs"):
        np.testing.assert_allclose(_np(tbatch[name]), np.asarray(jbatch[name]),
                                   err_msg=name, **CRNN_TOL)
    np.testing.assert_allclose(_np(tstats), np.asarray(jstats), **CRNN_TOL)
    for name, got, want in zip(("ret", "mean", "var", "count"), trms, jrms):
        np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=name,
                                   **CRNN_TOL)
    # a rollout that moved and turned, with the reward of a trained VAR
    assert len(set(_np(tbatch["actions"]).ravel())) >= 4
    assert np.std(_np(tstats)) > 0.1


def test_jax_own_render_on_the_collect(device_cycle):
    """The collect above renders JAX's side through the port's render;
    here JAX renders through its own float32 rays over its own plan bank,
    from the same draws and weights, and is held to the port's batch:
    - every frame within JAX's own bound of the host's frame (0.2% of its
      pixels, tests/test_grid_sim_device.py), most frames equal, and the
      same actions, so both walk the same states;
    - where a frame is equal, its VAR embedding at the CRNN's tolerance;
    - the values and returns within 2% of their largest magnitude: the
      reward is the dot product of the image embedding with the goal's,
      and a few differing pixels move a trained VAR's embedding by up to
      about 0.02 (at 8 envs: 75 of 400 frames differ, values by 0.55% and
      returns by 0.33% of that scale)."""
    _, tbatch, _ = device_cycle["tout"]
    jown = device_cycle["jown"]
    jimg = np.asarray(jown["obs"]["image"])
    timg = _np(tbatch["obs"]["image"])
    share = (jimg != timg).any(-3).mean((-2, -1))
    assert share.max() <= 0.002
    assert (share == 0).mean() >= 0.5
    np.testing.assert_array_equal(np.asarray(jown["actions"]),
                                  _np(tbatch["actions"]))
    same = share == 0
    np.testing.assert_allclose(_np(tbatch["obs"]["image_feat"])[same],
                               np.asarray(jown["obs"]["image_feat"])[same],
                               **CRNN_TOL)
    print(f"frames differing {(share > 0).sum()} of {share.size}, "
          f"at most {share.max():.3%} of a frame's pixels")
    for name in ("value_preds", "returns"):
        want = np.asarray(jown[name])
        rel = np.abs(_np(tbatch[name]) - want).max() / np.abs(want).max()
        print(f"{name} within {rel:.2%} of their largest magnitude")
        assert rel <= 0.02, name


def test_ppo_update_matches_jax(device_cycle, monkeypatch):
    """One PPO update of JAX's batch on both sides with JAX's permutations
    (the port's own batch is held to JAX's in test_collect_matches_jax):
    the losses, every minibatch's gradient norm and clip factor, the
    parameters after Adam."""
    tcfg = device_cycle["tcfg"]
    tbatch = jax.tree_util.tree_map(_t, device_cycle["jout"][1])
    tpol = device_cycle["teng"].policy
    saved = {k: v.clone() for k, v in tpol.state_dict().items()}
    try:
        state, metrics, norms, port = _port_update(
            tcfg, tpol, tbatch, device_cycle["perms"], monkeypatch)
        _assert_update(tcfg, *device_cycle["jupdate"], state, metrics, norms)
        # the schedule: 6e-5 held until a third of the 10M-step horizon
        assert port.current_lr(state) == tcfg.RLLr
        assert state.opt_state.count == 8
    finally:
        tpol.load_state_dict(saved)


# -- the fused host path -----------------------------------------------------------


def test_fused_host_cycle_matches_jax(trained_var, monkeypatch):
    """One T-step rollout of rl/rollout_device.py over 8 host grid sims
    (envs/grid_sim.py, JAX's actions drive them), each engine encoding the
    goal MFCCs the sims give it through its own CRNN, then one PPO update of
    each package's own rollout."""
    n = 8
    var_model, var_params, _, _ = trained_var
    jcfg, tcfg = _configs(RLNumEnvs=n, RLTrain=True)
    jpol, params, tpol = _policies(jcfg, tcfg, n)
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        envs = make_vec_envs(tcfg.RLEnvName, tcfg.RLEnvSeed, n, None, True,
                             tcfg)
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    common = (T, n, "occupancy", (1, 9, 9))
    jengine = JEngine(var_model, jax.tree_util.tree_map(jnp.asarray,
                                                        var_params),
                      jpol, jcfg, *common, jnp.uint8, (1,), jnp.int32,
                      gamma=0.99)
    jengine.set_policy_params(params)
    tengine = TEngine(_port_var(var_params), tpol, tcfg, *common, torch.uint8,
                      (1,), torch.int32, gamma=0.99)
    key = jax.random.PRNGKey(5)

    def noise(k):  # the Gumbel draw jax.random.categorical makes from k
        return _t(jax.random.gumbel(k, (n, A)))

    try:
        raw_obs = envs.reset()
        key, sub = jax.random.split(key)
        action = jengine.init(raw_obs, sub)
        np.testing.assert_array_equal(tengine.init(raw_obs, noise(sub)),
                                      action)
        for t in range(T):
            raw_obs, env_rew, done, infos = envs.step(action)
            bad = np.asarray([0.0 if "bad_transition" in i else 1.0
                              for i in infos], np.float32)
            key, sub = jax.random.split(key)
            action, jrew = jengine.step(t, raw_obs, env_rew, done, bad, sub)
            taction, trew = tengine.step(t, raw_obs, env_rew, done, bad,
                                         noise(sub))
            np.testing.assert_array_equal(taction, action)
            np.testing.assert_allclose(trew, jrew, **CRNN_TOL)
        assert done.all()
    finally:
        envs.close()
    for name, got in tengine.buffers.as_dict().items():
        want = np.asarray(getattr(jengine.buffers, name))
        if got.dtype in (torch.uint8, torch.int32):
            np.testing.assert_array_equal(_np(got), want, err_msg=name)
        else:
            np.testing.assert_allclose(_np(got), want, err_msg=name,
                                       **CRNN_TOL)
    for engine in (jengine, tengine):
        engine.compute_returns(True, 0.99, 0.95, False)
    jbatch, tbatch = jengine.device_batch(), tengine.device_batch()
    np.testing.assert_allclose(_np(tbatch["returns"]),
                               np.asarray(jbatch["returns"]), **CRNN_TOL)
    perms = _perms(jax.random.PRNGKey(17), n, jcfg.ppoEpoch)
    jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
    jupdate = _jax_update(jp, params, jbatch, perms)
    # the update of JAX's rollout on both sides: the port's own is held
    # above at the CRNN's tolerance
    state, metrics, norms, _ = _port_update(
        tcfg, tpol, jax.tree_util.tree_map(_t, jbatch), perms, monkeypatch)
    _assert_update(tcfg, *jupdate, state, metrics, norms)


# -- JAX's draws and the first updates' log, for runs outside the tests ------------
#
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_grid_fullwidth.py \
#         draws OUT_DIR [--var-key 977] [--policy-key 349]
#
# writes JAX's initial draws converted for the port, as checkpoint
# directories: OUT_DIR/jax_var_<k> (the grid VAR at PRNGKey(k)) and
# OUT_DIR/jax_policy_<k> (the policy at PRNGKey(k), GRU 1024). The port's
# own knobs start a run from them: copied to WORK/var_model/59, the first
# VAR checkpoint e2e_run's recipe loads, with --set
# pretextModelFineTune=True, the VAR trains from JAX's draw (and its last
# epoch is saved over it); --set RLModelFineTune=True
# RLModelLoadDir=OUT_DIR/jax_policy_<k> starts PPO from JAX's policy draw
# (parameters only: Adam starts fresh, as from scratch).
#
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_grid_fullwidth.py \
#         jax|port VAR_CHECKPOINT OUT_DIR [--envs 8] [--updates 50] \
#         [--seed 350] [--policy-init own|jax]
#
# trains the grid recipe's device sim (the recipe's knobs; --envs envs) for
# --updates PPO updates on the CPU from the port's VAR checkpoint directory
# (e2e_run's WORK/var_model/59; JAX gets it converted back), and writes
# OUT_DIR/progress.csv, one row per update.


def _jax_params_from_port(sd, template):
    """The inverse of convert.ai2thor_state_dict: every JAX leaf found in
    the port's tensors by converting a probe (the leaf's element indices)
    through the forward map."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    out = []
    for i, leaf in enumerate(leaves):
        probe = [np.zeros(np.shape(x), np.float64) for x in leaves]
        probe[i] = np.arange(1, probe[i].size + 1,
                             dtype=np.float64).reshape(probe[i].shape)
        fwd = ai2thor_state_dict(jax.tree_util.tree_unflatten(treedef, probe))
        value = np.zeros(probe[i].size, np.float32)
        for name, t in fwd.items():
            where = t.double().numpy().ravel()
            hit = where > 0
            if hit.any():
                value[where[hit].astype(np.int64) - 1] = \
                    sd[name].float().numpy().ravel()[hit]
        out.append(jnp.asarray(value.reshape(np.shape(leaf))))
    return jax.tree_util.tree_unflatten(treedef, out)


def write_jax_draws(out_dir, var_key=977, policy_key=349):
    """JAX's initial draws of the grid VAR and of the policy, converted,
    as the port's checkpoint directories (see the comment above)."""
    from var_tpu.models.encoders import init_pretext_params
    from var_tpu_torch.train.checkpoint import save_checkpoint

    jcfg, tcfg = _configs(RLEnvSeed=policy_key)
    params = init_pretext_params(build_pretext_model(jcfg), jcfg,
                                 jax.random.PRNGKey(var_key))["params"]
    var_dir = os.path.join(out_dir, f"jax_var_{var_key}")
    save_checkpoint(var_dir, {"params": ai2thor_state_dict(
        jax.tree_util.tree_map(np.asarray, params))})
    _, _, tpol = _policies(jcfg, tcfg, 8)
    policy_dir = os.path.join(out_dir, f"jax_policy_{policy_key}")
    save_checkpoint(policy_dir, {"params": tpol.state_dict()})
    return var_dir, policy_dir


def test_jax_draws_start_the_port_through_its_knobs(tmp_path):
    """The written draws load through the port's own fine-tune knobs and
    equal JAX's draws: the VAR's forward pass at the CRNN's tolerance, the
    policy's parameters exactly."""
    from var_tpu.models.encoders import init_pretext_params
    from var_tpu_torch.train.checkpoint import load_checkpoint
    from var_tpu_torch.train.pretext import PretextTrainer

    var_dir, policy_dir = write_jax_draws(str(tmp_path), 3, 5)
    jcfg, tcfg = _configs(RLEnvSeed=5, pretextModelFineTune=True,
                          pretextModelLoadDir=var_dir)
    tvar = PretextTrainer(tcfg, device="cpu").loadPretextModel().eval()
    jmodel = build_pretext_model(jcfg)
    jvars = init_pretext_params(jmodel, jcfg, jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    img = rng.rand(2, 3, 96, 96).astype(np.float32)
    snd = rng.randn(2, 1, 100, 40).astype(np.float32)
    for method, x in (("encode_image", img), ("encode_sound", snd)):
        want = jmodel.apply(jvars, jnp.asarray(x),
                            method=getattr(jmodel, method))[1]
        with torch.no_grad():
            got = getattr(tvar, method)(_t(x))[1]
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   err_msg=method, **CRNN_TOL)
    _, params, _ = _policies(jcfg, tcfg, 8)
    want = ai2thor_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            params))
    got = load_checkpoint(policy_dir)["params"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _log_run(package, var_dir, out_dir, envs, updates, seed,
             policy_init="own"):
    from var_tpu_torch.train.checkpoint import load_checkpoint

    knobs = dict(RLNumEnvs=envs, RLDeviceSimRollout=True, RLEnvSeed=seed,
                 RLTrain=True, RLLogInterval=1, RLModelSaveInterval=10 ** 6,
                 RLModelSaveDir=str(out_dir))
    jcfg, tcfg = _configs(**knobs)
    sd = load_checkpoint(var_dir)["params"]
    if package == "jax":
        from var_tpu.models.encoders import init_pretext_params
        from var_tpu.train.rl import RLTrainer as JTrainer

        trainer = JTrainer(jcfg, env="ai2thor")
        template = init_pretext_params(trainer.pretext_model, jcfg,
                                       jax.random.PRNGKey(0))["params"]
        trainer.pretext_params = _jax_params_from_port(sd, template)
        # the round trip is exact: it moves float32 values only
        back = ai2thor_state_dict(jax.tree_util.tree_map(
            np.asarray, trainer.pretext_params))
        assert all(torch.equal(back[k], sd[k].float()) for k in sd)
    else:
        from var_tpu_torch.train.rl import RLTrainer as TTrainer

        if policy_init == "jax":
            _, policy_dir = write_jax_draws(str(out_dir), policy_key=seed)
            tcfg.override(RLModelFineTune=True, RLModelLoadDir=policy_dir)
        trainer = TTrainer(tcfg, env="ai2thor", device="cpu")
        var = VARPretextNet(3, "ai2thor")
        var.load_state_dict(sd)
        trainer.pretext_model = var.eval().requires_grad_(False)
    trainer.trainRL(total_steps=updates * envs * T)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    draws = sub.add_parser("draws")
    draws.add_argument("out_dir")
    draws.add_argument("--var-key", type=int, default=977)
    draws.add_argument("--policy-key", type=int, default=349)
    for name in ("jax", "port"):
        log = sub.add_parser(name)
        log.add_argument("var_checkpoint")
        log.add_argument("out_dir")
        log.add_argument("--envs", type=int, default=8)
        log.add_argument("--updates", type=int, default=50)
        log.add_argument("--seed", type=int, default=350)
        log.add_argument("--policy-init", choices=["own", "jax"],
                         default="own",
                         help="the port only: start from JAX's policy draw")
    a = ap.parse_args()
    torch.set_num_threads(4)
    if a.command == "draws":
        print(write_jax_draws(a.out_dir, a.var_key, a.policy_key))
    else:
        _log_run(a.command, a.var_checkpoint, a.out_dir, a.envs, a.updates,
                 a.seed, a.policy_init)
