"""Fault F3, step (a): many collect + PPO update cycles of the arm device
sim at the arm E2E recipe's knobs, the port against the JAX package on the
CPU, with the state each side carries from cycle to cycle.

K = 6 cycles of DeviceSimEngine.collect + PPO.update, N = 4 envs, T = 6
steps (ppoNumSteps == RLEnvMaxSteps), GRU 32, 4 epochs x 2 minibatches,
the recipe's representationDim=8 (VAR and goal bank), ppoEntropyCoef=0.02
and RLLrDecay='linear' over a horizon of K updates (48 optimizer steps),
so the decay starts at step 15, inside cycle 2. The policy is the
diagonal Gaussian with its learned log-std and the sim's clipped actions.
Both sides get the same draws every cycle (tests/test_torch_device_sim.py's
_jax_collect_draws and the permutations of the JAX update, re-made from
the cycle's key). Each side carries its own return-RMS between collects,
Adam's count and moments, PPOState.step and the LR.

Every cycle also holds the Gaussian's log-std and the update's entropy:
under the entropy term the log-std grows (leg 1 of the recipe on the card:
entropy 2.838 -> 2.884), and a log-std that moved differently would show
here first.

Two forms, as tests/test_torch_grid_chain.py. In both, each cycle holds:
pixels equal; poses at atol 1e-6; the raw reward sums and the return-RMS
state at rtol = atol = 1e-4 (IEEE float32 both sides, another order of
summation); Adam's count, the update counter and the schedule's count
equal; the LR at rtol 1e-6 (the port computes it in float64 on the host,
optax in float32); the log-std within 1e-5 (it moves about 1e-4 over the
6 cycles); parameters within 2 * lr per optimizer step so far + 5e-5.
- teacher-forced: before each cycle the port takes JAX's policy
  parameters and Adam moments; Adam's count, the update counter, the LR
  and the return-RMS stay each side's own carry. Also: actions, values,
  returns, log-probs and losses at rtol = atol = 1e-4; the parameters'
  median difference below 1e-6; Adam's moments within 20% of their
  tensor's norm. A ReLU or max-pool kink can flip under float error
  inside a minibatch, and every gradient of a conv sums over the whole
  net below it (here up to 6% of a conv bias's first moment); a moment
  that was reset or not carried into the cycle would miss the
  0.9^8 = 43% of it that the cycle's 8 steps keep;
- free-running: each side keeps its own parameters, moments, return-RMS,
  count and LR through all K cycles; the port's sim applies the actions
  JAX sampled (DeviceSimEngine.collect's `actions`), with the port
  policy's own values and log-probs of them. Unlike the grid's discrete
  moves, the arm's gripper is continuous: once float error has moved the
  two policies' means apart, a gripper within a fraction of a pixel of an
  edge would render differently in one package and no tolerance could
  absorb it, so the trajectory is shared. Also: the parameters' median
  difference below 2% of the Adam path so far (lr x optimizer steps
  summed over the cycles; a wrong LR, a reset moment or a lost count
  moves the median element by a large part of it); values, returns,
  log-probs, the value loss and the entropy within 5% of their largest
  magnitude. Adam normalises every step, so the kink flips of cycle 0
  reach every parameter: here the median grows to 0.4% of the path and
  the values to 2.4% of their scale by cycle 5. The action loss, a
  difference of clipped surrogates near zero, is not held here.

Before comparing a cycle, every float32 pixel coordinate of its trajectory
is asserted to lie at least EDGE_MARGIN pixels from a pixel edge
(tests/test_torch_device_sim.py says why). The cycle keys start at
PRNGKey(KEY_BASE): with KEY_BASE 100-600, JAX's own trajectory came within
1e-3 pixel of an edge in one of the 6 cycles (about 90 coordinates a
cycle: a sixth of cycles do), so 700 is the first base whose 6 cycles all
clear the margin.

At the recipe's LR of 3e-5 the teacher-forced cycles agree to about 1e-5.
At 7e-4 (the grid chain's LR) the first update is chaotic in each package
on its own: the port, given its own batch with the returns scaled by
1 + 1e-7 noise, moved its parameters by up to 2.2e-3 and its action loss
from -0.0051 to -0.0074 over the 8 optimizer steps.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_device_sim import (EDGE_MARGIN, TOL, N, T, _configs,
                                   _jax_collect_draws, _pixel_margin)
from var_tpu.envs.spaces import Box as JBox
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import DeviceSimEngine as JEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu_torch.convert import arm_policy_state_dict, arm_state_dict
from var_tpu_torch.envs import arm_sim_device as tsim
from var_tpu_torch.envs.spaces import Box
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import DeviceSimEngine, init_rms

K = 6
D = 8
EPOCHS, MINIBATCHES = 4, 2
OPT_STEPS = EPOCHS * MINIBATCHES
CHAIN = dict(ppoEpoch=EPOCHS, ppoNumMiniBatch=MINIBATCHES,
             representationDim=D, ppoEntropyCoef=0.02, RLLrDecay="linear",
             RLTotalSteps=K * T * N, RLLr=3e-5)
MOMENT_NORM_RTOL = 0.2
LOGSTD_ATOL = 1e-5
FREE_MEDIAN_PATH, FREE_REL = 0.02, 0.05
KEY_BASE = 700


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


def _to_port(tree):
    return arm_policy_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def _np(x):
    """A copy: the engine's batch views buffers the next collect rewrites,
    and Adam's moments change in place."""
    return np.array(x.detach().numpy() if isinstance(x, torch.Tensor)
                    else x)


@pytest.fixture(scope="module")
def chain():
    """The JAX arm engine and PPO learner at the recipe's knobs, the port's
    twins from the same weights, and JAX's initial policy parameters."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs(**CHAIN)
        var_model = build_pretext_model(jcfg)
        var_params = jax.jit(lambda key: init_pretext_params(
            var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
        jpol = jpolicy.build_policy(jcfg, JBox(-np.ones(2), np.ones(2)))
        obs = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
               "image_feat": jnp.zeros((N, D)),
               "robot_pose": jnp.zeros((N, 2)),
               "goal_sound_feat": jnp.zeros((N, D))}
        policy_params = jax.jit(jpol.init, static_argnums=4)(
            jax.random.PRNGKey(1), obs, jnp.zeros((N, 32)), jnp.ones((N, 1)),
            1)["params"]
        jeng = JEngine(var_model, var_params, jpol, jcfg, T, N)
        tvar = VARPretextNet(D)
        tvar.load_state_dict(arm_state_dict(
            jax.tree_util.tree_map(np.asarray, var_params)))
        tvar.eval().requires_grad_(False)
        tpol = build_policy(tcfg, Box(-np.ones(2), np.ones(2)))
        teng = DeviceSimEngine(tvar, tpol, tcfg, T, N)
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
    return jcfg, tcfg, jeng, teng, jp, policy_params


def _perms(key):
    """The env permutations var_tpu's PPO.update draws from `key`."""
    perms, k = [], key
    for _ in range(EPOCHS):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))
    return torch.from_numpy(np.stack(perms)).long()


def _run_chain(chain, teacher: bool):
    """K cycles on both sides; returns one record per cycle."""
    jcfg, tcfg, jeng, teng, jp, policy_params = chain
    tpol = teng.policy
    tpol.load_state_dict(_to_port(policy_params))
    port = tppo.PPO(tpol, tppo.PPOConfig.from_config(tcfg))
    tstate = port.init_state()
    jstate = jp.init_state(jax.tree_util.tree_map(jnp.array, policy_params))
    jrms, trms = jinit_rms(N), init_rms(N)
    lr_max = 2 * tcfg.RLLr * OPT_STEPS
    records = []
    for c in range(K):
        if teacher:
            tpol.load_state_dict(_to_port(jstate.params))
            adam = jstate.opt_state[1]
            with torch.no_grad():
                for mine, theirs in ((tstate.opt_state.mu, adam.mu),
                                     (tstate.opt_state.nu, adam.nu)):
                    for k, v in _to_port(theirs).items():
                        mine[k].copy_(v)
        kc, ku = jax.random.split(jax.random.PRNGKey(KEY_BASE + c))
        jrms, jbatch, jstats = jeng.collect(jrms, jstate.params, kc)
        draws = _jax_collect_draws(kc, teng.k)
        trms, tbatch, tstats = teng.collect(
            trms, draws,
            None if teacher else torch.from_numpy(np.array(jbatch["actions"])))
        obj_pose = tsim.reset_from_draws(draws.reset, teng.k)[0]
        ees = _np(tbatch["obs"]["robot_pose"]).reshape(-1, 2)
        final = _np(tsim.apply_action(tbatch["obs"]["robot_pose"][-1],
                                      tbatch["actions"][-1], teng.k))
        rec = {"cycle": c,
               "margin": _pixel_margin(obj_pose,
                                       np.concatenate([ees, final]), teng.k),
               "pixels_equal": bool(np.array_equal(
                   _np(tbatch["obs"]["image"]),
                   np.asarray(jbatch["obs"]["image"]))),
               "pose_err": float(np.abs(
                   ees - np.asarray(jbatch["obs"]["robot_pose"]).reshape(
                       -1, 2)).max())}
        rollout = [(name, _np(tbatch[name]), np.asarray(jbatch[name]))
                   for name in ("actions", "value_preds", "returns",
                                "old_log_probs")]
        rollout += [("raw_sums", _np(tstats), np.asarray(jstats))]
        rollout += [(f"rms.{f}", _np(g), np.asarray(w))
                    for f, g, w in zip(trms._fields, trms, jrms)]
        rec["rollout"] = rollout

        jstate, jm = jp.update(jstate, jbatch, ku)
        tstate, tm = port.update(tstate, tbatch, _perms(ku))
        rec["metrics"] = [(k, _np(v), np.asarray(jm[k])) for k, v in
                          tm.items()]
        want = _to_port(jstate.params)
        rec["logstd"] = (_np(tstate.params["dist_head.logstd"]),
                         want["dist_head.logstd"].numpy())
        diffs = torch.cat([(tstate.params[k].detach() - v).abs().ravel()
                           for k, v in want.items()])
        rec["param_max"] = diffs.max().item()
        rec["param_median"] = diffs.median().item()
        rec["param_bound"] = lr_max * (1 if teacher else c + 1) + 5e-5
        adam = jstate.opt_state[1]
        rec["adam_count"] = (tstate.opt_state.count, int(adam.count))
        rec["sched_count"] = int(jstate.opt_state[-1].count)
        rec["step"] = (tstate.step, int(jstate.step))
        rec["lr"] = (port.current_lr(tstate), jp.current_lr(jstate))
        rec["moments"] = [
            (f"{m}.{k}", _np(getattr(tstate.opt_state, m)[k]), v.numpy())
            for m, tree in (("mu", adam.mu), ("nu", adam.nu))
            for k, v in _to_port(tree).items()]
        rec["rollout_err"] = max(float(np.abs(g - w).max())
                                 for _, g, w in rollout + rec["metrics"])
        records.append(rec)
        print(f"{'teacher' if teacher else 'free'} cycle {c}: rollout "
              f"{rec['rollout_err']:.3e}, params max "
              f"{rec['param_max']:.3e} median {rec['param_median']:.3e}, "
              f"logstd {rec['logstd'][0]} vs {rec['logstd'][1]}, "
              f"entropy {float(tm['dist_entropy']):.5f}, "
              f"lr {rec['lr'][0]:.6g}")
    return records


def _assert_carried(rec, c):
    assert rec["margin"] > EDGE_MARGIN, "a state lies on a pixel edge"
    assert rec["pixels_equal"]
    assert rec["pose_err"] <= 1e-6
    assert rec["adam_count"] == ((c + 1) * OPT_STEPS,) * 2
    assert rec["sched_count"] == (c + 1) * OPT_STEPS
    assert rec["step"] == (c + 1, c + 1)
    np.testing.assert_allclose(*rec["lr"], rtol=1e-6)
    np.testing.assert_allclose(*rec["logstd"], rtol=0, atol=LOGSTD_ATOL)
    assert rec["param_max"] <= rec["param_bound"]
    for name, got, want in rec["rollout"]:
        if name == "raw_sums" or name.startswith("rms."):
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_teacher_forced_cycles_match_jax(chain):
    records = _run_chain(chain, teacher=True)
    lrs = [r["lr"][0] for r in records]
    assert lrs[0] == CHAIN["RLLr"] and lrs[-1] < lrs[1] < lrs[0]
    for c, rec in enumerate(records):
        _assert_carried(rec, c)
        assert rec["param_median"] < 1e-6
        for name, got, want in rec["rollout"] + rec["metrics"]:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        norms = [(float(np.linalg.norm(got - want) / np.linalg.norm(want)),
                  name) for name, got, want in rec["moments"]]
        print(f"cycle {c}: moments' largest relative difference {max(norms)}")
        assert max(norms)[0] < MOMENT_NORM_RTOL


def test_free_running_cycles_match_jax(chain):
    records = _run_chain(chain, teacher=False)
    path = 0.0
    for c, rec in enumerate(records):
        _assert_carried(rec, c)
        path += rec["lr"][1] * OPT_STEPS
        assert rec["param_median"] < FREE_MEDIAN_PATH * path
        for name, got, want in rec["rollout"] + rec["metrics"]:
            if name in ("value_preds", "returns", "old_log_probs",
                        "value_loss", "dist_entropy"):
                scale = float(np.abs(want).max())
                np.testing.assert_allclose(got, want, err_msg=name, rtol=0,
                                           atol=FREE_REL * scale)
