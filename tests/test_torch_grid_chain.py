"""Fault F1, step (a): many collect + PPO update cycles of the grid device
sim, the port against the JAX package on the CPU, with the state each side
carries from cycle to cycle.

K = 5 cycles of GridDeviceSimEngine.collect + PPO.update at the recipe's
4 epochs x 2 minibatches, N = 4 envs, T = 6 steps, GRU 32, the CRNN at
sound (1, 100, 40). Both sides get the same draws every cycle
(tests/test_torch_grid_rl.py's _jax_collect_draws and the permutations of
its _jax_update, re-made from the cycle's key). Each side carries its own:
- the return-RMS between collects (mean, var, count; the per-env return is
  zeroed at each rollout's end, var_tpu/rl/device_sim.py:512);
- Adam's count, mu and nu, and PPOState.step;
- the LR, RLLrDecay='linear' over a horizon of K updates (40 optimizer
  steps), so the decay starts at step 13, inside cycle 2.

Two forms:
- teacher-forced: before each cycle the port takes JAX's policy
  parameters and Adam moments, so float error cannot compound; Adam's
  count, the update counter, the LR and the return-RMS stay each side's
  own carry. Each cycle is held as the one-cycle tests hold theirs
  (tests/test_torch_grid_rl.py): pixels, crops and actions equal; rollout
  values, returns, the RMS state and losses at rtol = atol = 1e-4 (IEEE
  float32 both sides, another order of summation); parameters after the
  update within 2 * lr per optimizer step + 5e-5, median below 1e-6;
  counts and steps equal; the LR at rtol 1e-6 (the port computes it in
  float64 on the host, optax in float32). Adam's moments after the update:
  the median element within 1% relative, every element within 2% of its
  tensor's largest moment. A max-pool or ReLU kink can flip under float
  error inside a minibatch (seen here in cycle 2: 0.3% of the largest
  gradient of one conv), and the update's later steps carry that through
  the net; a moment that was reset or not carried would be off by tens of
  percent in most elements
  (the port computes it in float64 on the host, optax in float32);
- free-running: each side keeps its own parameters and moments. The
  per-cycle drift is printed. Every action agrees in every cycle; counts,
  steps and the LR as above; the parameters within the Adam step bound
  over all the steps so far (2 * lr * 8 per cycle), median below 1e-6.
  Rollout values, returns, the RMS state and losses within 1e-3 absolute:
  after cycle 2's kink a few parameters differ by up to 1.2e-3 and the
  values follow (5e-4 at cycle 4 here), while a fault in the carried state
  (the RMS, the LR, Adam's count) would move rewards and returns by whole
  percent.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grid_rl import (GOAL_SAMPLES, TOL, N, T, _configs,
                                _host_render_for_jax, _jax_collect_draws,
                                _jax_policy, _port_nets, _t)
from var_tpu.data.audio_store import AudioStore as JAudioStore
from var_tpu.envs import grid_sim_device as jdev
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import GridDeviceSimEngine as JGridEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu_torch.convert import ai2thor_policy_state_dict
from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs import grid_sim_device as tdev
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import GridDeviceSimEngine, init_rms

K = 5
EPOCHS, MINIBATCHES = 4, 2
OPT_STEPS = EPOCHS * MINIBATCHES
CHAIN = dict(ppoEpoch=EPOCHS, ppoNumMiniBatch=MINIBATCHES,
             RLLrDecay="linear", RLTotalSteps=K * T * N, RLLr=7e-4)
MOMENT_MEDIAN_RTOL, MOMENT_SCALE = 1e-2, 0.02
FREE_ROLLOUT_ATOL = 1e-3


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
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")


@pytest.fixture(scope="module")
def chain():
    """The JAX grid engine and PPO learner, the port's twins from the same
    weights and audio (the port's goal bank is JAX's, as in
    tests/test_torch_grid_rl.py), and JAX's initial policy parameters."""
    patch = pytest.MonkeyPatch()
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        jcfg, tcfg = _configs(**CHAIN)
        var_model = build_pretext_model(jcfg)
        var_params = jax.jit(lambda key: init_pretext_params(
            var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
        jpol, policy_params = _jax_policy(jcfg, 1)
        build_bank = JGridEngine._build_goal_bank
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
    teng.goal_bank = _t(jeng.goal_bank)
    jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
    yield jcfg, tcfg, jeng, teng, jp, policy_params
    patch.undo()


def _np(x):
    """A copy: the engine's batch views buffers the next collect rewrites,
    and Adam's moments change in place."""
    return np.array(x.detach().numpy() if isinstance(x, torch.Tensor)
                    else x)


def _to_port(tree):
    return ai2thor_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            tree))


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
        kc, ku = jax.random.split(jax.random.PRNGKey(100 + c))
        jrms, jbatch, jstats = jeng.collect(jrms, jstate.params, kc)
        trms, tbatch, tstats = teng.collect(trms,
                                            _jax_collect_draws(kc, teng.bank))
        rec = {"cycle": c,
               "actions_equal": bool(np.array_equal(
                   _np(tbatch["actions"]), np.asarray(jbatch["actions"]))),
               "pixels_equal": bool(np.array_equal(
                   _np(tbatch["obs"]["image"]),
                   np.asarray(jbatch["obs"]["image"]))),
               "occupancy_equal": bool(np.array_equal(
                   _np(tbatch["obs"]["occupancy"]),
                   np.asarray(jbatch["obs"]["occupancy"])))}
        rollout = [(name, _np(tbatch[name]), np.asarray(jbatch[name]))
                   for name in ("value_preds", "returns", "old_log_probs")]
        rollout += [("raw_sums", _np(tstats), np.asarray(jstats))]
        rollout += [(f"rms.{f}", _np(g), np.asarray(w))
                    for f, g, w in zip(trms._fields, trms, jrms)]
        rec["rollout"] = rollout

        perms = _perms(ku)
        jstate, jm = jp.update(jstate, jbatch, ku)
        tstate, tm = port.update(tstate, tbatch, perms)
        rec["metrics"] = [(k, _np(v), np.asarray(jm[k])) for k, v in
                          tm.items()]
        want = _to_port(jstate.params)
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
        records.append(rec)
        rec["rollout_err"] = max(float(np.abs(g - w).max())
                                 for _, g, w in rollout + rec["metrics"])
        print(f"{'teacher' if teacher else 'free'} cycle {c}: rollout "
              f"{rec['rollout_err']:.3e}, params max "
              f"{rec['param_max']:.3e} median {rec['param_median']:.3e}, "
              f"actions equal {rec['actions_equal']}, lr {rec['lr'][0]:.6g}")
    return records


def _assert_carried(rec, c):
    assert rec["adam_count"] == ((c + 1) * OPT_STEPS,) * 2
    assert rec["sched_count"] == (c + 1) * OPT_STEPS
    assert rec["step"] == (c + 1, c + 1)
    np.testing.assert_allclose(*rec["lr"], rtol=1e-6)


def _assert_cycle(rec):
    assert rec["actions_equal"] and rec["pixels_equal"]
    assert rec["occupancy_equal"]
    for name, got, want in rec["rollout"] + rec["metrics"]:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    assert rec["param_max"] <= rec["param_bound"]
    assert rec["param_median"] < 1e-6
    for name, got, want in rec["moments"]:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, err_msg=name, rtol=0,
                                   atol=MOMENT_SCALE * scale)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        assert np.median(rel) < MOMENT_MEDIAN_RTOL, name


def test_teacher_forced_cycles_match_jax(chain):
    records = _run_chain(chain, teacher=True)
    lrs = [r["lr"][0] for r in records]
    assert lrs[0] == CHAIN["RLLr"] and lrs[-1] < lrs[1] < lrs[0]
    for c, rec in enumerate(records):
        _assert_carried(rec, c)
        _assert_cycle(rec)


def test_free_running_cycles_match_jax(chain):
    records = _run_chain(chain, teacher=False)
    for c, rec in enumerate(records):
        _assert_carried(rec, c)
        assert rec["actions_equal"] and rec["pixels_equal"]
        assert rec["occupancy_equal"]
        assert rec["param_max"] <= rec["param_bound"]
        assert rec["param_median"] < 1e-6
        assert rec["rollout_err"] < FREE_ROLLOUT_ATOL

