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

import var_tpu.config as jconfig
from test_torch_device_sim import (EDGE_MARGIN, TOL, N, T, _configs,
                                   _jax_collect_draws, _pixel_margin)
from var_tpu.envs.spaces import Box as JBox
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import DeviceSimEngine as JEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu_torch import config as tconfig
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
    return jcfg, tcfg, jeng, teng, jp, policy_params, {}


def _perms(key):
    """The env permutations var_tpu's PPO.update draws from `key`."""
    perms, k = [], key
    for _ in range(EPOCHS):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))
    return torch.from_numpy(np.stack(perms)).long()


def _jax_cycles(chain):
    """JAX's side of the K cycles, the same in both forms, made once per
    module: per cycle the state before it, the collect's outputs, the
    port's copy of its draws, the update's permutations and metrics."""
    _, _, jeng, teng, jp, policy_params, made = chain
    if not made:
        jstate = jp.init_state(
            jax.tree_util.tree_map(jnp.array, policy_params))
        jrms = jinit_rms(N)
        made["cycles"] = []

        def copy(tree):  # the collect and the update donate their buffers
            return jax.tree_util.tree_map(jnp.array, tree)

        for c in range(K):
            kc, ku = jax.random.split(jax.random.PRNGKey(KEY_BASE + c))
            before = copy(jstate)
            jrms, jbatch, jstats = jeng.collect(jrms, jstate.params, kc)
            rms = copy(jrms)
            jstate, jm = jp.update(jstate, jbatch, ku)
            made["cycles"].append(dict(
                before=before, after=copy(jstate), rms=rms, batch=jbatch,
                stats=jstats, metrics=jm, perms=_perms(ku),
                draws=_jax_collect_draws(kc, teng.k)))
    return made["cycles"]


def _run_chain(chain, teacher: bool):
    """K cycles on both sides; returns one record per cycle."""
    jcfg, tcfg, jeng, teng, jp, policy_params, _ = chain
    tpol = teng.policy
    tpol.load_state_dict(_to_port(policy_params))
    port = tppo.PPO(tpol, tppo.PPOConfig.from_config(tcfg))
    tstate = port.init_state()
    trms = init_rms(N)
    lr_max = 2 * tcfg.RLLr * OPT_STEPS
    records = []
    for c, cycle in enumerate(_jax_cycles(chain)):
        jstate, jrms = cycle["before"], cycle["rms"]
        jbatch, jstats, draws = cycle["batch"], cycle["stats"], cycle["draws"]
        if teacher:
            tpol.load_state_dict(_to_port(jstate.params))
            adam = jstate.opt_state[1]
            with torch.no_grad():
                for mine, theirs in ((tstate.opt_state.mu, adam.mu),
                                     (tstate.opt_state.nu, adam.nu)):
                    for k, v in _to_port(theirs).items():
                        mine[k].copy_(v)
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

        jstate, jm = cycle["after"], cycle["metrics"]
        tstate, tm = port.update(tstate, tbatch, cycle["perms"])
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


# -- JAX's arm draws, for runs outside the tests -----------------------------------
#
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_arm_chain.py \
#         draws OUT_DIR [--var-key 453] [--policy-key 40]
#
# writes JAX's initial draws of the arm recipe (representationDim=8, the
# policy at full width: GRU 512, input 128) converted for the port, as
# checkpoint directories: OUT_DIR/jax_var_<k>, the VAR that
# var_tpu/train/pretext.py draws at PRNGKey(pretextEnvSeed) (453 by
# default), and OUT_DIR/jax_policy_<k>, the policy that the device-sim
# path of var_tpu/train/rl.py draws at PRNGKey(RLEnvSeed) (40 by default),
# the arm's pose among its inputs. The port's own knobs start a run from
# them: copied to WORK/var_model/79, the VAR checkpoint e2e_run's arm
# recipe loads, with --set pretextModelFineTune=True, the VAR trains from
# JAX's draw (and its last epoch is saved over it); --set
# RLModelFineTune=True RLModelLoadDir=OUT_DIR/jax_policy_<k> starts PPO
# from JAX's policy draw (parameters only: Adam starts fresh, as from
# scratch).

ARM_RECIPE = dict(representationDim=D, RLNumEnvs=64, RLDeviceSimRollout=True)


def _arm_recipe_configs(**extra):
    """(JAX config, port config) at the arm recipe's knobs, full width."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="arms")
        cfg.override(**{**ARM_RECIPE, **extra})
        mod.gym_register(cfg, env="arms")
        out.append(cfg)
    return out


_ARM_DRAWS = {}  # JAX's arm draws, made once per key in this module


def _jax_arm_var_draw(jcfg, var_key):
    """JAX's arm VAR variables from PRNGKey(var_key), as
    var_tpu/train/pretext.py draws them at PRNGKey(pretextEnvSeed)."""
    key = ("var", var_key)
    if key not in _ARM_DRAWS:
        model = build_pretext_model(jcfg)
        _ARM_DRAWS[key] = jax.jit(lambda k: init_pretext_params(
            model, jcfg, k))(jax.random.PRNGKey(var_key))
    return _ARM_DRAWS[key]


def _jax_arm_policy_draws(jcfg, ns):
    """JAX's arm policy parameters as the device-sim path draws them
    (var_tpu/train/rl.py: PRNGKey(RLEnvSeed), the dummy observations of a
    batch of n envs), once for each n of `ns`, in one program."""
    key = ("policy", int(jcfg.RLEnvSeed), tuple(ns))
    if key not in _ARM_DRAWS:
        high = np.ones(jcfg.RLActionDim, np.float32)
        jpol = jpolicy.build_policy(jcfg, JBox(-high, high,
                                               dtype=np.float32))
        d = jcfg.representationDim

        def draw(rng, n):
            obs = {"goal_sound_feat": jnp.zeros((n, d)),
                   "image": jnp.zeros((n,) + tuple(jcfg.img_dim), jnp.uint8),
                   "image_feat": jnp.zeros((n, d)),
                   "robot_pose": jnp.zeros((n, jcfg.robotStateDim))}
            return jpol.init(rng, obs, jnp.zeros(
                (n, jpol.recurrent_hidden_state_size)), jnp.ones((n, 1)),
                1)["params"]

        _ARM_DRAWS[key] = jax.jit(lambda rng: [draw(rng, n) for n in ns])(
            jax.random.PRNGKey(jcfg.RLEnvSeed))
    return _ARM_DRAWS[key]


def write_jax_arm_draws(out_dir, var_key=453, policy_key=40, n=64):
    """JAX's initial draws of the arm VAR and of the arm policy,
    converted, as the port's checkpoint directories (see the comment
    above). The policy written is the one initialised on a batch of `n`
    envs; it is drawn beside the recipe's 64 and must equal it (flax's
    parameters do not depend on the batch)."""
    from var_tpu_torch.train.checkpoint import save_checkpoint

    jcfg, _ = _arm_recipe_configs(RLEnvSeed=policy_key,
                                  pretextEnvSeed=var_key)
    var = _jax_arm_var_draw(jcfg, var_key)["params"]
    var_dir = os.path.join(out_dir, f"jax_var_{var_key}")
    save_checkpoint(var_dir, {"params": arm_state_dict(
        jax.tree_util.tree_map(np.asarray, var))})
    mine, recipe = _jax_arm_policy_draws(jcfg, (n, 64))
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(mine)[0],
            jax.tree_util.tree_leaves(recipe)):
        assert np.array_equal(np.asarray(got), np.asarray(want)), path
    policy_dir = os.path.join(out_dir, f"jax_policy_{policy_key}")
    save_checkpoint(policy_dir, {"params": _to_port(mine)})
    return var_dir, policy_dir


def test_jax_arm_draws_start_the_port_through_its_knobs(tmp_path):
    """The written draws load through the port's own fine-tune knobs and
    equal JAX's draws: the VAR's forward pass at 1e-4 (IEEE float32 both
    sides), the policy's parameters exactly, and the policy draw made on
    2 envs equals the one made on the recipe's 64."""
    from var_tpu_torch.train.checkpoint import load_checkpoint
    from var_tpu_torch.train.pretext import PretextTrainer

    var_dir, policy_dir = write_jax_arm_draws(str(tmp_path), 3, 5, n=2)
    jcfg, tcfg = _arm_recipe_configs(
        RLEnvSeed=5, pretextModelFineTune=True, pretextModelLoadDir=var_dir,
        RLModelFineTune=True, RLModelLoadDir=policy_dir)
    tvar = PretextTrainer(tcfg, device="cpu").loadPretextModel().eval()
    jmodel = build_pretext_model(jcfg)
    jvars = _jax_arm_var_draw(jcfg, 3)
    rng = np.random.RandomState(0)
    img = rng.rand(2, *jcfg.img_dim).astype(np.float32)
    snd = rng.randn(2, *jcfg.sound_dim).astype(np.float32)
    for method, x in (("encode_image", img), ("encode_sound", snd)):
        want = jmodel.apply(jvars, jnp.asarray(x),
                            method=getattr(jmodel, method))[1]
        with torch.no_grad():
            got = getattr(tvar, method)(torch.from_numpy(x))[1]
        assert got.shape == (2, D)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   err_msg=method, **TOL)
    high = np.ones(tcfg.RLActionDim, np.float32)
    tpol = build_policy(tcfg, Box(-high, high))
    got = load_checkpoint(tcfg.RLModelLoadDir)["params"]
    tpol.load_state_dict(got)  # the port's policy at the recipe's knobs
    want = _to_port(_jax_arm_policy_draws(jcfg, (2, 64))[1])
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# -- F6: where the arm recipe's policy takes a class it never learns ---------------
#
#     PYTHONPATH=. python tests/test_torch_arm_chain.py \
#         classes VAR_DIR POLICY_DIR [--envs 32] [--layouts 6]
#
# on the CPU, for the arm recipe's VAR checkpoint (e2e_run's
# WORK/var_model/79) and a policy checkpoint of the same run: how far apart
# the device sim's goal bank puts the classes (the cosines of each
# class's mean goal embedding), how often a goal's reward peak over the
# gripper's (x, y) grid lies in its own class's hit box (tools/var_probe's
# probe_2d with the bank's goals in place of fresh draws), then --envs
# evaluation episodes a class on the device sim with the policy, and where
# its gripper ends: the object hit at the last step (-1 for none), the mean
# final pose and its spread, the distance to the commanded object, the
# mean raw reward.


def class_report(var_dir, policy_dir, envs=32, layouts=6, seed=11):
    from var_tpu_torch.envs.spaces import Box as TBox
    from var_tpu_torch.tools.var_probe import _env, _image_feats, load_var
    from var_tpu_torch.train.checkpoint import load_checkpoint

    cfg, model = load_var("arms", var_dir, [
        f"representationDim={D}", f"RLNumEnvs={envs}",
        "RLDeviceSimRollout=True"], "cpu")
    pol = build_policy(cfg, TBox(-np.ones(2), np.ones(2)))
    pol.load_state_dict(load_checkpoint(policy_dir)["params"])
    eng = DeviceSimEngine(model, pol.eval(), cfg, cfg.RLEnvMaxSteps, envs,
                          generator=torch.Generator().manual_seed(1))
    bank = eng.goal_bank.numpy()  # (taskNum, clips, D)
    means = bank.mean(1)
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    print("cosines of the classes' mean goal embeddings:")
    print(np.round(means @ means.T, 3))
    env = _env(cfg, seed)
    xs = np.linspace(cfg.xMin, cfg.xMax, 21)
    ys = np.linspace(cfg.yMin, cfg.yMax, 41)
    goals = bank[:, ::max(1, bank.shape[1] // 8)]
    in_box = np.zeros(cfg.taskNum)
    for _ in range(layouts):
        env._randomize()
        imgs = []
        for x in xs:
            for y in ys:
                env.ee = np.array([x, y])
                imgs.append(env.get_image().transpose(2, 0, 1))
        feats = _image_feats(model, imgs, "cpu")
        for c in range(cfg.taskNum):
            for g in goals[c]:
                i, j = np.unravel_index((feats @ g).argmax(),
                                        (len(xs), len(ys)))
                env.ee = np.array([xs[i], ys[j]])
                hit = env.ray_test()
                in_box[c] += hit >= 0 and env.objOrder[hit] == c
    print("goals whose reward peak lies in their class's hit box:",
          np.round(in_box / (layouts * goals.shape[1]), 3).tolist())
    for c in range(cfg.taskNum):
        draws = eng.draw_eval()
        with torch.no_grad():
            success, _, raw = eng.eval_batch(
                torch.full((envs,), c, dtype=torch.long), draws)
        obj_pose, obj_order, ee = tsim.reset_from_draws(draws.reset, eng.k)
        for t in range(eng.T):
            ee = tsim.apply_action(ee, eng.eval_actions[t].float(), eng.k)
        hit = tsim.ray_test(obj_pose, ee)
        hit_class = torch.where(hit >= 0, torch.gather(
            obj_order, 1, hit.clamp(min=0).long()[:, None])[:, 0], -1)
        target = torch.stack([obj_pose[i, (obj_order[i] == c).nonzero()[0, 0],
                                       :2] for i in range(envs)])
        print(f"class {c}: success {success.float().mean():.3f}; the object "
              "hit at the end (-1, 0, 1, 2, 3): "
              f"{np.bincount(hit_class.numpy() + 1, minlength=5).tolist()}; "
              f"final pose {ee.mean(0).double().numpy().round(3).tolist()}"
              f" ± {ee.std(0).double().numpy().round(3).tolist()}, "
              f"{float((ee - target).norm(dim=1).mean()):.3f} m from the "
              f"object; raw reward {float(raw.mean()):.2f}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    draws = sub.add_parser("draws")
    draws.add_argument("out_dir")
    draws.add_argument("--var-key", type=int, default=453)
    draws.add_argument("--policy-key", type=int, default=40)
    classes = sub.add_parser("classes")
    classes.add_argument("var_dir")
    classes.add_argument("policy_dir")
    classes.add_argument("--envs", type=int, default=32)
    classes.add_argument("--layouts", type=int, default=6)
    a = ap.parse_args()
    if a.command == "draws":
        print(*write_jax_arm_draws(a.out_dir, a.var_key, a.policy_key))
    else:
        class_report(a.var_dir, a.policy_dir, a.envs, a.layouts)
