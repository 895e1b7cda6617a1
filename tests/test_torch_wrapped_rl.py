"""The reward-wrapper RL path (fusedRollout=False) against the JAX package on
the CPU: ops/running_stats.py, the vec-env wrappers (envs/vec/base.py,
envs/vec/wrappers.py), rl/reward.py::VecVARReward, rl/storage.py::
RolloutStorage, and train/rl.py's _train_wrapped and wrapped testRL.
Reduced sizes: N = 2 envs, T = 6 steps, GRU 32, GRU input 16, 2 PPO epochs
x 2 minibatches; 4 synthetic clips per class.

Tolerances:
- the return normaliser and the numpy wrappers: equal (the same float64
  numpy arithmetic in both packages);
- images and occupancy crops from the host sims, success bits, goal counts
  and the eval's commanded classes: equal;
- VAR features, rewards, the normaliser's state, values, log-probs,
  actions, returns and losses at rtol = atol = 1e-4 (IEEE float32 both
  sides, only the order of summation differs);
- parameters after the PPO update within 2 * lr per optimizer step + 5e-5,
  median below 1e-6 (tests/test_torch_ppo.py states why).
JAX draws its action noise and permutations from its own key chain; the
port is handed the same draws, re-made from that chain
(var_tpu/train/rl.py _train_wrapped: one split per env step, one for the
update).
"""
import copy
import csv
import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.envs import spaces as jspaces
from var_tpu.envs.vec import base as jbase
from var_tpu.envs.vec import wrappers as jwrappers
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.ops import running_stats as jrs
from var_tpu.rl import storage as jstorage
from var_tpu.rl.reward import VecVARReward as JVecVARReward
from var_tpu.train import rl as jrl
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import arm_policy_state_dict, arm_state_dict
from var_tpu_torch.envs import spaces as tspaces
from var_tpu_torch.envs.vec import base as tbase
from var_tpu_torch.envs.vec import wrappers as twrappers
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.ops import running_stats as trs
from var_tpu_torch.rl import storage as tstorage
from var_tpu_torch.rl.reward import VecVARReward
from var_tpu_torch.train import rl as trl
from var_tpu_torch.train.checkpoint import save_checkpoint

TOL = dict(rtol=1e-4, atol=1e-4)
T, N = 6, 2
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T, ppoEpoch=2,
             ppoNumMiniBatch=2, RLRecurrentSize=32, RLRecurrentInputSize=16,
             vecEnvBackend="dummy", fusedRollout=False, RLTrain=True,
             RLLogInterval=1, RLModelSaveInterval=1)


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


def _configs(tmp_path=None, **extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="arms")
        knobs = {**SMALL, **extra}
        if tmp_path is not None:
            knobs["RLModelSaveDir"] = str(tmp_path / mod.__name__)
        cfg.override(**knobs)
        mod.gym_register(cfg, env="arms")
        out.append(cfg)
    return out


# -- running stats and the numpy wrappers -------------------------------------


def test_running_stats_match_jax():
    rng = np.random.RandomState(0)
    js, ts = jrs.RunningMeanStd.create((3,)), trs.RunningMeanStd.create((3,))
    jn, tn = (m.ReturnNormalizer.create(4, 0.9) for m in (jrs, trs))
    for _ in range(20):
        batch = rng.randn(7, 3) * 5 + 2
        js, ts = jrs.rms_update(js, batch), trs.rms_update(ts, batch)
        rews, news = rng.randn(4) * 3, rng.rand(4) < 0.3
        jn, jout = jrs.normalize_rewards(jn, rews, news)
        tn, tout = trs.normalize_rewards(tn, rews, news)
        np.testing.assert_array_equal(tout, jout)
    for got, want in zip(ts, js):
        np.testing.assert_array_equal(got, want)
    for got, want in ((tn.rms, jn.rms), (tn.ret, jn.ret)):
        for g, w in zip(np.atleast_1d(got), np.atleast_1d(want)):
            np.testing.assert_array_equal(g, w)


class _Fake:
    """A VecEnv over random observations (a flat Box, or a dict of two),
    built on either package's base class and spaces."""

    def __new__(cls, base, spaces, dict_obs, seed):
        class Fake(base.VecEnv):
            def __init__(self):
                box = spaces.Box(-np.ones((2, 3)), np.ones((2, 3)),
                                 dtype=np.float32)
                obs_space = (spaces.DictSpace({"a": box, "b": box})
                             if dict_obs else box)
                super().__init__(3, obs_space, spaces.Discrete(2))
                self.rng = np.random.RandomState(seed)

            def _obs(self):
                o = self.rng.randn(3, 2, 3).astype(np.float32)
                return OrderedDict(a=o, b=-o) if dict_obs else o

            def reset(self):
                return self._obs()

            def step_async(self, actions):
                pass

            def step_wait(self):
                return (self._obs(), self.rng.randn(3).astype(np.float32),
                        self.rng.rand(3) < 0.3, ({},) * 3)

            def get_images(self):
                return [np.full((4, 5, 3), i, np.uint8) for i in range(3)]

        return Fake()


@pytest.mark.parametrize("wrapper", ["normalize", "frame_stack", "extract"])
def test_vec_wrappers_match_jax(wrapper):
    outs = []
    for base, spaces, mod in ((jbase, jspaces, jwrappers),
                              (tbase, tspaces, twrappers)):
        venv = _Fake(base, spaces, wrapper == "extract", 1)
        env = {"normalize": lambda v: mod.VecNormalize(v, gamma=0.9),
               "frame_stack": lambda v: mod.VecFrameStack(v, 2),
               "extract": lambda v: mod.VecExtractDictObs(v, "b")}[wrapper](
                   venv)
        seq = [env.reset()]
        for _ in range(6):
            seq.append(env.step(np.zeros(3)))
        seq.append(env.render())
        seq.append(env.unwrapped is venv and env.num_envs == 3)
        outs.append(seq)
    jseq, tseq = outs
    for j, t in zip(jseq, tseq):
        if isinstance(j, tuple):
            for a, b in zip(j[:3], t[:3]):
                np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_array_equal(t, j)
    assert tseq[-2].shape == (8, 10, 3)  # tile_images: 2 x 2 tiles of 4 x 5


# -- the VAR reward wrapper, the storage and one PPO update -------------------


@pytest.fixture(scope="module")
def nets():
    """One JAX arm VAR with its port twin, and JAX's initial policy
    parameters for the wrapped obs (Flax's init depends only on the key and
    the shapes)."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    var_model = build_pretext_model(jcfg)
    var_params = jax.jit(lambda key: init_pretext_params(
        var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
    tvar = VARPretextNet(3)
    tvar.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, var_params)))
    tvar.eval().requires_grad_(False)
    jpol = jpolicy.build_policy(jcfg, jspaces.Box(-np.ones(2), np.ones(2)))
    obs = {"robot_pose": jnp.zeros((N, 2)),
           "goal_sound_feat": jnp.zeros((N, 3)),
           "image": jnp.zeros((N, 3, 96, 96)), "image_feat": jnp.zeros((N, 3))}
    policy_params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(jcfg.RLEnvSeed), obs, jnp.zeros((N, 32)),
        jnp.ones((N, 1)), 1)["params"]
    return var_model, var_params, tvar, policy_params


def test_var_reward_wrapper_matches_jax(nets):
    """VecVARReward over the same host sims and actions: the policy's
    observation dict, the normalised and the raw rewards, the goal cache
    and the return normaliser, step by step over two episodes."""
    var_model, var_params, tvar, _ = nets
    jcfg, tcfg = _configs()
    from var_tpu.envs.vec.factory import make_vec_envs as jmake

    jenv = jmake(jcfg.RLEnvName, jcfg.RLEnvSeed, N, 0.99, False, jcfg,
                 pretext_model=var_model, pretext_params=var_params)
    tenv = make_vec_envs(tcfg.RLEnvName, tcfg.RLEnvSeed, N, 0.99, False,
                         tcfg, pretext_model=tvar)
    assert isinstance(jenv, JVecVARReward) and isinstance(tenv, VecVARReward)
    rng = np.random.RandomState(0)
    pairs = [(tenv.reset(), jenv.reset())]
    for _ in range(2 * T):
        a = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        to, tr, td, _ = tenv.step(a)
        jo, jr, jd, _ = jenv.step(a)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_allclose(tr, jr, **TOL)
        np.testing.assert_allclose(tenv.origStepReward, jenv.origStepReward,
                                   **TOL)
        pairs.append((to, jo))
    for to, jo in pairs:
        assert list(to) == list(jo)
        np.testing.assert_array_equal(to["image"], jo["image"])
        for k in ("robot_pose", "goal_sound_feat", "image_feat"):
            np.testing.assert_allclose(to[k], jo[k], err_msg=k, **TOL)
    np.testing.assert_allclose(tenv.cached_goal_feat, jenv.cached_goal_feat,
                               **TOL)
    for got, want in ((tenv.ret_norm.rms.mean, jenv.ret_norm.rms.mean),
                      (tenv.ret_norm.rms.var, jenv.ret_norm.rms.var),
                      (tenv.ret_norm.ret, jenv.ret_norm.ret)):
        np.testing.assert_allclose(got, want, **TOL)
    assert tenv.ret_norm.rms.count == jenv.ret_norm.rms.count
    tenv.close()
    jenv.close()


def test_rollout_storage_matches_jax():
    """insert over two rollouts, compute_returns (GAE and plain, with and
    without proper time limits), after_update, device_batch."""
    rng = np.random.RandomState(3)
    box = {"x": (5,), "img": (2, 4, 4)}
    stores = [mod.RolloutStorage(
        T, N, sp.DictSpace({k: sp.Box(-np.inf, np.inf, shape=s,
                                      dtype=np.float32)
                            for k, s in box.items()}),
        sp.Box(-np.ones(2), np.ones(2)), 8,
        type("C", (), {"RLObsIgnore": {"x"}})())
        for mod, sp in ((jstorage, jspaces), (tstorage, tspaces))]
    for use_gae, proper in ((True, False), (False, True)):
        for s in stores:
            s.set_first_obs({k: np.ones((N,) + v) for k, v in box.items()})
        for _ in range(T):
            args = ({k: rng.randn(N, *v) for k, v in box.items()},
                    rng.randn(N, 8), rng.randn(N, 2), rng.randn(N, 1),
                    rng.randn(N, 1), rng.randn(N), (rng.rand(N, 1) > 0.2),
                    (rng.rand(N, 1) > 0.2))
            for s in stores:
                s.insert(*copy.deepcopy(args))
        nv = rng.randn(N, 1)
        for s in stores:
            s.compute_returns(nv, use_gae, 0.99, 0.95, proper)
        jb, tb = stores[0].device_batch(), stores[1].device_batch()
        assert list(tb["obs"]) == list(jb["obs"]) == ["img"]
        for k in ("rnn_hx0", "actions", "value_preds", "returns", "masks",
                  "old_log_probs"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       err_msg=k, **TOL)
        for s in stores:
            s.after_update()
        np.testing.assert_array_equal(stores[1].obs["img"],
                                      stores[0].obs["img"])


def _snapshot(monkeypatch, cls, into):
    after = cls.after_update

    def spy(self):
        into.append(copy.deepcopy({
            "obs": dict(self.obs), "actions": self.actions,
            "log_probs": self.action_log_probs, "values": self.value_preds,
            "rewards": self.rewards, "returns": self.returns,
            "masks": self.masks, "hx": self.recurrent_hidden_states}))
        return after(self)

    monkeypatch.setattr(cls, "after_update", spy)


def test_one_rollout_and_update_match_jax(nets, tmp_path, monkeypatch):
    """_train_wrapped for one PPO update in the JAX package, and the port's
    setup_wrapped / rollout_wrapped / update_wrapped from the same initial
    weights and with JAX's draws."""
    var_model, var_params, tvar, policy_params = nets
    jcfg, tcfg = _configs(tmp_path)
    jrec, trec = [], []
    _snapshot(monkeypatch, jstorage.RolloutStorage, jrec)
    _snapshot(monkeypatch, tstorage.RolloutStorage, trec)

    jtr = jrl.RLTrainer(jcfg, env="arms")
    jtr.pretext_params = var_params
    jstate = jtr.trainRL(total_steps=T * N)

    # JAX's draws: a key split per env step (the Gaussian's eps), one for
    # the update's permutations
    rng, noise = jax.random.PRNGKey(jcfg.RLEnvSeed), []
    for _ in range(T):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (N, 2)))))
    rng, k = jax.random.split(rng)
    perms = []
    for _ in range(jcfg.ppoEpoch):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))

    init = tmp_path / "init"
    save_checkpoint(str(init), {"params": arm_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, policy_params))})
    tcfg.override(RLModelFineTune=True, RLModelLoadDir=str(init))
    ttr = trl.RLTrainer(tcfg, env="arms", device="cpu")
    ttr.pretext_model = tvar
    envs, rollouts = ttr.setup_wrapped()
    ttr.rollout_wrapped(envs, rollouts, noise=torch.stack(noise))
    metrics = ttr.update_wrapped(rollouts, torch.from_numpy(
        np.stack(perms)).long())
    envs.close()

    (j,), (t,) = jrec, trec
    for k in j["obs"]:
        np.testing.assert_allclose(t["obs"][k], j["obs"][k], err_msg=k,
                                   **TOL)
    for k in ("actions", "log_probs", "values", "rewards", "returns",
              "masks", "hx"):
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **TOL)
    want = arm_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
    diffs = torch.cat([(ttr.state.params[k].detach() - v).abs().ravel()
                       for k, v in want.items()])
    assert diffs.max().item() <= 2 * tcfg.RLLr * 4 + 5e-5
    assert diffs.median().item() < 1e-6
    assert ttr.state.step == int(jstate.step) == 1
    assert ttr.state.opt_state.count == 4
    assert all(np.isfinite(v) for v in metrics.values())


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_wrapped_eval_csv_matches_fused_eval(nets, tmp_path):
    """The port's wrapped testRL and its fused testRL score the same
    checkpoint on the same host sims: the same episodes, commanded
    classes, goal counts and results; rewards at 1e-4."""
    _, _, tvar, policy_params = nets
    ckpt = tmp_path / "policy"
    save_checkpoint(str(ckpt), {"params": arm_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, policy_params))})
    one = {"dataset": ["GoogleCommand"],
           "max_sound_dur": {"GoogleCommand": 6.0},
           "items": {"GoogleCommand": ["zero", "one", "two", "three"]},
           "size": {"GoogleCommand": [1, 1, 1, 1]}, "train_test": "train"}
    out = {}
    for fused in (True, False):
        _, tcfg = _configs(RLTrain=False, fusedRollout=fused, soundSource=one,
                           RLModelSaveDir=str(tmp_path))
        tr = trl.RLTrainer(tcfg, env="arms", device="cpu")
        tr.pretext_model = tvar
        rate = tr.testRL(policy_path=str(ckpt), num_envs=N)
        out[fused] = rate, _read_csv(str(tmp_path / "test_policy.csv"))
    (frate, (fhead, frows)), (wrate, (whead, wrows)) = out[True], out[False]
    assert fhead == whead == ["objIdx", "goal area count", "rewards",
                              "results"]
    assert wrate == frate and len(wrows) == len(frows) == 4 * N
    for w, f in zip(wrows, frows):
        assert (w[0], w[1], w[3]) == (f[0], f[1], f[3])
        np.testing.assert_allclose(float(w[2]), float(f[2]), **TOL)


def test_wrapped_card_check_rehearses_on_the_cpu():
    """chip_smoke.py phase 23's comparison with the CPU in the card's
    place: every comparison runs; the update is exact, and the per-step
    errors stay under 1% of the tolerance (the stored image is uint8 / 255
    in float32, which the wrapper's VAR saw as uint8 * (1 / 255): the two
    differ in the last bit)."""
    from var_tpu_torch.tools.rl_check import wrapped_card_against_cpu

    _, tcfg = _configs()
    report = wrapped_card_against_cpu(tcfg, card="cpu")
    assert report["ok"] and report["param_max_diff"] == 0.0
    assert report["losses"] == 0.0
    assert max(report[k] for k in ("actions", "log_probs", "values", "hx",
                                   "image_feat")) < 0.01
