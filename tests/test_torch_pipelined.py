"""RLPipelinedRollout, the one-step-stale fused rollout
(var_tpu/train/rl.py:324-377), against the JAX package on the CPU: two PPO
updates of _train_fused with the same draws, as tests/test_vec_rl.py's
test_pipelined_fused_rollout_training runs JAX's. Reduced widths: N = 2
envs, T = 6 steps a rollout, episodes of 3 steps, GRU 32, GRU input 16,
action hidden 32, 2 epochs x 2 minibatches.

JAX draws its action noise and permutations from its own key chain
(one split for the first action, one per env step, one per update); the
port is handed the same draws, re-made from that chain, and JAX's initial
policy parameters through a checkpoint.

Tolerances:
- the actions the sims receive, every env step of both rollouts, and the
  updates' losses at rtol = atol = 1e-4 (IEEE float32 both sides, another
  order of summation);
- the logged episode rewards at 1e-4 and their count equal: every
  dispatched step is read back exactly once (the loop's reads, one step
  late, and the drain at the rollout's end);
- parameters after the updates within 2 * lr per optimizer step + 5e-5,
  median below 1e-6 (tests/test_torch_ppo.py states why).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
import var_tpu.rl.rollout_device as jrd
from var_tpu.envs.vec.dummy import DummyVecEnv as JDummyVecEnv
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.train import rl as jrl
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import arm_policy_state_dict, arm_state_dict
from var_tpu_torch.envs.vec.dummy import DummyVecEnv as TDummyVecEnv
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.train import rl as trl
from var_tpu_torch.train.checkpoint import save_checkpoint

TOL = dict(rtol=1e-4, atol=1e-4)
N, T, UPDATES = 2, 6, 2
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=3, ppoNumSteps=T, ppoEpoch=2,
             ppoNumMiniBatch=2, RLRecurrentSize=32, RLRecurrentInputSize=16,
             RLActionHiddenSize=32, vecEnvBackend="dummy", fusedRollout=True,
             RLPipelinedRollout=True, RLTrain=True, RLLogInterval=1,
             RLModelSaveInterval=1, RLTotalSteps=UPDATES * T * N)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(tmp_path, **extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="arms")
        cfg.override(**{**SMALL, **extra,
                        "RLModelSaveDir": str(tmp_path / mod.__name__)})
        mod.gym_register(cfg, env="arms")
        out.append(cfg)
    return out


def _record(monkeypatch, cls, into):
    orig = cls.step_async

    def spy(self, actions):
        into.append(np.array(actions, np.float32))
        return orig(self, actions)

    monkeypatch.setattr(cls, "step_async", spy)


def _jax_draws(seed):
    """The draws var_tpu's _train_fused makes from PRNGKey(RLEnvSeed)."""
    rng = jax.random.PRNGKey(seed)

    def normal(key):
        return torch.from_numpy(np.array(jax.random.normal(key, (N, 2))))

    rng, sub = jax.random.split(rng)
    init, rollouts, perms = normal(sub), [], []
    for _ in range(UPDATES):
        noise = []
        for _ in range(T):
            rng, sub = jax.random.split(rng)
            noise.append(normal(sub))
        rollouts.append(torch.stack(noise))
        rng, k = jax.random.split(rng)
        p = []
        for _ in range(SMALL["ppoEpoch"]):
            k, sub = jax.random.split(k)
            p.append(np.asarray(jax.random.permutation(sub, N)))
        perms.append(torch.from_numpy(np.stack(p)).long())
    return init, rollouts, perms


def test_two_pipelined_updates_match_jax(tmp_path, monkeypatch):
    jcfg, tcfg = _configs(tmp_path)
    var_model = build_pretext_model(jcfg)
    var_params = jax.jit(lambda key: init_pretext_params(
        var_model, jcfg, key))(jax.random.PRNGKey(3))["params"]

    first, jmetrics, jepisodes = [], [], []

    class Engine(jrd.DeviceRolloutEngine):
        def set_policy_params(self, params):
            if not first:  # a host copy: the update donates the buffers
                first.append(jax.tree_util.tree_map(np.asarray, params))
            super().set_policy_params(params)

    update = jppo.PPO.update

    def spy_update(self, state, batch, key):
        state, m = update(self, state, batch, key)
        jmetrics.append({k: float(v) for k, v in m.items()})
        return state, m

    monkeypatch.setattr(jrd, "DeviceRolloutEngine", Engine)
    monkeypatch.setattr(jppo.PPO, "update", spy_update)
    jactions, tactions = [], []
    _record(monkeypatch, JDummyVecEnv, jactions)
    jtr = jrl.RLTrainer(jcfg, env="arms")
    jtr.pretext_params = var_params
    with pytest.warns(UserWarning, match="one-step action delay"):
        jstate = jtr.trainRL()

    init_noise, noise, perms = _jax_draws(jcfg.RLEnvSeed)
    init = tmp_path / "init"
    save_checkpoint(str(init), {"params": arm_policy_state_dict(first[0])})
    tcfg.override(RLModelFineTune=True, RLModelLoadDir=str(init))
    _record(monkeypatch, TDummyVecEnv, tactions)
    ttr = trl.RLTrainer(tcfg, env="arms", device="cpu")
    ttr.pretext_model = VARPretextNet(3)
    ttr.pretext_model.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, var_params)))
    ttr.pretext_model.eval().requires_grad_(False)
    envs, engine, action = ttr.setup_fused(init_noise)
    tmetrics = []
    for j in range(UPDATES):
        action = ttr.rollout(envs, engine, action, pipelined=True,
                             noise=noise[j])
        tmetrics.append(ttr.update(engine, perms[j]))
    envs.close()

    # the sims step with the reset action twice (steps 0 of each rollout
    # keep the action they were given), then one step late
    assert len(tactions) == len(jactions) == UPDATES * T
    for got, want in zip(tactions, jactions):
        np.testing.assert_allclose(got, want, **TOL)
    assert len(tmetrics) == len(jmetrics) == UPDATES
    for got, want in zip(tmetrics, jmetrics):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # 2 envs x 2 episodes a rollout, each read back once; the deque keeps
    # the last 10
    assert len(ttr.episode_rewards) == UPDATES * 2 * N
    want = arm_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
    diffs = torch.cat([(ttr.state.params[k].detach() - v).abs().ravel()
                       for k, v in want.items()])
    steps = UPDATES * SMALL["ppoEpoch"] * SMALL["ppoNumMiniBatch"]
    assert diffs.max().item() <= 2 * tcfg.RLLr * steps + 5e-5
    assert diffs.median().item() < 1e-6
    assert ttr.state.step == int(jstate.step) == UPDATES


def test_pipelined_training_through_train_rl(tmp_path):
    """trainRL takes the pipelined protocol on the fused path: the warning,
    every update's checkpoint and progress row."""
    _, tcfg = _configs(tmp_path)
    ttr = trl.RLTrainer(tcfg, env="arms", device="cpu")
    ttr.pretext_model = VARPretextNet(3).reset_parameters(
        torch.Generator().manual_seed(0)).eval().requires_grad_(False)
    with pytest.warns(UserWarning, match="one-step action delay"):
        ttr.trainRL()
    assert len(ttr.update_stats) == UPDATES
    assert sorted(os.listdir(tcfg.RLModelSaveDir)) == [
        "00000", "00001", "config.json", "progress.csv"]
    assert len(ttr.episode_rewards) == UPDATES * 2 * N
