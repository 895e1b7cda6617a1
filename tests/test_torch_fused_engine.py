"""var_tpu_torch/rl/rollout.py::FusedRolloutEngine against
var_tpu/rl/rollout.py's, step by step, on both profiles at small widths.

The same VAR and policy weights (drawn in JAX's shapes from a seeded numpy
generator, converted for the port), the same host env stream (both
engines see each step's raw observation; the envs step with JAX's sampled
action) and JAX's own draws (the Gaussian or Gumbel noise jax.random makes
from each step's key) go through both engines for 2 episodes, so the steps
cover a fresh goal (the sound branch runs) and the cached one (it is
skipped), the host return-RMS and, on the arm, RLRewardSoundSound.

Tolerances: rtol = atol = 1e-4 (BASELINE.md: both IEEE float32, only the
order of summation differs); the ai2thor CRNN's goal embeddings, and what
reads them (rewards, normalised rewards), at the CRNN's rtol 1e-3 / atol
2e-4 (BASELINE.md). Grid actions, the argmax of the same noisy logits,
are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.envs.spaces import Box as JBox
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl.rollout import FusedRolloutEngine as JEngine
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import (ai2thor_policy_state_dict,
                                   ai2thor_state_dict, arm_policy_state_dict,
                                   arm_state_dict)
from var_tpu_torch.envs.spaces import Box, Discrete
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.rl.rollout import FusedRolloutEngine as TEngine

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
N, T, H = 3, 3, 32
PROFILES = {
    "arms": dict(variant="arm", convert=(arm_state_dict,
                                         arm_policy_state_dict),
                 spaces=(JBox(-np.ones(2), np.ones(2)),
                         Box(-np.ones(2), np.ones(2))),
                 extra=("robot_pose", jnp.zeros((N, 2))),
                 knobs=dict(RLRewardSoundSound=0.5), tol=TOL),
    "ai2thor": dict(variant="ai2thor", convert=(ai2thor_state_dict,
                                                ai2thor_policy_state_dict),
                    spaces=(JDiscrete(8), Discrete(8)),
                    extra=("occupancy", jnp.zeros((N, 1, 9, 9), jnp.uint8)),
                    knobs=dict(sound_dim=(1, 100, 40)), tol=CRNN_TOL),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(env, **extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env=env)
        cfg.override(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
                     RLRecurrentSize=H, RLRecurrentInputSize=16,
                     RLActionHiddenSize=32, vecEnvBackend="dummy",
                     RLTrain=True, **extra)
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _numpy_params(rng, init, key):
    """The "params" of `init(key)`, shaped by jax.eval_shape (traced, not
    compiled: the two init programs cost more than the engine's steps)
    and drawn from the seeded numpy `rng`: kernels N(0, 1/fan_in), as
    flax's lecun init draws them, vectors (biases, the arm's log-std)
    N(0, 0.01)."""
    def draw(leaf):
        if len(leaf.shape) < 2:
            return jnp.asarray(rng.normal(0.0, 0.01, leaf.shape), leaf.dtype)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return jnp.asarray(rng.normal(0.0, fan_in ** -0.5, leaf.shape),
                           leaf.dtype)

    return jax.tree_util.tree_map(draw, jax.eval_shape(init, key)["params"])


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_fused_engine_matches_jax_step_by_step(env, monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    prof = PROFILES[env]
    jcfg, tcfg = _configs(env, **prof["knobs"])
    rng = np.random.default_rng(0)
    var_model = build_pretext_model(jcfg)
    var_params = _numpy_params(rng, lambda key: init_pretext_params(
        var_model, jcfg, key), jax.random.PRNGKey(0))
    jpol = jpolicy.build_policy(jcfg, prof["spaces"][0])
    extra_key, extra0 = prof["extra"]
    obs0 = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
            "image_feat": jnp.zeros((N, 3)), extra_key: extra0,
            "goal_sound_feat": jnp.zeros((N, 3))}
    policy_params = _numpy_params(
        rng, lambda key: jpol.init(key, obs0, jnp.zeros((N, H)),
                                   jnp.ones((N, 1)), 1),
        jax.random.PRNGKey(1))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    tvar = VARPretextNet(3, prof["variant"])
    tvar.load_state_dict(prof["convert"][0](to_np(var_params)))
    tvar.eval().requires_grad_(False)
    tpol = build_policy(tcfg, prof["spaces"][1])
    tpol.load_state_dict(prof["convert"][1](to_np(policy_params)))

    jeng = JEngine(var_model, var_params, jpol, jcfg, N)
    teng = TEngine(tvar, tpol, tcfg, N)
    envs = make_vec_envs(tcfg.RLEnvName, tcfg.RLEnvSeed, N, None, True, tcfg)
    raw_obs = envs.reset()
    env_rew, news = np.zeros(N, np.float32), np.ones(N, bool)
    jhx, thx = jnp.zeros((N, H)), torch.zeros(N, H)
    masks = np.ones((N, 1), np.float32)
    key = jax.random.PRNGKey(7)
    fresh_steps = cached_steps = 0
    for step in range(2 * T):
        key, sub = jax.random.split(key)
        goal = np.asarray(raw_obs["goal_sound"], np.float32)
        fresh = np.isfinite(goal.reshape(N, -1)[:, 0]).any()
        fresh_steps += fresh
        cached_steps += not fresh
        jp, jnorm, jraw, jout = jeng.process_and_act(
            policy_params, raw_obs, env_rew, news, jhx, jnp.asarray(masks),
            sub)
        if env == "arms":  # the draw jax's sample() makes from `sub`
            noise = torch.from_numpy(np.array(jax.random.normal(sub, (N, 2))))
        else:
            noise = torch.from_numpy(np.array(
                jax.random.gumbel(sub, (N, 8), jnp.float32)))
        tp, tnorm, traw, tout = teng.process_and_act(
            raw_obs, env_rew, news, thx, torch.from_numpy(masks), noise)
        np.testing.assert_allclose(tp["image_feat"], jp["image_feat"], **TOL)
        np.testing.assert_allclose(tp["goal_sound_feat"],
                                   jp["goal_sound_feat"], **prof["tol"])
        np.testing.assert_array_equal(tp["image"], jp["image"])
        np.testing.assert_array_equal(tp[extra_key], jp[extra_key])
        for name, got, want in (("raw reward", traw, jraw),
                                ("normalised reward", tnorm, jnorm)):
            np.testing.assert_allclose(got, want, err_msg=name,
                                       **prof["tol"])
        for name in ("value", "action_log_prob", "rnn_hx", "action"):
            got, want = _np(getattr(tout, name)), np.asarray(
                getattr(jout, name))
            if env == "ai2thor" and name == "action":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, err_msg=name,
                                           **prof["tol"])
        jhx, thx = jout.rnn_hx, tout.rnn_hx
        action = np.asarray(jout.action)
        raw_obs, env_rew, done, _ = envs.step(action)
        news = np.asarray(done, bool)
        masks = (~news).astype(np.float32)[:, None]
    envs.close()
    assert fresh_steps >= 2 and cached_steps >= 2
    for name in ("mean", "var", "count"):
        np.testing.assert_allclose(
            getattr(teng.ret_norm.rms, name),
            np.asarray(getattr(jeng.ret_norm.rms, name)), err_msg=name,
            **prof["tol"])
    np.testing.assert_allclose(teng.ret_norm.ret,
                               np.asarray(jeng.ret_norm.ret), **prof["tol"])
