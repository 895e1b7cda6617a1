"""Fault F1, step (c): the policy's initial weights, the port against the
JAX package, at each profile's full width.

The port draws them from torch.Generator().manual_seed(RLEnvSeed)
(train/rl.py::_build_policy; models/policy.py reset_parameters), the JAX
package from Flax initializers under PRNGKey(RLEnvSeed)
(var_tpu/models/policy.py). The draws differ, so each parameter is held by
its distribution, for ArmPolicyBase and AI2ThorPolicyBase with their heads:
- the same names and shapes (the JAX parameters through convert.py);
- every bias, and the Gaussian head's logstd, zero in both;
- the orthogonal layers (each MLP Linear at gain sqrt(2), the critic's
  value layer, the head at 0.01 or 1.0, the GRU's w_ih and w_hh at 1):
  W^T W / gain^2 (or W W^T, on the short side) the identity within 1e-5 in
  both packages, float32 round-off of an orthogonal matrix;
- the Flax-default layers (every conv, the occupancy MLP): mean within
  5 standard errors of 0 and std within 5 standard errors of sqrt(1/fan_in)
  (lecun_normal: truncated at two std and rescaled to that variance), in
  both;
- every tensor of 64 or more elements: the two samples of entries by the
  two-sample Kolmogorov-Smirnov test at p >= 1e-3 (the same test and p as
  tests/test_torch_draws.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import var_tpu.config as jconfig
from var_tpu.envs.spaces import Box as JBox
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import (ai2thor_policy_state_dict,
                                   arm_policy_state_dict)
from var_tpu_torch.envs.spaces import Box, Discrete
from var_tpu_torch.models.policy import build_policy

P_MIN = 1e-3


def _profile(env):
    jcfg = jconfig.main_config(env=env)
    tcfg = tconfig.main_config(env=env)
    if env == "arms":
        spaces = (JBox(-np.ones(2), np.ones(2), dtype=np.float32),
                  Box(-np.ones(2), np.ones(2), dtype=np.float32))
        extra = {"robot_pose": jnp.zeros((2, 2))}
        convert = arm_policy_state_dict
    else:
        spaces = JDiscrete(len(jcfg.allActions)), Discrete(
            len(tcfg.allActions))
        extra = {"occupancy": jnp.zeros((2, 1, 9, 9), jnp.uint8)}
        convert = ai2thor_policy_state_dict
    return jcfg, tcfg, spaces, extra, convert


def _gains(module):
    """name -> orthogonal gain of every port parameter that starts
    orthogonal (the GRU's at 1)."""
    out = {}
    for name, m in module.named_modules():
        gain = getattr(m, "orthogonal_gain", None)
        if gain is not None:
            out[f"{name}.weight"] = gain
    out["base.gru.w_ih"] = out["base.gru.w_hh"] = 1.0
    return out


def _gram(w, gain):
    w = w.reshape(w.shape[0], -1).astype(np.float64) / gain
    return w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_initial_weights_match_jax_distributions(env):
    jcfg, tcfg, (jspace, tspace), extra, convert = _profile(env)
    seed = int(tcfg.RLEnvSeed)
    jpol = jpolicy.build_policy(jcfg, jspace)
    d = jcfg.representationDim
    obs = {"image": jnp.zeros((2, 3, 96, 96), jnp.uint8),
           "image_feat": jnp.zeros((2, d)),
           "goal_sound_feat": jnp.zeros((2, d)), **extra}
    hidden = jpol.recurrent_hidden_state_size
    params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(seed), obs, jnp.zeros((2, hidden)),
        jnp.ones((2, 1)), 1)["params"]
    want = convert(jax.tree_util.tree_map(np.asarray, params))
    tpol = build_policy(tcfg, tspace).reset_parameters(
        torch.Generator().manual_seed(seed))
    got = tpol.state_dict()
    assert set(got) == set(want)
    gains = _gains(tpol)
    n_orth = n_flax = 0
    for name in sorted(got):
        t, j = got[name].numpy(), want[name].numpy()
        assert t.shape == j.shape, name
        if name.split(".")[-1] in ("bias", "b_ih", "b_hh", "logstd"):
            assert not t.any() and not j.any(), name
            continue
        if name in gains:
            n_orth += 1
            for w in (t, j):
                gram = _gram(w, gains[name])
                np.testing.assert_allclose(gram, np.eye(len(gram)),
                                           atol=1e-5, err_msg=name)
        else:
            n_flax += 1
            fan_in = math.prod(t.shape[1:])
            std = math.sqrt(1.0 / fan_in)
            for w in (t, j):
                se = std / math.sqrt(w.size)
                assert abs(w.mean()) < 5 * se, name
                # the std of a sample std: about std / sqrt(2 n)
                assert abs(w.std() - std) < 5 * std / math.sqrt(2 * w.size), \
                    name
        if t.size >= 64:
            p = stats.ks_2samp(t.ravel(), j.ravel()).pvalue
            assert p >= P_MIN, f"{name}: KS p = {p:.3g}"
    # every MLP, the GRU, the head and the value layer are orthogonal; the
    # convs (and the occupancy MLP) are Flax's defaults
    assert n_orth >= 20 and n_flax == (8 if env == "arms" else 10)
