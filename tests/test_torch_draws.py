"""Fault F1, step (b): the port's own random draws against the JAX
package's distributions, on the CPU.

Every engine test feeds JAX's draws into the port, so nothing else holds
the port's own draws. Here each draw the device-sim paths make from their
torch.Generator is drawn 10^5 times (200,000 for the arm's two-sided
uniforms), and so is its JAX twin from a jax.random key; the two samples
are compared:
- a categorical draw (a plan, a heading, a task, a goal clip, an action, a
  permutation, a start cell) by a chi-square test of homogeneity on the
  2 x k table of counts (scipy.stats.chi2_contingency);
- a continuous draw (a uniform, an object pose, a gripper start) by the
  two-sample Kolmogorov-Smirnov test (scipy.stats.ks_2samp).
A test fails when p < 1e-3. With about 30 comparisons, a correct port
fails one of them by chance with probability about 3%; the seeds are
fixed, so the outcome is the same on every run. A wrong range, an
off-by-one high bound, a biased permutation or a wrong Gumbel transform
gives p far below 1e-10 at this sample size.

The categorical sampler is also held against the exact softmax
probabilities (chi-square goodness of fit, the same p).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import var_tpu.config as jconfig
from var_tpu.envs import arm_sim_device as jsim
from var_tpu.envs import grid_sim_device as jgrid
from var_tpu_torch import config as tconfig
from var_tpu_torch.envs import arm_sim_device as tsim
from var_tpu_torch.envs import grid_sim_device as tgrid
from var_tpu_torch.models.distributions import DistParams, sample
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import DeviceSimEngine, GridDeviceSimEngine

P_MIN = 1e-3
DRAWS = 100_000


def _cfgs(env):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env=env)
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _same_categorical(a, b, name):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    cats = np.union1d(a, b)
    table = np.stack([(a[:, None] == cats).sum(0), (b[:, None] == cats).sum(0)])
    p = stats.chi2_contingency(table)[1] if len(cats) > 1 else 1.0
    assert p >= P_MIN, f"{name}: chi-square p = {p:.3g}"
    return cats


def _same_continuous(a, b, name):
    p = stats.ks_2samp(np.asarray(a).ravel(), np.asarray(b).ravel()).pvalue
    assert p >= P_MIN, f"{name}: KS p = {p:.3g}"


def _rows(x):
    """Each row as one categorical value (a permutation, a cell)."""
    x = np.ascontiguousarray(np.asarray(x).reshape(len(x), -1))
    return np.unique(x, axis=0, return_inverse=True)[1].ravel(), x


def _same_rows(a, b, name):
    _, ua = _rows(a)
    _, ub = _rows(b)
    both = np.concatenate([ua, ub])
    ids = np.unique(both, axis=0, return_inverse=True)[1].ravel()
    _same_categorical(ids[:len(ua)], ids[len(ua):], name)


# -- the grid device sim ------------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    jcfg, tcfg = _cfgs("ai2thor")
    return jcfg, tcfg, jgrid.build_plan_bank(jcfg), tgrid.build_plan_bank(tcfg)


def test_grid_reset_draws(grid):
    """draw_reset (plan, start-cell uniform, heading, toggles) and what
    reset_from_draws makes of them (the start cell of each plan, the
    object states after forcing), against reset_with_task."""
    jcfg, _, jbank, tbank = grid
    n = DRAWS
    d = tgrid.draw_reset(_gen(0), tbank, n)
    k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(0), 4)
    _same_categorical(d.plan, jax.random.randint(k2, (n,), 0,
                                                 jbank.grids.shape[0]), "plan")
    _same_continuous(d.free_u, jax.random.uniform(k3, (n,)), "free_u")
    _same_categorical(d.rot, jax.random.randint(k4, (n,), 0, 8), "heading")
    _same_rows(d.toggled, jax.random.bernoulli(k5, 0.5, (n, 2)), "toggles")
    assert int(d.plan.max()) == jbank.grids.shape[0] - 1
    assert int(d.rot.max()) == 7

    task = np.arange(n) % 4
    obj = np.array([0, 0, 1, 1])  # the four tasks' objects, then the acts
    on = np.array([True, False, True, False])
    tplan, tpos, trot, ttog = tgrid.reset_from_draws(
        tbank, d, torch.from_numpy(task), torch.from_numpy(obj),
        torch.from_numpy(on))
    jplan, jpos, jrot, jtog = jgrid.reset_with_task(
        jbank, jax.random.PRNGKey(1), jnp.asarray(task), jnp.asarray(obj),
        jnp.asarray(on), jcfg)
    _same_rows(np.column_stack([tplan, tpos]),
               np.column_stack([jplan, jpos]), "start cell")
    _same_rows(np.column_stack([task, ttog]),
               np.column_stack([task, jtog]), "object states")
    # every start cell is a free cell of its plan
    free = {(int(p), int(r), int(c)) for p in range(tbank.grids.shape[0])
            for r, c in tbank.free_cells[p, :int(tbank.free_count[p])]
            .tolist()}
    assert {(int(p), int(r), int(c)) for p, (r, c) in
            zip(tplan[:2000], tpos[:2000].tolist())} <= free


def _engine_stub(cls, **attrs):
    """The engine's draw methods on a stand-in holding only what they
    read (building a real engine encodes a goal bank through the VAR)."""
    stub = object.__new__(cls)
    stub.__dict__.update(attrs)
    return stub


def test_grid_collect_draws(grid):
    """GridDeviceSimEngine.draw_collect: task and goal clip, against the
    JAX collect's randint draws (var_tpu/rl/device_sim.py:426-434)."""
    _, tcfg, _, tbank = grid
    n, samples = DRAWS, 64
    eng = _engine_stub(GridDeviceSimEngine, generator=_gen(2), N=n,
                       device=torch.device("cpu"), bank=tbank,
                       task_list=[None] * 4, T=1, A=8,
                       goal_bank=torch.zeros(4, samples, 3))
    d = eng.draw_collect()
    ki, kc = jax.random.split(jax.random.PRNGKey(2))
    _same_categorical(d.task, jax.random.randint(ki, (n,), 0, 4), "task")
    _same_categorical(d.clip, jax.random.randint(kc, (n,), 0, samples),
                      "goal clip")
    assert d.noise.shape == (2, n, 8)
    _same_continuous(d.noise[0], jax.random.gumbel(kc, (n, 8)), "gumbel")


@pytest.mark.parametrize("logits", [
    [0.0] * 8,
    [2.0, 0.0, -1.0, 0.5, 0.5, -3.0, 1.0, 0.0],
    [8.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -8.0],
])
def test_categorical_sample_matches_jax(logits):
    """sample() of a categorical (argmax of logits + gumbel_noise) against
    jax.random.categorical on the same logits, and both against the
    softmax."""
    n = DRAWS
    lg = torch.tensor(logits).expand(n, -1)
    port = sample(DistParams("categorical", logits=lg), _gen(3))[:, 0]
    ref = jax.random.categorical(jax.random.PRNGKey(3),
                                 jnp.broadcast_to(jnp.asarray(logits),
                                                  (n, 8)), axis=-1)
    _same_categorical(port, ref, "categorical")
    probs = torch.softmax(torch.tensor(logits, dtype=torch.float64), 0)
    for name, draws in (("port", port.numpy()), ("jax", np.asarray(ref))):
        counts = np.bincount(draws, minlength=8)
        expect = probs.numpy() * n
        keep = expect >= 5  # chi-square needs expected counts of 5 or more
        counts, expect = counts[keep], expect[keep]
        expect = expect * counts.sum() / expect.sum()
        p = stats.chisquare(counts, expect).pvalue
        assert p >= P_MIN, f"{name} against the softmax: p = {p:.3g}"


@pytest.mark.parametrize("n_envs", [4, 8])
def test_ppo_permutations_match_jax(n_envs):
    """PPO.draw_perms (recurrent: one env permutation per epoch) against
    var_tpu's jax.random.permutation draws: the joint distribution of whole
    permutations (4! or, for 8 envs, the first three positions)."""
    epochs = 4
    stub = types.SimpleNamespace(cfg=types.SimpleNamespace(ppo_epoch=epochs),
                                 model=types.SimpleNamespace(recurrent=True))
    batch = {"returns": torch.zeros(3, n_envs)}
    g = _gen(4)
    port = torch.cat([tppo.PPO.draw_perms(stub, batch, g)
                      for _ in range(DRAWS // epochs)]).numpy()
    keys = jax.random.split(jax.random.PRNGKey(4), DRAWS)
    ref = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_envs))(
        keys))
    width = n_envs if n_envs <= 4 else 3
    _same_rows(port[:, :width], ref[:, :width], "permutation")
    assert (np.sort(port, 1) == np.arange(n_envs)).all()


# -- the arm device sim -------------------------------------------------------


@pytest.fixture(scope="module")
def arm():
    jcfg, tcfg = _cfgs("arms")
    return jsim.consts_from_config(jcfg), tsim.consts_from_config(tcfg)


def test_arm_reset_draws(arm):
    """draw_reset + reset_from_draws against randomize: the object order
    (a permutation per env), every object's pose, the gripper's start."""
    jk, tk = arm
    n = 2 * DRAWS
    pose, order, ee = tsim.reset_from_draws(tsim.draw_reset(_gen(5), n, tk),
                                            tk)
    jpose, jorder, jee = jsim.randomize(jax.random.PRNGKey(5), n, jk)
    _same_rows(order, jorder, "object order")
    for i in range(tk.n_obj):
        for ax, name in enumerate("xy"):
            _same_continuous(pose[:, i, ax], np.asarray(jpose)[:, i, ax],
                             f"object {i} {name}")
    for ax, name in enumerate("xy"):
        _same_continuous(ee[:, ax], np.asarray(jee)[:, ax], f"gripper {name}")


def test_arm_collect_draws(arm):
    """DeviceSimEngine.draw_collect: intent, goal clip and the Gaussian
    action noise, against the JAX collect's (var_tpu/rl/device_sim.py:167-
    170; the noise is jax.random.normal through sample)."""
    _, tk = arm
    n, clips = DRAWS, 16
    eng = _engine_stub(DeviceSimEngine, generator=_gen(6), N=n,
                       device=torch.device("cpu"), k=tk, T=1, A=2,
                       config=types.SimpleNamespace(taskNum=4),
                       goal_bank=torch.zeros(4, clips, 3))
    d = eng.draw_collect()
    ki, kc, ka = jax.random.split(jax.random.PRNGKey(6), 3)
    _same_categorical(d.intent, jax.random.randint(ki, (n,), 0, 4), "intent")
    _same_categorical(d.clip, jax.random.randint(kc, (n,), 0, clips),
                      "goal clip")
    _same_continuous(d.noise[0], jax.random.normal(ka, (n, 2)), "noise")
