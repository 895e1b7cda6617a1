"""The port's policy stack against the JAX package on the CPU: action
distributions, the masked GRU scan, and the arm Policy (forward at seq_len
1 and 4, evaluate_actions) with the JAX package's parameters converted by
arm_policy_state_dict. Reduced widths: GRU 32, GRU input 16, action hidden
32, 96x96 images.

Tolerance rtol = atol = 1e-4 throughout: both sides compute in IEEE
float32 and differ only in the order of summation (the conv stack and the
matmuls), which moves a result by about 1e-6 here. Random draws are JAX's,
passed to the port's sample() as `noise`, so a sample agrees as closely as
the distribution's parameters do; argmax actions must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.envs.spaces import Box as JBox
from var_tpu.models import distributions as jdist
from var_tpu.models import policy as jpolicy
from var_tpu.ops import gru as jgru
from var_tpu_torch.convert import arm_policy_state_dict
from var_tpu_torch.envs import spaces as tspaces
from var_tpu_torch.models import distributions as tdist
from var_tpu_torch.models import policy as tpolicy
from var_tpu_torch.ops import gru as tgru

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several test workers on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores,
    and the small eager ops here then slow down more than tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SmallCfg:
    RLPolicyBase = "arm_VAR"
    representationDim = 3
    robotStateDim = 2
    RLRecurrentPolicy = True
    RLRecurrentInputSize = 16
    RLRecurrentSize = 32
    RLActionHiddenSize = 32
    computeDtype = "float32"
    img_dim = (3, 96, 96)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _dists(kind, rng, B=5, A=3):
    """The same distribution in both packages, from numpy draws."""
    if kind == "gaussian":
        mean = rng.randn(B, A).astype(np.float32)
        logstd = (0.3 * rng.randn(A)).astype(np.float32)
        return (jdist.DistParams(kind, mean=jnp.asarray(mean),
                                 logstd=jnp.asarray(logstd)),
                tdist.DistParams(kind, mean=_t(mean), logstd=_t(logstd)))
    logits = (2 * rng.randn(B, A)).astype(np.float32)
    return (jdist.DistParams(kind, logits=jnp.asarray(logits)),
            tdist.DistParams(kind, logits=_t(logits)))


KINDS = ["categorical", "gaussian", "bernoulli"]


@pytest.mark.parametrize("kind", KINDS)
def test_distribution_functions_match_jax(kind):
    rng = np.random.RandomState(KINDS.index(kind))
    jd, td = _dists(kind, rng)
    key = jax.random.PRNGKey(7)
    jsample = jdist.sample(jd, key)
    # the draw jdist.sample made from `key`, fed to the port
    shape = (jd.mean if kind == "gaussian" else jd.logits).shape
    noise = {"gaussian": jax.random.normal, "categorical": jax.random.gumbel,
             "bernoulli": jax.random.uniform}[kind](key, shape)
    tsample = tdist.sample(td, noise=_t(noise))
    assert tsample.dtype == {"categorical": torch.int32}.get(
        kind, torch.float32)
    for got, want in ((tsample, jsample), (tdist.mode(td), jdist.mode(jd))):
        if kind == "gaussian":
            _close(got, want)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tdist.entropy(td), jdist.entropy(jd))
    for actions in (np.asarray(jsample),
                    np.asarray(jdist.mode(jd))):
        got = tdist.log_probs(td, _t(actions))
        assert got.shape == (5, 1)
        _close(got, jdist.log_probs(jd, jnp.asarray(actions)))


@pytest.mark.parametrize("kind", KINDS)
def test_sample_from_a_generator_has_the_right_law(kind):
    """The port's own draws (no JAX noise): shapes, and the sample mean
    against the distribution's, over 20000 draws (4 standard errors)."""
    rng = np.random.RandomState(3)
    _, td = _dists(kind, rng, B=1, A=2)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tdist.sample(td, gen) for _ in range(20000)])
    if kind == "gaussian":
        want, sd = td.mean[0], torch.exp(td.logstd)
    elif kind == "bernoulli":
        p = torch.sigmoid(td.logits[0])
        want, sd = p, torch.sqrt(p * (1 - p))
    else:
        p = torch.softmax(td.logits[0], -1)
        draws = torch.nn.functional.one_hot(draws[:, 0, 0].long(), 2)[:, None]
        want, sd = p, torch.sqrt(p * (1 - p))
    got = draws[:, 0].double().mean(0)
    assert (got - want).abs().le(4 * sd / np.sqrt(20000) + 1e-6).all()


def _gru_params(rng, D=5, H=6):
    s = 1 / np.sqrt(H)
    arrs = [rng.uniform(-s, s, shape).astype(np.float32)
            for shape in ((3 * H, D), (3 * H, H), (3 * H,), (3 * H,))]
    return jgru.GRUParams(*map(jnp.asarray, arrs)), tgru.GRUParams(*map(_t, arrs))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_masks", [False, True])
def test_gru_scan_matches_jax(with_masks, reverse):
    rng = np.random.RandomState(1)
    jp, tp = _gru_params(rng)
    T, B = 6, 4
    xs = rng.randn(T, B, 5).astype(np.float32)
    h0 = rng.randn(B, 6).astype(np.float32)
    masks = None
    if with_masks:
        masks = (rng.rand(T, B) > 0.3).astype(np.float32)
        masks[2, :] = 0.0  # every row resets at t = 2
    jys, jh = jgru.gru_scan(jp, jnp.asarray(xs), jnp.asarray(h0),
                            None if masks is None else jnp.asarray(masks),
                            reverse=reverse)
    tys, th = tgru.gru_scan(tp, _t(xs), _t(h0),
                            None if masks is None else _t(masks),
                            reverse=reverse)
    _close(tys, jys)
    _close(th, jh)
    _close(tgru.gru_cell(tp, _t(xs[0]), _t(h0)),
           jgru.gru_cell(jp, jnp.asarray(xs[0]), jnp.asarray(h0)))


def _obs(rng, n):
    return {
        "image": rng.randint(0, 256, (n, 3, 96, 96)).astype(np.uint8),
        "image_feat": rng.randn(n, 3).astype(np.float32),
        "robot_pose": rng.randn(n, 2).astype(np.float32),
        "goal_sound_feat": rng.randn(n, 3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def policies():
    """The JAX arm Policy and its port, with the JAX parameters."""
    cfg = SmallCfg()
    jpol = jpolicy.build_policy(cfg, JBox(low=-np.ones(2), high=np.ones(2)))
    rng = np.random.RandomState(0)
    obs = {k: jnp.asarray(v) for k, v in _obs(rng, 4).items()}
    # jitted: flax's eager init dispatches op by op, several times slower
    variables = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(0), obs, jnp.zeros((4, 32)), jnp.ones((4, 1)), 1)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tpol = tpolicy.build_policy(
        cfg, tspaces.Box(low=-np.ones(2), high=np.ones(2)))
    tpol.load_state_dict(arm_policy_state_dict(params))
    return jpol, variables, tpol


@pytest.mark.parametrize("seq_len", [1, 4])
def test_policy_forward_matches_jax(policies, seq_len):
    jpol, variables, tpol = policies
    rng = np.random.RandomState(seq_len)
    N = 4
    obs = _obs(rng, seq_len * N)
    hx = rng.randn(N, 32).astype(np.float32)
    masks = (rng.rand(seq_len * N, 1) > 0.3).astype(np.float32)
    jv, jd, jh = jpol.apply(variables, {k: jnp.asarray(v) for k, v in
                                        obs.items()},
                            jnp.asarray(hx), jnp.asarray(masks), seq_len)
    with torch.no_grad():
        tv, td, th = tpol({k: _t(v) for k, v in obs.items()}, _t(hx),
                          _t(masks), seq_len)
    _close(tv, jv)
    _close(th, jh)
    _close(td.mean, jd.mean)
    _close(td.logstd, jd.logstd)


def test_evaluate_actions_matches_jax(policies):
    jpol, variables, tpol = policies
    rng = np.random.RandomState(9)
    T, N = 3, 4
    obs = _obs(rng, T * N)
    hx = rng.randn(N, 32).astype(np.float32)
    masks = np.ones((T * N, 1), np.float32)
    masks[N:N + 2] = 0.0  # two envs start an episode at t = 1
    actions = rng.randn(T * N, 2).astype(np.float32)
    jv, jlp, jent = jpolicy.evaluate_actions(
        jpol, variables, {k: jnp.asarray(v) for k, v in obs.items()},
        jnp.asarray(hx), jnp.asarray(masks), jnp.asarray(actions), T)
    tv, tlp, tent = tpolicy.evaluate_actions(
        tpol, {k: _t(v) for k, v in obs.items()}, _t(hx), _t(masks),
        _t(actions), T)
    _close(tv, jv)
    _close(tlp, jlp)
    _close(tent, jent)
    step = tpolicy.act(tpol, {k: _t(v[:N]) for k, v in obs.items()}, _t(hx),
                       _t(masks[:N]), deterministic=True)
    jstep = jpolicy.act(jpol, variables,
                        {k: jnp.asarray(v[:N]) for k, v in obs.items()},
                        jnp.asarray(hx), jnp.asarray(masks[:N]),
                        jax.random.PRNGKey(0), deterministic=True)
    for got, want in zip(step, jstep):
        _close(got, want)
    _close(tpolicy.get_value(tpol, {k: _t(v[:N]) for k, v in obs.items()},
                             _t(hx), _t(masks[:N])), jstep.value)


def test_policy_layout_and_init():
    """The state_dict's names are the converter's, the GRU starts
    orthogonal, and an unported base raises."""
    cfg = SmallCfg()
    tpol = tpolicy.build_policy(
        cfg, tspaces.Box(low=-np.ones(2), high=np.ones(2)))
    tpol.reset_parameters(torch.Generator().manual_seed(0))
    w = tpol.base.gru.w_hh.detach()
    torch.testing.assert_close(w.T @ w, torch.eye(32), atol=1e-5, rtol=0)
    assert tpol.recurrent_hidden_state_size == 32
    assert tpolicy.conv_grid(cfg.img_dim) == (128, 3, 3)
    assert isinstance(tdist.make_head(tspaces.Discrete(5), 8),
                      tdist.CategoricalHead)
    assert isinstance(tdist.make_head(tspaces.MultiBinary(4), 8),
                      tdist.BernoulliHead)
    cfg.RLPolicyBase = "ai2thor_VAR"
    grid = tpolicy.build_policy(cfg, tspaces.Discrete(8))
    assert isinstance(grid.base, tpolicy.AI2ThorPolicyBase)
    assert isinstance(grid.dist_head, tdist.CategoricalHead)
    assert tpolicy.conv_grid((1, 9, 9), tpolicy.OCCUPANCY_CONVS) == (32, 3, 3)
    cfg.RLPolicyBase = "no_such_base"
    with pytest.raises(KeyError):
        tpolicy.build_policy(cfg, tspaces.Discrete(8))
