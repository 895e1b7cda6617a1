"""The port's returns, LR schedules, gradient clipping and PPO update
against the JAX package on the CPU, from the same numpy inputs, converted
parameters and epoch permutations (re-made from the JAX update's key
splits). Reduced widths: GRU 32, GRU input 16, action hidden 32, 96x96
images, T = 4, N = 4, 2 epochs x 2 minibatches.

Tolerances:
- returns, schedules, clipped gradients and each update's losses at
  rtol = atol = 1e-4: float32 on both sides, only the order of summation
  differs;
- parameters after the update within 2 * lr per optimizer step (+ 5e-5),
  with a median difference below 1e-6, as tests/test_torch_pretext.py
  holds an Adam step: Adam moves every weight by about +-lr whatever the
  size of its gradient, so a near-zero gradient that rounds to the other
  sign differs by 2 * lr; the median shows that the rest agree;
- the optimizer chain alone (clip, Adam, LR), on the same gradients, at
  rtol 1e-5: elementwise float32 arithmetic in another order;
- Adam's moments are held by that chain test, not after a whole update:
  once the parameters differ by the sign flips above, a ReLU whose input
  lies within about lr of zero can switch on in one package and not in the
  other, and a near-tie in a 2x2 max pool can route a conv gradient to
  another pixel; either moves later gradients by a transition's share
  (1/8 of a minibatch here), which the losses average out and the
  parameters' +-lr steps absorb, but the moments carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from var_tpu.envs.spaces import Box as JBox
from var_tpu.models import policy as jpolicy
from var_tpu.ops import gae as jgae
from var_tpu.rl import ppo as jppo
from var_tpu_torch.convert import arm_policy_state_dict
from var_tpu_torch.envs import spaces as tspaces
from var_tpu_torch.models import policy as tpolicy
from var_tpu_torch.ops import gae as tgae
from var_tpu_torch.rl import ppo as tppo

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several test workers on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores,
    and the small eager ops here then slow down more than tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("proper", [False, True])
@pytest.mark.parametrize("use_gae", [True, False])
def test_compute_returns_matches_jax(use_gae, proper):
    rng = np.random.RandomState(int(use_gae) * 2 + int(proper))
    T, N = 7, 5
    rewards = rng.randn(T, N).astype(np.float32)
    values = rng.randn(T + 1, N).astype(np.float32)
    masks = (rng.rand(T + 1, N) > 0.25).astype(np.float32)
    bad = (rng.rand(T + 1, N) > 0.25).astype(np.float32)
    next_value = rng.randn(N).astype(np.float32)
    args = (0.99, 0.95, use_gae, proper)
    jret, jvp = jgae.compute_returns(*map(jnp.asarray, (
        rewards, values, masks, bad, next_value)), *args)
    tret, tvp = tgae.compute_returns(*map(_t, (
        rewards, values, masks, bad, next_value)), *args)
    _close(tret, jret)
    _close(tvp, jvp)


def _ppo_cfg(mod, **kw):
    base = dict(clip_param=0.2, ppo_epoch=2, num_mini_batch=2,
                value_loss_coef=0.5, entropy_coef=0.01, lr=3e-5, eps=1e-5,
                max_grad_norm=0.5)
    return mod.PPOConfig(**{**base, **kw})


@pytest.mark.parametrize("decay", [None, "linear", "cosine"])
def test_lr_schedule_matches_optax(decay):
    kw = dict(lr=1e-3, lr_decay=decay, lr_decay_start=0.3,
              lr_final_factor=0.1, total_opt_steps=40)
    jsched = jppo.PPO(None, _ppo_cfg(jppo, **kw))._lr_schedule()
    port = tppo.PPO(None, _ppo_cfg(tppo, **kw))
    for count in (0, 1, 11, 12, 13, 25, 39, 40, 55):
        want = jsched(count) if callable(jsched) else jsched
        _close(port.lr_at(count), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_global_norm_clipping_matches_optax(scale):
    rng = np.random.RandomState(int(scale))
    grads = [(scale * rng.randn(*s)).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    tx = optax.clip_by_global_norm(0.5)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = [_t(g) for g in grads]
    norm = tppo.clip_by_global_norm_(got, 0.5)
    _close(norm, np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)), rtol=1e-6, atol=0)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-6, atol=1e-7)


class SmallCfg:
    RLPolicyBase = "arm_VAR"
    representationDim = 3
    robotStateDim = 2
    RLRecurrentInputSize = 16
    RLRecurrentSize = 32
    RLActionHiddenSize = 32
    computeDtype = "float32"
    img_dim = (3, 96, 96)


def _batch(rng, T, N, H):
    obs = {
        "image": rng.randint(0, 256, (T, N, 3, 96, 96)).astype(np.uint8),
        "robot_pose": rng.randn(T, N, 2).astype(np.float32),
        "image_feat": rng.randn(T, N, 3).astype(np.float32),
        "goal_sound_feat": rng.randn(T, N, 3).astype(np.float32),
    }
    masks = np.ones((T, N), np.float32)
    masks[1, 0] = masks[2, 3] = 0.0  # episode starts inside the rollout
    return {
        "obs": obs,
        "rnn_hx0": (0.5 * rng.randn(N, H)).astype(np.float32),
        "actions": (0.7 * rng.randn(T, N, 2)).astype(np.float32),
        "value_preds": rng.randn(T, N).astype(np.float32),
        "returns": rng.randn(T, N).astype(np.float32),
        "masks": masks,
        # around the policy's own log-prob of those actions at zero
        # logstd, so that some ratios clip and some do not
        "old_log_probs": (-1.84 - 0.5 * 0.49 * 2
                          + 0.2 * rng.randn(T, N)).astype(np.float32),
    }


@pytest.mark.parametrize("recurrent", [True, False])
def test_ppo_update_matches_jax(recurrent):
    cfg = SmallCfg()
    cfg.RLRecurrentPolicy = recurrent
    T, N = 4, 4
    jpol = jpolicy.build_policy(cfg, JBox(low=-np.ones(2), high=np.ones(2)))
    H = jpol.recurrent_hidden_state_size
    rng = np.random.RandomState(5)
    batch = _batch(rng, T, N, H)
    init_obs = {k: jnp.asarray(v[0]) for k, v in batch["obs"].items()}
    variables = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(1), init_obs, jnp.zeros((N, H)),
        jnp.ones((N, 1)), 1)
    sd0 = arm_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, variables["params"]))

    tpol = tpolicy.build_policy(
        cfg, tspaces.Box(low=-np.ones(2), high=np.ones(2)))
    tpol.load_state_dict(sd0)
    port = tppo.PPO(tpol, _ppo_cfg(tppo))
    state = port.init_state()

    jp = jppo.PPO(jpol, _ppo_cfg(jppo))
    jstate = jp.init_state(variables["params"])
    key = jax.random.PRNGKey(11)
    # the permutations the JAX update draws from `key` (ppo.py:205-210
    # recurrent, :282-284 feed-forward)
    n = N if recurrent else T * N
    perms, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate, jmetrics = jp.update(jstate, jbatch, key)

    tbatch = {"obs": {k: _t(v) for k, v in batch["obs"].items()},
              **{k: _t(v) for k, v in batch.items() if k != "obs"}}
    state, metrics = port.update(state, tbatch, torch.from_numpy(
        np.stack(perms).astype(np.int64)))

    for name, v in metrics.items():
        _close(v.numpy(), jmetrics[name])
    assert state.step == 1 and state.opt_state.count == 4
    want = arm_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    got = tpol.state_dict()
    atol = 2 * 3e-5 * 4 + 5e-5
    diffs = []
    moved = 0.0
    for k, v in want.items():
        d = (got[k] - v).abs()
        assert d.max().item() <= atol, k
        diffs.append(d.ravel())
        moved = max(moved, (v - sd0[k]).abs().max().item())
    assert torch.cat(diffs).median().item() < 1e-6
    assert moved > 5e-5  # the update did move the parameters


def test_optimizer_chain_matches_optax():
    """Global-norm clip -> Adam -> LR schedule over three steps on the
    same gradients (the first and third clipped, the second not), with the
    LR decaying from the second step on."""
    rng = np.random.RandomState(2)
    shapes = {"a": (5, 3), "b": (4,), "c": (2, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, lr_decay="linear", lr_decay_start=0.3,
              total_opt_steps=4)
    jp = jppo.PPO(None, _ppo_cfg(jppo, **kw))
    port = tppo.PPO(None, _ppo_cfg(tppo, **kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = jp.tx.init(jparams)
    tparams = {k: _t(v) for k, v in params.items()}
    state = tppo.PPOState(tparams, tppo.AdamState(
        0, {k: torch.zeros_like(v) for k, v in tparams.items()},
        {k: torch.zeros_like(v) for k, v in tparams.items()}), 0)
    for scale in (3.0, 0.01, 5.0):
        grads = {k: (scale * rng.randn(*s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, opt = jp.tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                opt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        state = port._apply_adam(state, [_t(grads[k]) for k in tparams])
        adam = next(s for s in opt if hasattr(s, "mu"))
        for k in shapes:
            _close(state.params[k], jparams[k], rtol=1e-5, atol=1e-7)
            _close(state.opt_state.mu[k], adam.mu[k], rtol=1e-5, atol=1e-9)
            _close(state.opt_state.nu[k], adam.nu[k], rtol=1e-5, atol=1e-12)
    assert state.opt_state.count == 3


def test_draw_perms_and_config():
    class Cfg:
        ppoClipParam, ppoEpoch, ppoNumMiniBatch = 0.2, 4, 2
        ppoValueLossCoef, ppoEntropyCoef = 0.5, 0.01
        RLLr, RLEps, RLMaxGradNorm = 3e-5, 1e-5, 0.5
        RLTotalSteps, ppoNumSteps, RLNumEnvs = 2400, 100, 8
        RLLrDecay = "linear"

    jcfg, tcfg = jppo.PPOConfig.from_config(Cfg), tppo.PPOConfig.from_config(Cfg)
    assert {k: v for k, v in jcfg._asdict().items()
            if k != "unroll_minibatches"} == tcfg._asdict()
    cfg = SmallCfg()
    cfg.RLRecurrentPolicy = True
    tpol = tpolicy.build_policy(
        cfg, tspaces.Box(low=-np.ones(2), high=np.ones(2)))
    port = tppo.PPO(tpol, tcfg)
    perms = port.draw_perms({"returns": torch.zeros(100, 8)},
                            torch.Generator().manual_seed(0))
    assert perms.shape == (4, 8)
    assert (perms.sort(1).values == torch.arange(8)).all()
