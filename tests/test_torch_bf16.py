"""computeDtype='bfloat16' on the port against the JAX package at the same
dtype, on the CPU at small widths: the same seeded numpy inputs and the
same converted float32 parameters on both sides.

At bf16 both packages follow flax's `promote_dtype`: each conv or dense
layer of the conv stacks and the VAR heads rounds its input, kernel, bias
and output to bf16 (8 significand bits, unit roundoff EPS = 2^-8). The
two packages then differ only where a float32 sum of bf16 products lands
on the other side of a bf16 rounding boundary: one bf16 step (2 EPS
relative) in a few elements of a layer, which later layers carry on.
JAX's own bf16 run differs from its float32 run by every rounding at once.
Flips cascade down a stack, and the more samples, the further the tails
reach, so each tolerance is stated in units of EPS with room over the
largest measured; where it is compared, the port's distance to JAX's bf16
result must lie well inside JAX's own bf16-vs-float32 gap. They are the
tolerances of tools/rl_check.py's bf16 card-against-CPU checks too
(chip_smoke.py phase 34), where cuDNN's bf16 convolutions sum in yet
another order:
- unit-sphere embeddings: at most EMBED_EPS = 4 EPS apart in a component.
  The head's last dense layer rounds each component to bf16, so a flip
  there alone moves it by one bf16 step (2 EPS of its magnitude); flips
  in the layers below add to it, most through the six-conv ai2thor image
  stack. Measured: port against JAX on the CPU up to 1.9 EPS (8 samples).
  And the mean distance at most half of JAX's own mean bf16-vs-float32
  gap: on the CPU the ratio ran from 1e-5 (the arm's sound) to 0.39 (the
  CRNN's sound: its GRU runs in float32, where the two packages already
  differ by the CRNN's 1e-3 relative float32 tolerance, and its final
  state is rounded to bf16 for the head, so those float32 differences
  flip bf16 roundings there);
- what derives from the VAR reward, the dot of two such embeddings (raw
  and normalised rewards, returns, the return-RMS, raw reward sums):
  within 2 sqrt(D) EMBED_EPS of their scale (the first-order bound of a
  dot of two unit vectors, each within EMBED_EPS a component, D =
  representationDim);
- the policy's values, actions, log-probs and hidden states: at most 2 EPS
  of their scale (one bf16 step: the flipped conv features pass through
  float32 MLPs), and closer to JAX's bf16 result than JAX's float32 result
  is, wherever that gap is above float32 noise (a Gaussian's log-prob of a
  sample drawn from given noise reads only the log-std, so it has no bf16
  gap); measured up to 1.3 EPS of the scale and 0.66 of JAX's gap;
- a pretext step's loss at 2 EPS (a mean of triplet distances, each moved
  by far less than the embeddings' bound; measured below 0.05 EPS), an
  update's losses within EPS of the larger of their size and 1 (the
  advantages are normalised to unit scale, and the action loss, a
  difference of clipped surrogates, sits near zero), their parameters
  within the Adam bound (2 lr per optimizer step + 5e-5) with most
  elements agreeing (the median at most lr/10 per step: Adam moves each
  weight by about lr whatever its gradient, and a gradient the bf16 flips
  turn over moves it by 2 lr);
- pixels, poses, counts: exact, as at float32 (the rollout applies JAX's
  sampled actions, so that a mean that moved by a bf16 step cannot move a
  gripper across a pixel edge in one package only).
Checkpoints stay float32: a model trained at one dtype loads at the other
and computes there what the JAX package computes at that dtype.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.envs.spaces import Box as JBox
from var_tpu.envs.spaces import Discrete as JDiscrete
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import VARPretextNet as JaxVAR
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl import ppo as jppo
from var_tpu.rl.device_sim import DeviceSimEngine as JEngine
from var_tpu.rl.device_sim import init_rms as jinit_rms
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import (ai2thor_policy_state_dict,
                                   ai2thor_state_dict, arm_policy_state_dict,
                                   arm_state_dict)
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.envs.spaces import Box, Discrete
from var_tpu_torch.models import policy as tpolicy
from var_tpu_torch.models.encoders import VARPretextNet, build_pretext_model as tbuild
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.rl.device_sim import DeviceSimEngine, init_rms
from var_tpu_torch.train import pretext as tpretext
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

EPS = 2.0 ** -8
EMBED_EPS = 4
BF16 = "bfloat16"
T, N, H = 6, 4, 32
CONVERT = {"arm": arm_state_dict, "ai2thor": ai2thor_state_dict}
POLICY_CONVERT = {"arms": arm_policy_state_dict,
                  "ai2thor": ai2thor_policy_state_dict}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.array(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                    else x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _reward_steps(d: int) -> float:
    """The reward-derived tolerance in EPS of the scale (module docstring)."""
    return 2 * np.sqrt(d) * EMBED_EPS


def _close_bf16(got, want, name, jax_gap=None, steps=2.0):
    """|port - JAX bf16| <= `steps` EPS of the scale, and inside JAX's own
    bf16-vs-float32 gap when one is given and above float32 noise."""
    got, want = _np(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    gap = jax_gap is not None and jax_gap > 1e-5 * scale
    print(f"{name}: port-vs-JAX {err / scale / EPS:.3f} EPS of scale "
          f"{scale:.3e}" + (f", {err / jax_gap:.3f} of JAX's gap" if gap
                            else ""))
    assert err <= steps * EPS * scale, name
    if gap:
        assert err < jax_gap, name


def _configs(env, **extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env=env)
        cfg.override(**extra)
        out.append(cfg)
    return out


# -- the encoders ------------------------------------------------------------


def test_conv_and_dense_round_as_flax():
    """One Conv and one Dense at bf16 against flax's: the product is
    rounded to bf16 before the bias is added, so the outputs agree
    element for element except where the two float32 sums of the same
    bf16 products fall on either side of a rounding boundary (at most one
    bf16 step, in under 1% of the elements; rounding once after the bias
    would differ in about a quarter of them)."""
    import flax.linen as fnn

    from var_tpu_torch.models.encoders import conv, dense

    rng = np.random.RandomState(2)
    x = rng.rand(4, 3, 24, 24).astype(np.float32)
    jconv = fnn.Conv(16, (3, 3), padding=((1, 1), (1, 1)), dtype=jnp.bfloat16)
    p = jax.tree_util.tree_map(np.asarray, jconv.init(
        jax.random.PRNGKey(0), x.transpose(0, 2, 3, 1)))
    p["params"]["bias"] = rng.randn(16).astype(np.float32) * 0.3
    want = np.asarray(jconv.apply(p, x.transpose(0, 2, 3, 1)).astype(
        jnp.float32)).transpose(0, 3, 1, 2)
    layer = torch.nn.Conv2d(3, 16, 3, padding=1)
    layer.load_state_dict({
        "weight": _t(p["params"]["kernel"].transpose(3, 2, 0, 1)),
        "bias": _t(p["params"]["bias"])})
    flat = rng.randn(8, 40).astype(np.float32)
    jdense = fnn.Dense(24, dtype=jnp.bfloat16)
    q = jax.tree_util.tree_map(np.asarray, jdense.init(
        jax.random.PRNGKey(1), flat))
    q["params"]["bias"] = rng.randn(24).astype(np.float32) * 0.3
    linear = torch.nn.Linear(40, 24)
    linear.load_state_dict({"weight": _t(q["params"]["kernel"].T),
                            "bias": _t(q["params"]["bias"])})
    with torch.no_grad():
        pairs = (
            ("conv", conv(layer, _t(x), torch.bfloat16), want),
            ("dense", dense(linear, _t(flat), torch.bfloat16),
             np.asarray(jdense.apply(q, flat).astype(jnp.float32))))
    for name, got, want in pairs:
        assert got.dtype == torch.bfloat16, name
        got = _np(got)
        differ = got != want
        print(f"{name}: {differ.mean():.2e} of the elements differ")
        assert differ.mean() < 0.01, name
        np.testing.assert_array_less(np.abs(got - want)[differ],
                                     2 * EPS * np.abs(want)[differ] + 1e-30)


@pytest.mark.parametrize("variant", ["arm", "ai2thor"])
def test_encoders_match_jax(variant):
    rng = np.random.RandomState(0)
    img = rng.rand(8, 3, 96, 96).astype(np.float32)
    snd = rng.randn(8, 1, 100, 40).astype(np.float32)
    j32 = JaxVAR(variant=variant, representation_dim=3, dtype=jnp.float32)
    j16 = JaxVAR(variant=variant, representation_dim=3, dtype=jnp.bfloat16)
    params = jax.jit(j32.init)(jax.random.PRNGKey(0), img, snd, snd)
    want32 = jax.jit(j32.apply)(params, img, snd, snd)
    want16 = jax.jit(j16.apply)(params, img, snd, snd)
    model = VARPretextNet(3, variant, torch.bfloat16)
    model.load_state_dict(CONVERT[variant](
        jax.tree_util.tree_map(np.asarray, params["params"])))
    with torch.no_grad():
        got = model(_t(img), _t(snd), _t(snd))
    assert got["image_feat_raw"].dtype == torch.bfloat16
    assert got["pos_sound_raw"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for k in ("image_feat", "sound_feat_positive", "sound_feat_negative"):
        assert got[k].dtype == torch.float32
        g, w16, w32 = _np(got[k]), np.asarray(want16[k]), np.asarray(want32[k])
        err, gap = np.abs(g - w16), np.abs(w16 - w32)
        print(f"{variant} {k}: port-vs-JAX max {err.max() / EPS:.3f} EPS, "
              f"mean {err.mean():.3e}; JAX bf16-vs-f32 mean {gap.mean():.3e}")
        assert err.max() <= EMBED_EPS * EPS, k
        assert err.mean() <= gap.mean() / 2, k


# -- the policies ------------------------------------------------------------


def _policy_obs(env, rng, n):
    obs = {"image": rng.randint(0, 256, (n, 3, 96, 96)).astype(np.uint8),
           "image_feat": rng.randn(n, 3).astype(np.float32),
           "goal_sound_feat": rng.randn(n, 3).astype(np.float32)}
    if env == "arms":
        obs["robot_pose"] = rng.randn(n, 2).astype(np.float32)
    else:
        obs["occupancy"] = rng.choice([0, 128, 255], (n, 1, 9, 9)).astype(
            np.uint8)
    return obs


@pytest.fixture(scope="module", params=["arms", "ai2thor"])
def policies(request):
    """JAX's policy at bf16 and at float32 from one draw, and the port's at
    bf16 from the same parameters."""
    env = request.param
    knobs = dict(RLRecurrentSize=H, RLRecurrentInputSize=16,
                 RLActionHiddenSize=32)
    spaces = ((JBox(-np.ones(2), np.ones(2)), Box(-np.ones(2), np.ones(2)))
              if env == "arms" else (JDiscrete(8), Discrete(8)))
    j16cfg, tcfg = _configs(env, computeDtype=BF16, **knobs)
    j32cfg, _ = _configs(env, **knobs)
    j16 = jpolicy.build_policy(j16cfg, spaces[0])
    j32 = jpolicy.build_policy(j32cfg, spaces[0])
    obs = {k: jnp.asarray(v)
           for k, v in _policy_obs(env, np.random.RandomState(0), N).items()}
    variables = jax.jit(j32.init, static_argnums=4)(
        jax.random.PRNGKey(0), obs, jnp.zeros((N, H)), jnp.ones((N, 1)), 1)
    tpol = tpolicy.build_policy(tcfg, spaces[1])
    tpol.load_state_dict(POLICY_CONVERT[env](
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return env, j16, j32, variables, tpol


def test_policy_convs_run_in_bf16(policies):
    env, _, _, _, tpol = policies
    assert tpol.base.dtype == torch.bfloat16
    # uint8 pixels scale in bf16 in JAX's order: the bf16 cast, then the
    # product with 1/255 rounded to bf16
    u8 = torch.arange(256, dtype=torch.uint8)
    want = np.asarray(jnp.arange(256, dtype=jnp.uint8).astype(jnp.bfloat16)
                      * (1.0 / 255.0)).astype(np.float32)
    got = tpolicy._norm_img(u8, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


def test_policy_act_matches_jax(policies):
    env, j16, j32, variables, tpol = policies
    rng = np.random.RandomState(1)
    obs = _policy_obs(env, rng, N)
    hx = rng.randn(N, H).astype(np.float32)
    masks = np.array([[1.0], [0.0], [1.0], [1.0]], np.float32)
    key = jax.random.PRNGKey(5)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    want = jpolicy.act(j16, variables, jobs, jnp.asarray(hx),
                       jnp.asarray(masks), key)
    want32 = jpolicy.act(j32, variables, jobs, jnp.asarray(hx),
                         jnp.asarray(masks), key)
    if env == "arms":
        noise = jax.random.normal(key, (N, 2), jnp.float32)
    else:
        noise = jax.random.gumbel(key, (N, 8), jnp.float32)
    got = tpolicy.act(tpol, {k: _t(v) for k, v in obs.items()}, _t(hx),
                      _t(masks), noise=_t(noise))
    if env == "ai2thor":
        np.testing.assert_array_equal(got.action.numpy(),
                                      np.asarray(want.action))
    for name, g, w, w32 in zip(got._fields, got, want, want32):
        gap = float(np.abs(np.asarray(w) - np.asarray(w32)).max())
        _close_bf16(g, w, f"{env} act {name}",
                    jax_gap=None if name == "action" and env == "ai2thor"
                    else gap)


def test_policy_evaluate_actions_matches_jax(policies):
    env, j16, j32, variables, tpol = policies
    rng = np.random.RandomState(9)
    steps = 3
    obs = _policy_obs(env, rng, steps * N)
    hx = rng.randn(N, H).astype(np.float32)
    masks = np.ones((steps * N, 1), np.float32)
    masks[N:N + 2] = 0.0
    actions = (rng.uniform(-1, 1, (steps * N, 2)).astype(np.float32)
               if env == "arms" else
               rng.randint(0, 8, (steps * N, 1)).astype(np.int32))
    args = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(hx),
            jnp.asarray(masks), jnp.asarray(actions), steps)
    want = jpolicy.evaluate_actions(j16, variables, *args)
    want32 = jpolicy.evaluate_actions(j32, variables, *args)
    got = tpolicy.evaluate_actions(tpol, {k: _t(v) for k, v in obs.items()},
                                   _t(hx), _t(masks), _t(actions), steps)
    for name, g, w, w32 in zip(("values", "log_probs", "entropy"), got, want,
                               want32):
        gap = float(np.abs(np.asarray(w) - np.asarray(w32)).max())
        _close_bf16(g, w, f"{env} evaluate {name}", jax_gap=gap)


# -- one pretext step per profile --------------------------------------------


def _pretext_step(env, variant, root):
    """One step of each package's _train_step_indexed at bf16 from the same
    parameters, bank and indices; returns the losses, the port's trainer
    and both parameter sets after the step."""
    B = 4
    jcfg, tcfg = _configs(env, computeDtype=BF16, audioBackend="pallas",
                          sound_dim=(1, 100, 40), pretextTrainBatchSize=B,
                          pretextModelSaveDir=os.path.join(root, "var"))
    jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
    jaudio.loadData()
    taudio.loadData()
    bank, lengths, ranges = taudio.build_clip_bank()
    n_classes = len(ranges)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (6, 3, 96, 96)).astype(np.uint8)
    img_idx = rng.randint(0, 6, B)
    pos = taudio.sample_clip_ids(rng.randint(0, n_classes, B), ranges, rng)
    neg = taudio.sample_clip_ids(rng.randint(0, n_classes, B), ranges, rng)
    idx = (img_idx, *pos, *neg)

    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    jtr._ensure_audio()
    params0 = jtr.init_model(seed=0)["params"]
    jtr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=1)
    state = jpretext.TrainState(params0, jtr.tx.init(params0),
                                jnp.asarray(0, jnp.int32))
    sd0 = CONVERT[variant](jax.tree_util.tree_map(np.asarray, params0))
    state, jloss = jtr._train_step_indexed(
        state, jnp.asarray(images), jnp.asarray(bank), jnp.asarray(lengths),
        *(jnp.asarray(a) for a in idx))

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = tbuild(tcfg)
    ttr.model.load_state_dict(sd0)
    ttr.setup_optimizer(steps_per_epoch=1)
    tbank = {"images": torch.from_numpy(images),
             "wav": torch.from_numpy(bank), "len": torch.from_numpy(lengths)}
    tloss = ttr._train_step_indexed(tbank, *(torch.from_numpy(
        a.astype(bool if a.dtype == bool else np.int64)) for a in idx))
    want = CONVERT[variant](jax.tree_util.tree_map(np.asarray, state.params))
    return float(jloss), tloss.item(), ttr, want, tcfg


def _assert_adam_step(got_sd, want_sd, lr, opt_steps):
    diffs = torch.cat([(got_sd[k].float() - v).abs().ravel()
                       for k, v in want_sd.items()])
    print(f"params: max {diffs.max():.3e}, median {diffs.median():.3e}, "
          f"lr {lr}")
    assert diffs.max().item() <= 2 * lr * opt_steps + 5e-5
    assert diffs.median().item() <= lr / 10 * opt_steps


@pytest.mark.parametrize("env,variant", [("arms", "arm"),
                                         ("ai2thor", "ai2thor")])
def test_pretext_step_matches_jax(env, variant, tmp_path, monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    jloss, tloss, ttr, want, tcfg = _pretext_step(env, variant,
                                                  str(tmp_path))
    print(f"{env} loss: port {tloss:.6f}, JAX {jloss:.6f}")
    assert abs(tloss - jloss) <= 2 * EPS
    got = ttr.model.state_dict()
    assert all(v.dtype == torch.float32 for v in got.values())
    _assert_adam_step(got, want, tcfg.pretextLR, 1)


def test_checkpoint_crosses_dtypes(tmp_path):
    """JAX's arm VAR draw, saved by a bf16 trainer, is float32 on disk; a
    float32 trainer loads it and computes what JAX computes at float32
    from those parameters; its own checkpoint loads back at bf16 and
    computes JAX's bf16 result. A bf16 policy's checkpoint loads into a
    float32 policy unchanged."""
    j32 = JaxVAR(variant="arm", representation_dim=3)
    rng = np.random.RandomState(4)
    img = rng.rand(4, 3, 96, 96).astype(np.float32)
    snd = rng.randn(4, 1, 100, 40).astype(np.float32)
    params = jax.jit(j32.init)(jax.random.PRNGKey(3), img, snd, snd)
    dirs = {d: os.path.join(str(tmp_path), d) for d in ("var16", "var32")}
    _, cfg16 = _configs("arms", computeDtype=BF16,
                        pretextModelSaveDir=dirs["var16"])
    _, cfg32 = _configs("arms", pretextModelSaveDir=dirs["var32"])
    tr16 = tpretext.PretextTrainer(cfg16, device="cpu")
    tr16.init_model()
    tr16.model.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    tr16.save_model(0)
    saved = load_checkpoint(os.path.join(dirs["var16"], "0"))
    assert all(v.dtype == torch.float32 for v in saved["params"].values())
    tr32 = tpretext.PretextTrainer(cfg32, device="cpu")
    m32 = tr32.loadPretextModel(dirs["var16"])
    tr32.save_model(0)
    m16 = tpretext.PretextTrainer(cfg16, device="cpu").loadPretextModel(
        dirs["var32"])
    assert (m32.dtype, m16.dtype) == (torch.float32, torch.bfloat16)
    for model, dtype, atol in ((m32, jnp.float32, 1e-4),
                               (m16, jnp.bfloat16, EMBED_EPS * EPS)):
        want = JaxVAR(variant="arm", representation_dim=3,
                      dtype=dtype).apply(params, img, snd, snd)
        with torch.no_grad():
            got = model(_t(img), _t(snd), _t(snd))
        for k in ("image_feat", "sound_feat_positive"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=0, atol=atol, err_msg=k)

    _, tpcfg = _configs("arms", computeDtype=BF16, RLRecurrentSize=H,
                        RLRecurrentInputSize=16)
    pol16 = tpolicy.build_policy(tpcfg, Box(-np.ones(2), np.ones(2)))
    pol16.reset_parameters(torch.Generator().manual_seed(0))
    path = os.path.join(str(tmp_path), "policy")
    save_checkpoint(path, {"params": pol16.state_dict()})
    tpcfg.override(computeDtype="float32")
    pol32 = tpolicy.build_policy(tpcfg, Box(-np.ones(2), np.ones(2)))
    pol32.load_state_dict(load_checkpoint(path)["params"])
    assert pol32.base.dtype == torch.float32
    for k, v in pol16.state_dict().items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(pol32.state_dict()[k], v, rtol=0, atol=0)


# -- the arm device sim and a PPO update -------------------------------------


def test_device_sim_collect_and_update_match_jax(monkeypatch):
    """One DeviceSimEngine.collect at N = 4, T = 6, GRU 32 at bf16 from the
    same weights and draws (the port's sim applies JAX's sampled actions),
    then one PPO.update of each package's batch with the same env
    permutations."""
    from test_torch_device_sim import _jax_collect_draws

    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    knobs = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
                 RLRecurrentSize=H, RLRecurrentInputSize=16,
                 vecEnvBackend="dummy", computeDtype=BF16)
    jcfg, tcfg = _configs("arms", **knobs)
    for mod, cfg in ((jconfig, jcfg), (tconfig, tcfg)):
        mod.gym_register(cfg, env="arms")
    var_model = build_pretext_model(jcfg)
    var_params = jax.jit(lambda key: init_pretext_params(
        var_model, jcfg, key))(jax.random.PRNGKey(0))["params"]
    jpol = jpolicy.build_policy(jcfg, JBox(-np.ones(2), np.ones(2)))
    obs = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
           "image_feat": jnp.zeros((N, 3)), "robot_pose": jnp.zeros((N, 2)),
           "goal_sound_feat": jnp.zeros((N, 3))}
    policy_params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(1), obs, jnp.zeros((N, H)), jnp.ones((N, 1)),
        1)["params"]
    jeng = JEngine(var_model, var_params, jpol, jcfg, T, N)
    tvar = tbuild(tcfg)
    tvar.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, var_params)))
    tvar.eval().requires_grad_(False)
    tpol = tpolicy.build_policy(tcfg, Box(-np.ones(2), np.ones(2)))
    tpol.load_state_dict(arm_policy_state_dict(
        jax.tree_util.tree_map(np.asarray, policy_params)))
    teng = DeviceSimEngine(tvar, tpol, tcfg, T, N)
    assert tvar.dtype == tpol.base.dtype == torch.bfloat16

    key = jax.random.PRNGKey(2)
    jrms, jbatch, jstats = jeng.collect(jinit_rms(N), policy_params, key)
    trms, tbatch, tstats = teng.collect(
        init_rms(N), _jax_collect_draws(key, teng.k),
        _t(jbatch["actions"]))
    np.testing.assert_array_equal(_np(tbatch["obs"]["image"]),
                                  np.asarray(jbatch["obs"]["image"]))
    np.testing.assert_allclose(_np(tbatch["obs"]["robot_pose"]),
                               np.asarray(jbatch["obs"]["robot_pose"]),
                               rtol=0, atol=1e-6)
    for name in ("image_feat", "goal_sound_feat"):
        err = np.abs(_np(tbatch["obs"][name])
                     - np.asarray(jbatch["obs"][name])).max()
        print(f"collect {name}: {err / EPS:.3f} EPS")
        assert err <= EMBED_EPS * EPS, name
    for name in ("value_preds", "old_log_probs"):
        _close_bf16(tbatch[name], jbatch[name], f"collect {name}")
    steps = _reward_steps(tcfg.representationDim)
    _close_bf16(tbatch["returns"], jbatch["returns"], "collect returns",
                steps=steps)
    _close_bf16(tstats, jstats, "collect raw reward sums", steps=steps)
    for f, got, want in zip(trms._fields, trms, jrms):
        _close_bf16(got, want, f"collect rms.{f}", steps=steps)

    jp = jppo.PPO(jpol, jppo.PPOConfig.from_config(jcfg))
    ukey = jax.random.PRNGKey(11)
    perms, k = [], ukey
    for _ in range(jcfg.ppoEpoch):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, N)))
    jstate, jmetrics = jp.update(jp.init_state(jax.tree_util.tree_map(
        jnp.array, policy_params)), jbatch, ukey)
    port = tppo.PPO(tpol, tppo.PPOConfig.from_config(tcfg))
    state, metrics = port.update(port.init_state(), tbatch,
                                 torch.from_numpy(np.stack(perms)).long())
    for name, v in metrics.items():
        want = float(jmetrics[name])
        print(f"update {name}: port {float(v):.6f}, JAX {want:.6f}")
        assert abs(float(v) - want) <= EPS * max(abs(want), 1.0), name
    want = arm_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        jstate.params))
    _assert_adam_step(state.params, want, tcfg.RLLr,
                      tcfg.ppoEpoch * tcfg.ppoNumMiniBatch)


def test_e2e_run_carries_bf16_to_every_stage(tmp_path, monkeypatch):
    """tools/e2e_run.py with --set computeDtype=bfloat16 (CPU, tiny): the
    VAR it trains, the policy it trains and both evaluators' models are
    built at bf16, the checkpoints are float32, and the run's config
    snapshot carries the dtype, so tools/success_curve.py sweeps the run
    at the dtype it trained at."""
    import json

    from var_tpu_torch.models import encoders
    from var_tpu_torch.tools import e2e_run, success_curve
    from var_tpu_torch.train import rl as trl

    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    built = []

    def recording(build):
        def wrapped(config, *args):
            model = build(config, *args)
            built.append((build.__name__, model))
            return model
        return wrapped

    monkeypatch.setattr(tpretext, "build_pretext_model",
                        recording(encoders.build_pretext_model))
    monkeypatch.setattr(trl, "build_policy",
                        recording(tpolicy.build_policy))
    work = tmp_path / "work"
    e2e_run.main([
        str(work), "--device", "cpu", "--device-sim", "--num-envs", "2",
        "--rl-steps", "8", "--collect-per-class", "2", "--var-epochs", "1",
        "--eval-per-class", "1", "--eval-envs", "1",
        "--device-eval-per-class", "2", "--device-eval-envs", "2",
        "--out", str(tmp_path / "e2e.json"), "--set", "RLEnvMaxSteps=4",
        "RLRecurrentSize=32", "RLRecurrentInputSize=16",
        "pretextEnvMaxSteps=8", f"computeDtype='{BF16}'"])
    names = [n for n, _ in built]
    # pretext; RL, its eval and the device eval each load the VAR and
    # build a policy
    assert names.count("build_pretext_model") >= 4
    assert names.count("build_policy") >= 3
    assert all((m.base if n == "build_policy" else m).dtype == torch.bfloat16
               for n, m in built)
    for ckpt in (work / "var_model" / "0", work / "rl_model" / "00000"):
        assert all(v.dtype == torch.float32
                   for v in load_checkpoint(str(ckpt))["params"].values())
    with open(work / "rl_model" / "config.json") as f:
        assert json.load(f)["computeDtype"] == BF16
    assert "computeDtype" in success_curve.SNAPSHOT_KNOBS


@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_card_checks_rehearse_on_the_cpu(env, monkeypatch):
    """tools/rl_check.py's bf16 checks (chip_smoke.py phase 34) with the
    CPU in the card's place, at small widths: the same computation on
    both sides, so every error is 0 and the report passes; its
    tolerances are this file's."""
    from var_tpu_torch.tools import rl_check

    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    _, cfg = _configs(env, computeDtype=BF16, audioBackend="pallas",
                      pretextTrainBatchSize=4, sound_dim=(1, 100, 40))
    report = rl_check.pretext_card_against_cpu(cfg, card="cpu")
    assert report["ok"] and report["loss"] == 0.0
    assert report["param_median_bound"] == cfg.pretextLR / 10
    _, cfg = _configs(env, computeDtype=BF16, RLTrain=True, ppoNumSteps=4,
                      RLEnvMaxSteps=4, vecEnvBackend="dummy", RLNumEnvs=2,
                      RLRecurrentSize=H, RLRecurrentInputSize=16)
    report = rl_check.card_against_cpu(cfg, card="cpu")
    assert report["ok"] and report["param_max_diff"] == 0.0
    assert rl_check.EMBED_EPS == EMBED_EPS
    # the reward comparison is in units of this file's reward bound
    steps = _reward_steps(cfg.representationDim)
    reward_err = rl_check._errs(cfg)[2]
    assert reward_err(np.float64(0.5 + steps * EPS * 0.25),
                      np.float64(0.5)) == pytest.approx(0.5)
