"""The port's RL slice against the JAX package on the CPU: the fused
rollout engine over one host-env stream, deterministic evaluation from one
converted checkpoint, and SKILL.md stages 2-3 through
`python -m var_tpu_torch.rl --device cpu` (port only), with resume.
Reduced widths: GRU 32, GRU input 16, action hidden 32, 96x96 images,
N = 4 envs, T = 3 steps per rollout.

Tolerance rtol = atol = 1e-4: float32 on both sides, only the order of
summation differs. Sampled actions take JAX's Gaussian draws as `noise`.
The env stream is driven by the JAX engine's actions, so both engines see
the same observations; uint8 images and host-side integers must be equal.
"""
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.envs.vec.dummy import DummyVecEnv as JDummyVecEnv
from var_tpu.models import policy as jpolicy
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.rl.rollout_device import DeviceRolloutEngine as JEngine
from var_tpu.train import checkpoint as jckpt
from var_tpu.train import rl as jrl
from var_tpu_torch import config as tconfig
from var_tpu_torch.cli import build_config, parse_args
from var_tpu_torch.convert import arm_policy_state_dict, arm_state_dict
from var_tpu_torch.envs.vec.dummy import DummyVecEnv as TDummyVecEnv
from var_tpu_torch.envs.vec.factory import make_vec_envs
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.rl import main as rl_main
from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine as TEngine
from var_tpu_torch.tools.rl_check import card_against_cpu
from var_tpu_torch.train import rl as trl
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N, T = 4, 3
SMALL = dict(RLNumEnvs=N, RLEnvMaxSteps=T, ppoNumSteps=T,
             RLRecurrentSize=32, RLRecurrentInputSize=16,
             RLActionHiddenSize=32, vecEnvBackend="dummy")
# the keys _train_fused logs (var_tpu/train/rl.py:405-423)
PROGRESS_COLUMNS = [
    "misc/nupdates", "misc/total_timesteps", "fps", "eprewmean", "min", "max",
    "loss/policy_entropy", "loss/policy_loss", "loss/value_loss", "lr",
    "perf/fused_step_ms", "perf/env_step_ms", "perf/ppo_update_ms",
    "perf/host_rss_gb"]
# _finish_eval's schema (var_tpu/train/rl.py:674-679)
EVAL_COLUMNS = ["objIdx", "goal area count", "rewards", "results"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several test workers on one machine; torch's
    default of a thread per core in each of them oversubscribes the cores,
    and the small eager ops here then slow down more than tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _synthetic_clips(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")


def _configs(**extra):
    """(JAX config, port config) with the same knobs, envs registered."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="arms")
        cfg.override(**{**SMALL, **extra})
        mod.gym_register(cfg)
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def nets():
    """JAX VAR and policy params from one key each, and the port's
    modules holding them."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    var_model = build_pretext_model(jcfg)
    # jitted: flax's eager init dispatches op by op, several times slower
    var_params = jax.jit(lambda key: init_pretext_params(
        var_model, jcfg, key))(jax.random.PRNGKey(3))["params"]
    tvar = VARPretextNet(3)
    tvar.load_state_dict(arm_state_dict(
        jax.tree_util.tree_map(np.asarray, var_params)))
    tvar.eval().requires_grad_(False)

    from var_tpu.envs.spaces import Box

    jpol = jpolicy.build_policy(jcfg, Box(low=-np.ones(2), high=np.ones(2)))
    obs = {"image": jnp.zeros((N, 3, 96, 96), jnp.uint8),
           "image_feat": jnp.zeros((N, 3)), "robot_pose": jnp.zeros((N, 2)),
           "goal_sound_feat": jnp.zeros((N, 3))}
    policy_params = jax.jit(jpol.init, static_argnums=4)(
        jax.random.PRNGKey(4), obs, jnp.zeros((N, 32)), jnp.ones((N, 1)),
        1)["params"]
    sd = arm_policy_state_dict(jax.tree_util.tree_map(np.asarray,
                                                      policy_params))
    return var_model, var_params, tvar, jpol, policy_params, sd


def _port_policy(tcfg, sd):
    from var_tpu_torch.envs.spaces import Box
    from var_tpu_torch.models.policy import build_policy

    pol = build_policy(tcfg, Box(low=-np.ones(2), high=np.ones(2)))
    pol.load_state_dict(sd)
    return pol


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _assert_buffers_match(tengine, jengine):
    for name, got in tengine.buffers.as_dict().items():
        want = np.asarray(getattr(jengine.buffers, name))
        if got.dtype == torch.uint8:
            np.testing.assert_array_equal(_np(got), want, err_msg=name)
        else:
            np.testing.assert_allclose(_np(got), want, err_msg=name, **TOL)


@pytest.mark.parametrize("deterministic", [False, True])
def test_fused_engine_matches_jax(nets, deterministic):
    """2 x T steps with a rollout boundary (GAE, after_update) between,
    episodes ending (fresh goals) at every T-th step."""
    var_model, var_params, tvar, jpol, policy_params, sd = nets
    jcfg, tcfg = _configs(RLTrain=True)
    envs = make_vec_envs(tcfg.RLEnvName, tcfg.RLEnvSeed, N, None, True, tcfg)
    common = (T, N, "robot_pose", (2,))
    jengine = JEngine(var_model, var_params, jpol, jcfg, *common,
                      jnp.float32, (2,), jnp.float32, gamma=0.99,
                      deterministic=deterministic)
    jengine.set_policy_params(policy_params)
    tengine = TEngine(tvar, _port_policy(tcfg, sd), tcfg, *common,
                      torch.float32, (2,), torch.float32, gamma=0.99,
                      deterministic=deterministic)

    key = jax.random.PRNGKey(5)

    def noise(k):  # the draw jax sample() makes from k
        return torch.from_numpy(np.array(jax.random.normal(k, (N, 2))))

    raw_obs = envs.reset()
    key, sub = jax.random.split(key)
    action = jengine.init(raw_obs, sub)
    np.testing.assert_allclose(tengine.init(raw_obs, noise(sub)), action,
                               **TOL)
    for rollout in range(2):
        for t in range(T):
            raw_obs, env_rew, done, infos = envs.step(action)
            bad = np.asarray([0.0 if "bad_transition" in i else 1.0
                              for i in infos], np.float32)
            key, sub = jax.random.split(key)
            action, jrew = jengine.step(t, raw_obs, env_rew, done, bad, sub)
            taction, trew = tengine.step(t, raw_obs, env_rew, done, bad,
                                         noise(sub))
            np.testing.assert_allclose(taction, action, **TOL)
            np.testing.assert_allclose(trew, jrew, **TOL)
        assert done.all()  # every env started a fresh episode here
        _assert_buffers_match(tengine, jengine)
        for engine in (jengine, tengine):
            engine.compute_returns(True, 0.99, 0.95, False)
        np.testing.assert_allclose(_np(tengine.device_batch()["returns"]),
                                   np.asarray(jengine._returns), **TOL)
        for engine in (jengine, tengine):
            engine.after_update()
        _assert_buffers_match(tengine, jengine)
    envs.close()


def _record_actions(monkeypatch, cls):
    seen = []
    orig = cls.step_async

    def spy(self, actions):
        seen.append(np.array(actions, np.float32))
        return orig(self, actions)

    monkeypatch.setattr(cls, "step_async", spy)
    return seen


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_deterministic_eval_matches_jax(nets, tmp_path, monkeypatch):
    """testRL on one checkpoint (Orbax for JAX, converted for the port):
    the same action at every step and the same success CSV."""
    var_model, var_params, tvar, jpol, policy_params, sd = nets
    size = {"dataset": ["GoogleCommand"], "max_sound_dur": {
        "GoogleCommand": 6.0}, "items": {"GoogleCommand": [
            "zero", "one", "two", "three"]}, "size": {
        "GoogleCommand": [1, 1, 1, 1]}, "train_test": "train"}
    jcfg, tcfg = _configs(RLTrain=False, RLEnvMaxSteps=4, soundSource=size,
                          RLModelSaveDir=str(tmp_path))
    jpath, tpath = str(tmp_path / "jax" / "00007"), str(tmp_path / "port" / "00007")
    jckpt.save_checkpoint(jpath, {"params": policy_params})
    save_checkpoint(tpath, {"params": sd})

    jactions = _record_actions(monkeypatch, JDummyVecEnv)
    jtr = jrl.RLTrainer(jcfg, env="arms")
    jtr.pretext_params = var_params
    jrate = jtr.testRL(policy_path=jpath, num_envs=2)

    tactions = _record_actions(monkeypatch, TDummyVecEnv)
    ttr = trl.RLTrainer(tcfg, env="arms", device="cpu")
    ttr.pretext_model = tvar
    trate = ttr.testRL(policy_path=tpath, num_envs=2)

    assert len(tactions) == len(jactions) == 4 * 4  # 4 classes x 4 steps
    for got, want in zip(tactions, jactions):
        np.testing.assert_allclose(got, want, **TOL)
    jhead, jrows = _read_csv(str(tmp_path / "jax" / "test_00007.csv"))
    thead, trows = _read_csv(str(tmp_path / "port" / "test_00007.csv"))
    assert thead == jhead == EVAL_COLUMNS and len(trows) == len(jrows) == 8
    for trow, jrow in zip(trows, jrows):
        assert [int(trow[0]), int(trow[1]), int(trow[3])] == [
            int(jrow[0]), int(jrow[1]), int(jrow[3])]
        np.testing.assert_allclose(float(trow[2]), float(jrow[2]), **TOL)
    assert trate == jrate
    np.testing.assert_array_equal(
        trl._eval_size_per_class(tcfg), jrl._eval_size_per_class(jcfg))


def _skill_args(root, *extra):
    return [
        "--env", "arms", "--device", "cpu", "--set",
        f'pretextModelLoadDir="{root}/var_model/2"',
        f'RLModelSaveDir="{root}/rl_model"', 'vecEnvBackend="dummy"',
        "RLEnvMaxSteps=6", "ppoNumSteps=6", "RLRecurrentSize=64",
        "RLRecurrentInputSize=32", *extra]


STAGE2 = ("RLTrain=True", "RLModelFineTune=False", "RLNumEnvs=2",
          "RLTotalSteps=48", "ppoNumMiniBatch=2", "ppoEpoch=2",
          "RLModelSaveInterval=1", "RLLogInterval=1")


@pytest.fixture
def var_checkpoint(tmp_path):
    """A port pretext checkpoint, as stage 1 saves it."""
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "var_model" / "2"),
                    {"params": model.state_dict(), "step": 0})
    return tmp_path


def test_skill_stages_2_and_3_through_the_cli(var_checkpoint):
    root = var_checkpoint
    trainer = rl_main(_skill_args(root, *STAGE2))
    assert trainer.device.type == "cpu" and len(trainer.update_stats) == 4
    saved = sorted(os.listdir(root / "rl_model"))
    assert saved == ["00000", "00001", "00002", "00003", "config.json",
                     "progress.csv"]
    head, rows = _read_csv(str(root / "rl_model" / "progress.csv"))
    assert head == PROGRESS_COLUMNS and len(rows) == 4
    assert all(np.isfinite(float(r[head.index("loss/value_loss")]))
               for r in rows)

    # stage 3 as a user runs it: a fresh process, python -m
    stage3 = _skill_args(
        root, "RLTrain=False", "RLModelFineTune=False",
        f'skillInfos=[{{"path": "{root}/rl_model/00003", "actionDim": 2}}]',
        'soundSource={"dataset": ["GoogleCommand"], "max_sound_dur": '
        '{"GoogleCommand": 6.0}, "items": {"GoogleCommand": ["zero", "one", '
        '"two", "three"]}, "size": {"GoogleCommand": [1, 1, 1, 1]}, '
        '"train_test": "train"}')
    env = dict(os.environ, PYTHONPATH=ROOT, VAR_TPU_SYNTH_CLIPS="4",
               OMP_NUM_THREADS="1")  # see _one_torch_thread
    proc = subprocess.run([sys.executable, "-m", "var_tpu_torch.rl", *stage3],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "success rate" in proc.stdout
    head, rows = _read_csv(str(root / "rl_model" / "test_00003.csv"))
    assert head == EVAL_COLUMNS and len(rows) == 4
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3]


def test_resume_continues_adam_state_and_labels(var_checkpoint):
    root = var_checkpoint
    first = rl_main(_skill_args(root, *STAGE2, "RLTotalSteps=24"))
    ckpt = load_checkpoint(str(root / "rl_model" / "00001"))
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2 * 2 * 2
    for k, mu in first.state.opt_state.mu.items():
        torch.testing.assert_close(ckpt["opt_state"]["mu"][k], mu,
                                   rtol=0, atol=0)
        torch.testing.assert_close(ckpt["params"][k],
                                   first.policy.state_dict()[k],
                                   rtol=0, atol=0)

    args = _skill_args(root, *STAGE2, "RLTotalSteps=12")
    args[args.index("RLModelFineTune=False")] = "RLModelFineTune=True"
    args.append(f'RLModelLoadDir="{root}/rl_model/00001"')
    cfg = build_config(parse_args(args), role="RL")
    resumed = trl.RLTrainer(cfg, device="cpu")
    resumed.load_pretext()
    envs, _, _ = resumed.setup_fused()
    envs.close()
    state = resumed.state
    assert (state.step, state.opt_state.count) == (2, 8)
    for k in ckpt["opt_state"]["mu"]:
        for name in ("mu", "nu"):
            torch.testing.assert_close(getattr(state.opt_state, name)[k],
                                       ckpt["opt_state"][name][k],
                                       rtol=0, atol=0)
        torch.testing.assert_close(state.params[k], ckpt["params"][k],
                                   rtol=0, atol=0)
    resumed.trainRL()
    assert os.path.isdir(root / "rl_model" / "00002")  # labels continue
    assert load_checkpoint(str(root / "rl_model" / "00002"))["step"] == 3


@pytest.mark.parametrize("knob,value", [("meshShape", {"dp": 2})])
def test_unported_modes_raise_naming_their_roadmap_item(knob, value):
    _, tcfg = _configs(RLTrain=True, **{knob: value})
    trainer = trl.RLTrainer(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trainer.trainRL()


def test_entry_point_needs_cuda_or_the_cpu_flag(var_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    args = _skill_args(var_checkpoint, *STAGE2)
    args.remove("--device")
    args.remove("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rl_main(args)


def test_manual_control_raises_naming_its_roadmap_item(tmp_path, monkeypatch):
    """Manual control is ported now (tests/test_torch_manual_control.py
    holds it against JAX): run() no longer raises; it drives the env from
    stdin until the input ends and writes the live frame. (The name is
    the one it had while this path raised.)"""
    _, tcfg = _configs(RLManualControl=True, RLTrain=False,
                       episodeImgSaveDir=str(tmp_path))

    def no_input(prompt=""):
        raise EOFError

    monkeypatch.setattr("builtins.input", no_input)
    trl.RLTrainer(tcfg, device="cpu").run()
    assert os.listdir(tmp_path) == ["manual_live.png"]


def test_card_check_rehearses_on_the_cpu():
    """The card-against-CPU check of chip_smoke.py phase 9, with the CPU in
    the card's place: every comparison runs and finds no difference."""
    _, tcfg = _configs(RLTrain=True)
    report = card_against_cpu(tcfg, card="cpu")
    assert report["ok"] and report["param_max_diff"] == 0.0
    assert report["packed"] == report["losses"] == 0.0
