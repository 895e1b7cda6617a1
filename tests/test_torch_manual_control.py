"""Manual control (RLTrainer.manualControl and run()'s RLManualControl
dispatch) against the JAX package on the CPU: one env under the VAR reward
wrapper, driven by a scripted command stream.

Both trainers get the same VAR weights (JAX's fresh init, converted) and
the same config and seed; the stream holds valid commands, an empty line
(the last command again), an unknown key or malformed 'dx dy', and ends in
'quit' or the end of the input. The printed lines are held: the step
rewards at rtol = atol = 1e-4 for the arm (IEEE float32 both sides, only
the order of summation differs) and at the CRNN's rtol 1e-3 / atol 2e-4
for the grid (BASELINE.md), every other line equal. Reduced sizes: the
grid's sound at (1, 100, 40) (the CRNN runs at any length).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.models.encoders import init_pretext_params
from var_tpu.train import rl as jrl
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_state_dict, arm_state_dict
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.train import rl as trl

TOL = {"arms": dict(rtol=1e-4, atol=1e-4),
       "ai2thor": dict(rtol=1e-3, atol=2e-4)}
STREAMS = {
    # grid keys (keyBoardMapping), '' repeats, 'x' is unknown, then quit
    "ai2thor": ["w", "d", "", "x", "a", "w", "e", "s", "quit", "w"],
    # arm 'dx dy' lines, '' repeats, malformed input, then the end
    "arms": ["0.5 0.0", "0 -0.7", "", "left", "1 2 3", "-1 1", "0.2 0.2"],
}
KNOBS = {"ai2thor": dict(sound_dim=(1, 100, 40), RLEnvMaxSteps=5),
         "arms": dict(RLEnvMaxSteps=4)}


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(env, tmp_path, **extra):
    out = []
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env=env)
        cfg.override(RLTrain=False, RLManualControl=True,
                     vecEnvBackend="dummy",
                     episodeImgSaveDir=str(tmp_path / tag),
                     **{**KNOBS[env], **extra})
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    return out


def _script(lines):
    it = iter(lines)

    def read():
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    return read


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("step reward", "unknown key", "expected"))]


@pytest.mark.parametrize("env", ["ai2thor", "arms"])
def test_manual_control_prints_jax_step_rewards(env, tmp_path, capsys):
    jcfg, tcfg = _configs(env, tmp_path)
    jtr = jrl.RLTrainer(jcfg, env=env)
    jtr.pretext_params = init_pretext_params(
        jtr.pretext_model, jcfg, jax.random.PRNGKey(0))["params"]
    convert = ai2thor_state_dict if env == "ai2thor" else arm_state_dict
    ttr = trl.RLTrainer(tcfg, env=env, device="cpu")
    tvar = VARPretextNet(jcfg.representationDim, "ai2thor" if env ==
                         "ai2thor" else "arm")
    tvar.load_state_dict(convert(jax.tree_util.tree_map(
        np.asarray, jtr.pretext_params)))
    ttr.pretext_model = tvar.eval().requires_grad_(False)

    capsys.readouterr()
    jtr.manualControl(input_fn=_script(STREAMS[env]))
    want = _lines(capsys.readouterr().out)
    ttr.manualControl(input_fn=_script(STREAMS[env]))
    got = _lines(capsys.readouterr().out)

    assert len(got) == len(want) >= 5
    assert any(ln.startswith(("unknown key", "expected")) for ln in got)
    for g, w in zip(got, want):
        if w.startswith("step reward"):
            np.testing.assert_allclose(float(g.split()[-1]),
                                       float(w.split()[-1]), **TOL[env])
        else:
            assert g == w
    # the live frame, as a PNG (the JAX package's is a JPEG)
    assert os.listdir(tmp_path / "port") == ["manual_live.png"]
    assert os.listdir(tmp_path / "jax") == ["manual_live.jpg"]


def test_run_dispatches_manual_control_with_a_fresh_var(tmp_path,
                                                        monkeypatch, capsys):
    """RLManualControl without a VAR to load (RLManualControlLoaded False):
    run() builds a fresh VAR from an explicit generator and reads commands
    from stdin until its end."""
    _, tcfg = _configs("ai2thor", tmp_path, RLManualControlLoaded=False,
                       pretextModelLoadDir=str(tmp_path / "absent"))
    monkeypatch.setattr("builtins.input", lambda prompt="": _next())
    stream = iter(["w", "a", "w"])

    def _next():
        try:
            return next(stream)
        except StopIteration:
            raise EOFError from None

    trl.RLTrainer(tcfg, env="ai2thor", device="cpu").run()
    out = capsys.readouterr().out
    rewards = [float(x) for x in re.findall(r"step reward (\S+)", out)]
    assert len(rewards) == 3 and np.isfinite(rewards).all()
    assert (tmp_path / "port" / "manual_live.png").exists()
