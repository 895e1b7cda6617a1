"""The VAR probes (var_tpu_torch/tools/var_probe.py, tools/grid_probe.py)
against their JAX scripts (scripts/var_probe.py, scripts/grid_probe.py) on
the CPU, with the same VAR converted from Flax by convert.py, at a tiny
size (one or two layouts; for the grid 6 cells a layout and the CRNN at
sound (1, 100, 40)).

Both sides sweep the same host sims from the same seeds, so they render the
same images and draw the same goal clips. The scores are argmax decisions
over VAR rewards that agree at 1e-4 (IEEE float32 both sides): the peak
and class accuracies are held equal, the arm's mean peak offset (metres,
a mean of grid distances) at 1e-9 absolute, the grid's per-class record
equal.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_state_dict, arm_state_dict
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.tools import grid_probe as tgrid
from var_tpu_torch.tools import var_probe as tvar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    monkeypatch.setenv("VAR_TPU_JIT_CACHE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scripts():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import grid_probe
    import var_probe

    return var_probe, grid_probe


def _twins(env, convert, **knobs):
    """(JAX config, model, params; port config, model) from one init."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env=env)
        cfg.override(RLTrain=True, **knobs)
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    jcfg, tcfg = out
    model = build_pretext_model(jcfg)
    params = jax.jit(lambda key: init_pretext_params(model, jcfg, key))(
        jax.random.PRNGKey(4))["params"]
    tmodel = VARPretextNet(jcfg.representationDim,
                           "ai2thor" if env == "ai2thor" else "arm")
    tmodel.load_state_dict(convert(jax.tree_util.tree_map(np.asarray,
                                                          params)))
    return jcfg, model, params, tcfg, tmodel.eval().requires_grad_(False)


def test_arm_probes_match_the_jax_script():
    jprobe, _ = _scripts()
    jcfg, model, params, tcfg, tmodel = _twins("arms", arm_state_dict)
    want = jprobe.probe(jcfg, model, params, n_layouts=2, verbose=False)
    got = tvar.probe(tcfg, tmodel, n_layouts=2, verbose=False)
    assert got == want
    want2 = jprobe.probe_2d(jcfg, model, params, n_layouts=1, verbose=False)
    got2 = tvar.probe_2d(tcfg, tmodel, n_layouts=1, verbose=False)
    assert got2[0] == want2[0]
    assert got2[1] == pytest.approx(want2[1], abs=1e-9)


def test_grid_probe_matches_the_jax_script():
    _, jprobe = _scripts()
    jcfg, model, params, tcfg, tmodel = _twins(
        "ai2thor", ai2thor_state_dict, sound_dim=(1, 100, 40))
    want = jprobe.probe(jcfg, model, params, n_layouts=1, max_cells=6,
                        verbose=False, return_per_class=True)
    got = tgrid.probe(tcfg, tmodel, n_layouts=1, max_cells=6, verbose=False,
                      return_per_class=True)
    assert got == want
    assert sum(v["n_views"] for v in got[2].values()) > 0
