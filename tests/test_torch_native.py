"""The port's native host libraries (var_tpu_torch/native.py, csrc/simcore.cpp)
against the JAX package's (var_tpu/native, native/simcore.cpp): the same
source built with the same flags renders the same bytes; the numpy raycast
stays within tests/test_native.py's bound of it; a failed build raises."""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import var_tpu.config as jconfig
from var_tpu.envs import grid_sim as jgrid
from var_tpu.native import simcore as jax_simcore
from var_tpu_torch import config as tconfig
from var_tpu_torch import native
from var_tpu_torch.envs import grid_sim as tgrid

ROOT = Path(__file__).resolve().parents[1]
N_STATES = 300
NUMPY_PIXEL_BOUND = 0.005  # tests/test_native.py:40: boundary float ties


@pytest.fixture(scope="module")
def sims():
    """(JAX sim, port sim) on the same config, and the JAX library, which
    the JAX package builds with g++ as the port does."""
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        out = []
        for mod, grid in ((jconfig, jgrid), (tconfig, tgrid)):
            cfg = mod.main_config(env="ai2thor")
            cfg.override(sound_dim=(1, 100, 40))
            out.append(grid.GridHouseSim(cfg))
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    jlib = jax_simcore()
    assert jlib is not None, "the JAX package's native library did not build"
    return out[0], out[1], jlib


def _seeded_states(tenv, n, seed):
    """n seeded states of the port's sim: a floor plan, free cell, heading
    and object states each."""
    tenv.seed(seed)
    plans = list(tenv.config.allScene["livingRoom"])
    states = []
    for _ in range(n):
        plan = plans[int(tenv.np_random.randint(len(plans)))]
        tenv.floor_plan = plan
        tenv._build_world()
        tenv._domain_randomization()
        states.append((plan, tenv.pos.copy(), float(tenv.rot),
                       {o: v["isToggled"] for o, v in tenv.objects.items()}))
    return states


def _put(env, state):
    plan, pos, rot, toggled = state
    env.floor_plan = plan
    env._build_world()
    env.pos, env.rot = pos.copy(), rot
    for o, t in toggled.items():
        env.objects[o]["isToggled"] = t


def test_raycast_render_matches_jax_library_byte_for_byte(sims):
    jenv, tenv, jlib = sims
    assert native.simcore() is not None
    for i, state in enumerate(_seeded_states(tenv, N_STATES, 5)):
        _put(jenv, state)
        _put(tenv, state)
        got = tenv.get_image()  # the port's default: its native render
        want = jenv._render_native(jlib)
        assert got.dtype == np.uint8 and got.shape == (96, 96, 3)
        assert got.tobytes() == want.tobytes(), f"state {i}"


def test_native_render_within_bound_of_numpy(sims):
    """The plain version differs at boundary pixels only, within the JAX
    package's own bound (150 states: the numpy render takes about 15 ms a
    frame); most frames are identical."""
    _, tenv, _ = sims
    lib = native.simcore()
    identical = 0
    for i, state in enumerate(_seeded_states(tenv, N_STATES // 2, 6)):
        _put(tenv, state)
        nat, ref = tenv._render_native(lib), tenv._render_numpy()
        frac = np.mean(np.any(nat != ref, axis=-1))
        assert frac < NUMPY_PIXEL_BOUND, f"state {i}: {frac:.4f} differ"
        identical += bool((nat == ref).all())
    assert identical >= N_STATES // 4


def _rotate(lib, window, angle):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = np.empty_like(window)
    win = np.ascontiguousarray(window)
    lib.rotate_crop(win.ctypes.data_as(u8p), window.shape[0],
                    ctypes.c_float(angle), out.ctypes.data_as(u8p))
    return out


def test_rotate_crop_matches_jax_library(sims):
    from scipy import ndimage

    jlib, lib = sims[2], native.simcore()
    rng = np.random.RandomState(0)
    for n in (9, 15):
        window = ((rng.rand(n, n) > 0.5) * 255).astype(np.uint8)
        for angle in (0.0, 45.0, 90.0, 135.0, 180.0, -45.0, 22.5):
            np.testing.assert_array_equal(_rotate(lib, window, angle),
                                          _rotate(jlib, window, angle))
        # the geometry tests/test_native.py checks: identity at 0 degrees,
        # scipy's counterclockwise rotation at 90
        np.testing.assert_array_equal(_rotate(lib, window, 0.0), window)
        np.testing.assert_array_equal(
            _rotate(lib, window, 90.0),
            ndimage.rotate(window, 90.0, reshape=False, order=0))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent numpy: a compiler that is missing, or a source that does
    not compile, raises RuntimeError with the compiler's message."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.build("simcore", force=True)
    monkeypatch.setattr(native, "CXX", "g++")
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="error"):
        native.build("broken")
    assert not list((tmp_path / "build").iterdir())  # no temporary left


def test_no_native_asks_for_the_numpy_render(sims, monkeypatch):
    """VAR_TPU_NO_NATIVE, the JAX package's switch, is the one way to the
    numpy render: get_image then equals _render_numpy where the native
    frame differs from it."""
    _, tenv, _ = sims
    lib = native.simcore()
    for state in _seeded_states(tenv, N_STATES // 2, 6):
        _put(tenv, state)
        if (tenv._render_native(lib) != tenv._render_numpy()).any():
            break
    else:
        pytest.fail("no state where the two renders differ")
    monkeypatch.setenv("VAR_TPU_NO_NATIVE", "1")
    assert native.simcore() is None
    np.testing.assert_array_equal(tenv.get_image(), tenv._render_numpy())
    assert (tenv.get_image() != tenv._render_native(lib)).any()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Processes that build at once (pytest -n) each compile to their own
    temporary and os.replace it: every one loads a whole library."""
    code = "\n".join([
        "import sys",
        "from pathlib import Path",
        "from var_tpu_torch import native",
        "native.BUILD_DIR = Path(sys.argv[1])",
        "native.build('shmbuf', force=True)",
        "lib = native.shmbuf()",
        "assert lib.shmbuf_unlink(b'/var_tpu_torch_no_such_segment') < 0",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
    assert [p.name for p in tmp_path.iterdir()] == ["libshmbuf.so"]
