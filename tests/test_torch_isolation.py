"""The port stands alone: var_tpu_torch and chip_smoke.py import neither
JAX (nor flax, optax, orbax) nor anything of var_tpu, and no pandas,
cloudpickle, cv2, PIL, matplotlib or sklearn, which the GPU machine does
not have; the port loads its own native libraries, never the JAX
package's."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "var_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
             "cloudpickle", "cv2", "PIL", "matplotlib", "sklearn")
VAR_TPU = re.compile(r"\bvar_tpu\b(?!_torch)")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {name}"
        assert not VAR_TPU.search(name), f"{path}: imports {name}"


def test_ai2thor_modules_are_covered():
    """The ai2thor profile's own modules are among those checked here."""
    modules = set(_modules())
    for name in ("config.ai2thor", "envs.grid_sim", "envs.grid_sim_device",
                 "rl.device_sim", "models.policy", "ops.gru"):
        assert f"var_tpu_torch.{name}" in modules


def test_pretext_paths_modules_are_covered():
    """The modules of pretext's chunked, streaming, multi-bank and manual
    paths and of the pipelined rollout are among those checked here."""
    modules = set(_modules())
    for name in ("utils.teleop", "data.triplets", "data.audio_store",
                 "train.pretext", "envs.arm_sim", "envs.grid_sim",
                 "rl.rollout_device", "train.rl", "cli"):
        assert f"var_tpu_torch.{name}" in modules


def test_recording_and_manual_control_modules_are_covered():
    """Episode-image recording, render playback and manual control are
    among the modules checked here."""
    modules = set(_modules())
    for name in ("envs.recording", "utils.audio_play", "train.rl"):
        assert f"var_tpu_torch.{name}" in modules


def test_parallel_modules_are_covered():
    """The meshShape package (parallel/__init__.py, parallel/mesh.py) is
    among the modules scanned and imported with jax and var_tpu blocked
    here."""
    modules = set(_modules())
    for name in ("parallel", "parallel.mesh"):
        assert f"var_tpu_torch.{name}" in modules
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"var_tpu_torch/parallel/__init__.py",
            "var_tpu_torch/parallel/mesh.py"} <= scanned


def test_mesh_cards_tool_is_covered():
    """tools/mesh_cards.py, the across-cards run of meshShape, is among the
    modules scanned and imported with jax and var_tpu blocked here."""
    assert "var_tpu_torch.tools.mesh_cards" in set(_modules())
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert "var_tpu_torch/tools/mesh_cards.py" in scanned


def test_last_modules_are_covered():
    """The plots and realTimeVec's frames, the TensorBoard writer, the
    key-value logger, the small utilities, the fused rollout engine with
    host storage and the bf16 tolerance bound are among the modules
    scanned and imported with jax, var_tpu, matplotlib and sklearn
    blocked here."""
    modules = set(_modules())
    for name in ("utils.plotting", "utils.tb_writer", "utils.kvlogger",
                 "utils.misc", "rl.rollout", "tools.bf16_bound"):
        assert f"var_tpu_torch.{name}" in modules


def test_every_module_imports_with_jax_and_var_tpu_blocked():
    blocked = FORBIDDEN + ("var_tpu",)
    code = "\n".join([
        "import importlib, sys",
        f"for name in {blocked!r}:",
        "    for key in [k for k in sys.modules",
        "                if k == name or k.startswith(name + '.')]:",
        "        del sys.modules[key]",
        "    sys.modules[name] = None",
        f"for mod in {_modules()!r} + ['chip_smoke']:",
        "    importlib.import_module(mod)",
        "leaked = [k for k, v in sys.modules.items() if v is not None and",
        f"          k.split('.')[0] in {blocked!r}]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


def test_e2e_recipe_modules_are_covered():
    """The legs, the sweep, self-improvement, the probes and the
    reward-wrapper path's modules are among those checked here."""
    modules = set(_modules())
    for name in ("tools.e2e_run", "tools.success_curve", "tools.var_probe",
                 "tools.grid_probe", "tools.self_improve_demo",
                 "train.self_improve", "ops.running_stats", "envs.vec.base",
                 "envs.vec.wrappers", "rl.reward", "rl.storage"):
        assert f"var_tpu_torch.{name}" in modules


def test_host_env_layer_modules_are_covered():
    """The native libraries' loader, the shared-memory vec env, its
    forkserver preload module and FakeArmEnv are among those checked
    here."""
    modules = set(_modules())
    for name in ("native", "envs.vec.shmem", "envs.vec.shm_transport",
                 "envs.vec.worker_preload", "envs.vec.factory", "envs.fake"):
        assert f"var_tpu_torch.{name}" in modules


def test_native_libraries_are_the_ports_own():
    """Built from var_tpu_torch/csrc into build/native/, never the JAX
    package's native/*.so."""
    from var_tpu_torch import native

    assert native.CSRC == PORT / "csrc"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    for lib in (native.simcore(), native.shmbuf()):
        path = Path(lib._name).resolve()
        assert path.parent == ROOT / "build" / "native", path
    for path in _port_files():
        assert "libsimcore.so" not in path.read_text() or \
            path.name == "native.py", path


def test_worker_preload_creates_no_cuda_state():
    """The forkserver imports the preload once and forks every worker from
    it: it must not import device.py nor touch CUDA."""
    code = "\n".join([
        "import sys",
        "import var_tpu_torch.envs.vec.worker_preload",
        "import torch",
        "assert 'var_tpu_torch.device' not in sys.modules",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")


def test_adapter_modules_are_covered():
    """The simulator adapters are among the modules scanned and imported
    with jax and var_tpu blocked here (each imports its simulator only
    when it connects, so none is needed to import them)."""
    modules = set(_modules())
    for name in ("envs.adapters", "envs.adapters.debug_draw",
                 "envs.adapters.pybullet_arm", "envs.adapters.ithor"):
        assert f"var_tpu_torch.{name}" in modules


@pytest.mark.parametrize("name", ["fake_backends", "torch_adapter_standins"])
def test_stand_in_helpers_import_nothing_forbidden(name):
    """chip_smoke.py's phase 38 imports the simulator stand-ins from
    tests/: they import numpy and each other only."""
    path = ROOT / "tests" / f"{name}.py"
    tops = {n.split(".")[0] for n in _imported_names(path)}
    assert tops <= {"__future__", "sys", "types", "numpy", "tests"}, tops
    assert not any(VAR_TPU.search(n) for n in _imported_names(path))
