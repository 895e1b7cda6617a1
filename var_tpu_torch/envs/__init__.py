"""Environment layer: spaces, registry and the built-in simulators."""
from __future__ import annotations

from . import spaces  # noqa: F401
from .core import Env, TimeLimitMask, make, register  # noqa: F401


def make_entry_points(config, env: str):
    """(pretext_entry, rl_entry) constructors for gym_register.

    The built-in numpy simulators (the arm and the ai2thor grid house) are
    ported; the PyBullet and iTHOR adapters are not."""
    backend = getattr(config, "simBackend", "builtin")
    if env == "arms":
        if backend == "pybullet":
            raise NotImplementedError(
                "simBackend='pybullet' is not ported; use 'builtin'")
        from .arm_sim import FourInARowPretextSim, FourInARowSim

        return FourInARowPretextSim, FourInARowSim
    if env == "ai2thor":
        if backend == "ithor":
            raise NotImplementedError(
                "simBackend='ithor' (the AI2-THOR Unity adapter) is not "
                "ported; use 'builtin' (ROADMAP 'Modules left to port': "
                "not queued, it needs the Unity server)")
        from .grid_sim import GridHousePretextSim, GridHouseSim

        return GridHousePretextSim, GridHouseSim
    raise NotImplementedError(f"env {env!r} is not ported yet")
