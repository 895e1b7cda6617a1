"""Environment layer: spaces, registry, the built-in simulators and the
adapters onto real ones."""
from __future__ import annotations

from . import spaces  # noqa: F401
from .core import Env, TimeLimitMask, make, register  # noqa: F401


def make_entry_points(config, env: str):
    """(pretext_entry, rl_entry) constructors for gym_register.

    simBackend selects the built-in numpy simulator or the adapter onto
    PyBullet ('pybullet', the arm) or AI2-THOR ('ithor', the grid house),
    which expose the same observation schemas. An adapter imports its
    simulator when it connects and raises ImportError where it is
    missing; nothing falls back to the built-in sim."""
    backend = getattr(config, "simBackend", "builtin")
    if env == "arms":
        if backend == "pybullet":
            from .adapters.pybullet_arm import (
                PyBulletFourInARow,
                PyBulletFourInARowPretext,
            )

            return PyBulletFourInARowPretext, PyBulletFourInARow
        from .arm_sim import FourInARowPretextSim, FourInARowSim

        return FourInARowPretextSim, FourInARowSim
    if env == "ai2thor":
        if backend == "ithor":
            from .adapters.ithor import ITHOREnv, ITHORPretextEnv

            return ITHORPretextEnv, ITHOREnv
        from .grid_sim import GridHousePretextSim, GridHouseSim

        return GridHousePretextSim, GridHouseSim
    raise NotImplementedError(env)
