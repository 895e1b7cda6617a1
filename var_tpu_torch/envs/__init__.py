"""Environment layer: spaces, registry and the built-in arm simulator."""
from __future__ import annotations

from . import spaces  # noqa: F401
from .core import Env, TimeLimitMask, make, register  # noqa: F401


def make_entry_points(config, env: str):
    """(pretext_entry, rl_entry) constructors for gym_register.

    Only the built-in numpy arm simulator is ported; the PyBullet adapter
    and the ai2thor grid sim wait for later slices."""
    backend = getattr(config, "simBackend", "builtin")
    if env == "arms":
        if backend == "pybullet":
            raise NotImplementedError(
                "simBackend='pybullet' is not ported; use 'builtin'")
        from .arm_sim import FourInARowPretextSim, FourInARowSim

        return FourInARowPretextSim, FourInARowSim
    raise NotImplementedError(f"env {env!r} is not ported yet")
