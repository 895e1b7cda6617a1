"""Config selection and env registration (mirrors var_tpu/config/__init__.py).

ENV/TASK may be set via the VAR_TPU_ENV / VAR_TPU_TASK environment
variables, with the same names and defaults as the JAX package. Only the
arm profile is ported; the ai2thor profile waits for its slice (ROADMAP
"Modules left to port", item 7).
"""
import os

from .arm import ArmConfig, KukaEnvConfig
from .base import ConfigBase, printColor

ENV = os.environ.get("VAR_TPU_ENV", "ai2thor")  # 'ai2thor' | 'arms'
TASK = os.environ.get("VAR_TPU_TASK", "fourInARow")  # for 'arms' only


def main_config(env: str = None, task: str = None):
    """Build the active config profile."""
    env = ENV if env is None else env
    task = TASK if task is None else task

    if env == "ai2thor":
        raise NotImplementedError(
            "the ai2thor profile is not ported yet (ROADMAP 'Modules left "
            "to port', item 7: the ai2thor profile); use --env arms")
    if env == "arms":
        if task not in ("fourInARow",):
            raise NotImplementedError(f"Unknown arms task {task!r}")
        config = ArmConfig()
        config.get_env_config(KukaEnvConfig)
        return config
    raise NotImplementedError(f"Unknown ENV {env!r}")


def gym_register(config, env: str = None):
    """Register the pretext/RL env ids of the active profile in the port's
    env registry (var_tpu_torch.envs.core)."""
    from var_tpu_torch.envs import make_entry_points
    from var_tpu_torch.envs.core import register

    if env is None:
        env = "arms" if config.name == "ArmConfig" else "ai2thor"
    pretext_ep, rl_ep = make_entry_points(config, env)
    register(f"{env}-pretext-v2", pretext_ep, config=config)
    register(f"{env}-RL-v2", rl_ep, config=config)


__all__ = [
    "ConfigBase", "printColor", "ArmConfig", "KukaEnvConfig",
    "main_config", "gym_register", "ENV", "TASK",
]
