"""Config selection and env registration (mirrors var_tpu/config/__init__.py).

ENV/TASK may be set via the VAR_TPU_ENV / VAR_TPU_TASK environment
variables, with the same names and defaults as the JAX package.
"""
import os

from .ai2thor import AI2ThorConfig, AI2ThorEnvConfig
from .arm import ArmConfig, KukaEnvConfig
from .base import ConfigBase, printColor

ENV = os.environ.get("VAR_TPU_ENV", "ai2thor")  # 'ai2thor' | 'arms'
TASK = os.environ.get("VAR_TPU_TASK", "fourInARow")  # for 'arms' only


def main_config(env: str = None, task: str = None):
    """Build the active config profile."""
    env = ENV if env is None else env
    task = TASK if task is None else task

    if env == "ai2thor":
        config = AI2ThorConfig()
        config.get_env_config(AI2ThorEnvConfig)
        return config
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
    "AI2ThorConfig", "AI2ThorEnvConfig", "main_config", "gym_register", "ENV", "TASK",
]
