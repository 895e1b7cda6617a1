"""Forkserver preload module for ShmemVecEnv workers (port of
var_tpu/envs/vec/worker_preload.py, without cloudpickle).

The multiprocessing forkserver imports this once; every worker then forks
from the server and inherits these imports instead of paying for them
itself. It imports numpy and the env and audio modules only: never
var_tpu_torch/device.py, nor anything that creates a CUDA context, so no
worker holds a CUDA state. The server starts inside
base.py::worker_environment, so numpy and torch load here with one thread
each.
"""
import numpy  # noqa: F401

import var_tpu_torch.data.audio_store  # noqa: F401
import var_tpu_torch.envs.arm_sim  # noqa: F401
import var_tpu_torch.envs.core  # noqa: F401
import var_tpu_torch.envs.fake  # noqa: F401
import var_tpu_torch.envs.grid_sim  # noqa: F401
import var_tpu_torch.envs.vec.shmem  # noqa: F401
import var_tpu_torch.native  # noqa: F401
