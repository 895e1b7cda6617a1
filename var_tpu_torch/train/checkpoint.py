"""Checkpoints with torch.save (the JAX package uses Orbax, which the GPU
machine does not have).

A checkpoint is the directory `<saveDir>/<epoch>/` holding one file,
checkpoint.pt: {'params': state_dict, 'opt_state': optimizer state_dict,
'step': int}, with every tensor on the CPU so that any device can load it.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

CHECKPOINT_FILE = "checkpoint.pt"


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state: dict):
    """Save `state` into the directory `path`, atomically."""
    path = _abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, CHECKPOINT_FILE)
    tmp = target + ".tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, target)


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint directory's state onto the CPU."""
    target = os.path.join(_abspath(path), CHECKPOINT_FILE)
    if not os.path.exists(target):
        raise FileNotFoundError(f"checkpoint {target!r} not found")
    return torch.load(target, map_location="cpu", weights_only=True)


def is_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(_abspath(path), CHECKPOINT_FILE))


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Newest numeric subdirectory of save_dir (checkpoints are saved as
    '<save_dir>/<epoch>')."""
    save_dir = _abspath(save_dir)
    if not os.path.isdir(save_dir):
        return None
    steps = []
    for name in os.listdir(save_dir):
        full = os.path.join(save_dir, name)
        if os.path.isdir(full):
            try:
                steps.append((int(name), full))
            except ValueError:
                continue
    if not steps:
        return None
    return max(steps)[1]
