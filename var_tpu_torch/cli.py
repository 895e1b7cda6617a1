"""Shared CLI handling for the port's entry points (mirrors var_tpu/cli.py):

    python -m var_tpu_torch.pretext --env arms [--device cpu] --set KNOB=VALUE ...

The device defaults to CUDA; --device cpu runs on the CPU. With
--set meshShape='{"dp": n}' a training run starts n ranks (one process
each, under spawn; rank r on cuda:r, or gloo ranks on the CPU), or joins
the group of a torchrun launcher (see sharded_main).
"""
from __future__ import annotations

import argparse
import ast
import os
from typing import Callable, Optional, Sequence

from var_tpu_torch.config import main_config

# options the trainers read with getattr and a default, as the JAX package
# does, so the profiles do not list them (pretext: the device budget that
# selects the chunked path, in MiB)
OPTIONAL_KNOBS = ("pretextHBMBudgetMB",)


def parse_args(argv: Optional[Sequence[str]] = None, description: str = ""):
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--env", choices=["arms", "ai2thor"], default=None,
        help="environment profile (default: VAR_TPU_ENV or 'ai2thor')")
    p.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; raises if CUDA is absent)")
    p.add_argument(
        "--set", nargs="*", default=[], metavar="KNOB=VALUE",
        help="config overrides; values are Python literals "
             "(e.g. --set pretextEpoch=5 audioBackend='pallas')")
    return p.parse_args(argv)


def parse_set_items(items):
    """KNOB=VALUE strings -> override dict; values are Python literals
    with bare-string and true/false/none fallbacks."""
    overrides = {}
    for item in items:
        if "=" not in item:
            raise SystemExit(f"--set expects KNOB=VALUE, got {item!r}")
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            low = raw.strip().lower()
            if low in ("true", "false"):
                value = low == "true"
            elif low in ("none", "null"):
                value = None
            else:
                value = raw  # bare strings: --set audioBackend=pallas
        overrides[key] = value
    return overrides


def build_config(args, role: str):
    config = main_config(env=args.env)
    config.pretext_RL = role
    overrides = parse_set_items(args.set)
    for key in OPTIONAL_KNOBS:
        if key in overrides:
            setattr(config, key, overrides.pop(key))
    if overrides:
        try:
            config.override(**overrides)
        except AttributeError as e:
            raise SystemExit(str(e))
        # re-validate: the __init__-time check only saw the defaults
        config.cfg_check()
    return config


def sharded_main(config, device, rank_fn: Callable, args: tuple = ()):
    """Run rank_fn(config, *args, device=...) on every rank of
    config.meshShape (parallel/mesh.py::launch): spawned here, or this
    process as one rank of a torchrun launch. The ranks share the host's
    cores, each taking cpu_count // n threads, CPU and CUDA ranks alike
    (a CUDA rank's host sims, env workers and numpy run there)."""
    from var_tpu_torch.parallel.mesh import launch, mesh_size

    n = mesh_size(config.meshShape)
    threads = max(1, (os.cpu_count() or 1) // n)
    return launch(rank_fn, (config,) + tuple(args), n, device=device,
                  threads=threads)
