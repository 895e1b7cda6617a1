"""Minimal observation/action space types (gym is not a dependency).

The subset of var_tpu/envs/spaces.py the arm sims, the vec env and the
policy heads use: Box, Discrete, MultiBinary and Dict descriptors of shape
and dtype.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass
class Box:
    low: np.ndarray
    high: np.ndarray
    shape: Tuple[int, ...] = None
    dtype: np.dtype = np.float32

    def __post_init__(self):
        self.low = np.asarray(self.low, dtype=self.dtype)
        self.high = np.asarray(self.high, dtype=self.dtype)
        if self.shape is None:
            self.shape = np.broadcast(self.low, self.high).shape
        else:
            self.shape = tuple(self.shape)
            self.low = np.broadcast_to(self.low, self.shape).astype(self.dtype)
            self.high = np.broadcast_to(self.high, self.shape).astype(self.dtype)

    def __repr__(self):
        return f"Box(shape={self.shape}, dtype={np.dtype(self.dtype).name})"


@dataclass
class Discrete:
    """n actions (the categorical policy head)."""

    n: int
    shape: Tuple[int, ...] = field(default=(), init=False)
    dtype: np.dtype = field(default=np.int64, init=False)


@dataclass
class MultiBinary:
    """n independent {0,1} flags (the Bernoulli policy head)."""

    n: int
    shape: Tuple[int, ...] = field(default=None, init=False)
    dtype: np.dtype = field(default=np.int8, init=False)

    def __post_init__(self):
        self.shape = (self.n,)


class DictSpace:
    """Ordered dict of named sub-spaces (mirrors gym.spaces.Dict)."""

    def __init__(self, spaces):
        if isinstance(spaces, dict) and not isinstance(spaces, OrderedDict):
            spaces = OrderedDict(sorted(spaces.items()))
        self.spaces = OrderedDict(spaces)

    def keys(self):
        return self.spaces.keys()

    def items(self):
        return self.spaces.items()

    def __getitem__(self, key):
        return self.spaces[key]

    def __iter__(self):
        return iter(self.spaces)

    def __contains__(self, key):
        return key in self.spaces

    def __repr__(self):
        inner = ", ".join(f"{k}: {v!r}" for k, v in self.spaces.items())
        return f"DictSpace({inner})"
