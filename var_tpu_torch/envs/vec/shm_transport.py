"""POSIX shared-memory observation segment for ShmemVecEnv (port of
var_tpu/envs/vec/shm_transport.py).

One mmap'd segment holds every observation key as a contiguous batched
(num_envs, *shape) region (the layout is computed here; csrc/shmbuf.cpp
creates, maps and unlinks it). Each worker writes its own row in place and
the parent reads batched numpy views, so reassembling a step is one copy
per key instead of the reference's one per env per key
(reference: Envs/vec_env/shmem_vec_env.py:45-61,105-115).

Ordering comes from the command pipes: a worker finishes writing its row
before it acknowledges the step, and the parent reads only after recv.
The segment pickles as (name, layout) only; a worker re-opens and maps it
by name in its own process, so the transport works under fork,
forkserver and spawn alike.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import numpy as np

from var_tpu_torch.native import shmbuf

_ALIGN = 64  # cache-line align each key region
SEGMENT_PREFIX = "/var_tpu_torch_obs_"  # the name's prefix under /dev/shm


def available() -> bool:
    """True once the library is built and loaded; raises with the
    compiler's output where it cannot build."""
    return shmbuf() is not None


def _layout(obs_keys, obs_shapes, obs_dtypes, num_envs):
    """{key: (offset, nbytes_per_env)} and the segment's total size."""
    offsets: Dict[str, Tuple[int, int]] = {}
    off = 0
    for k in obs_keys:
        per_env = int(np.prod(obs_shapes[k])) * np.dtype(obs_dtypes[k]).itemsize
        offsets[k] = (off, per_env)
        off += per_env * num_envs
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
    return offsets, off


class ShmObsSegment:
    """The parent's side of the segment: creates, maps and unlinks it."""

    def __init__(self, obs_keys, obs_shapes, obs_dtypes, num_envs):
        self._lib = shmbuf()
        self.obs_keys = list(obs_keys)
        self.obs_shapes = dict(obs_shapes)
        self.obs_dtypes = {k: np.dtype(v) for k, v in obs_dtypes.items()}
        self.num_envs = num_envs
        self.offsets, self.size = _layout(
            self.obs_keys, self.obs_shapes, self.obs_dtypes, num_envs)
        self.name = f"{SEGMENT_PREFIX}{os.getpid()}_{id(self) & 0xFFFFFF:x}"
        fd = self._lib.shmbuf_create(self.name.encode(), self.size)
        if fd < 0:
            raise OSError(-fd, f"shmbuf_create {self.name}")
        self._fd = fd
        self._addr = self._lib.shmbuf_map(fd, self.size)
        if not self._addr:
            self._lib.shmbuf_close_fd(fd)
            self._lib.shmbuf_unlink(self.name.encode())
            raise OSError("shmbuf_map failed")
        self._views = _build_views(
            self._addr, self.offsets, self.obs_keys, self.obs_shapes,
            self.obs_dtypes, self.num_envs)

    def batched(self, key: str) -> np.ndarray:
        """(num_envs, *shape) view of the live segment (no copy)."""
        return self._views[key]

    def worker_handle(self) -> "ShmObsWorker":
        """The picklable handle a worker maps the segment with."""
        return ShmObsWorker(self.name, self.obs_keys, self.obs_shapes,
                            {k: v.str for k, v in self.obs_dtypes.items()},
                            self.num_envs)

    def close(self):
        if getattr(self, "_addr", None):
            self._views = {}
            self._lib.shmbuf_unmap(self._addr, self.size)
            self._lib.shmbuf_close_fd(self._fd)
            self._lib.shmbuf_unlink(self.name.encode())
            self._addr = None

    def __del__(self):  # pragma: no cover - gc safety net
        try:
            self.close()
        except Exception:
            pass


class ShmObsWorker:
    """The worker's side: plain data until open() maps it in-process."""

    def __init__(self, name, obs_keys, obs_shapes, dtype_strs, num_envs):
        self.name = name
        self.obs_keys = obs_keys
        self.obs_shapes = obs_shapes
        self.dtype_strs = dtype_strs
        self.num_envs = num_envs
        self._addr = None

    def open(self, env_idx: int) -> Dict[str, np.ndarray]:
        """Map the segment; returns this env's row views by key."""
        lib = shmbuf()
        dtypes = {k: np.dtype(v) for k, v in self.dtype_strs.items()}
        offsets, size = _layout(self.obs_keys, self.obs_shapes, dtypes,
                                self.num_envs)
        fd = lib.shmbuf_open(self.name.encode())
        if fd < 0:
            raise OSError(-fd, f"shmbuf_open {self.name}")
        addr = lib.shmbuf_map(fd, size)
        lib.shmbuf_close_fd(fd)
        if not addr:
            raise OSError("shmbuf_map failed in worker")
        self._addr = addr
        self._size = size
        views = _build_views(addr, offsets, self.obs_keys, self.obs_shapes,
                             dtypes, self.num_envs)
        return {k: v[env_idx] for k, v in views.items()}


def _build_views(addr, offsets, obs_keys, obs_shapes, obs_dtypes, num_envs):
    views = {}
    for k in obs_keys:
        off, per_env = offsets[k]
        nbytes = per_env * num_envs
        buf = (ctypes.c_uint8 * nbytes).from_address(addr + off)
        views[k] = np.frombuffer(buf, dtype=obs_dtypes[k]).reshape(
            (num_envs,) + tuple(obs_shapes[k]))
    return views
