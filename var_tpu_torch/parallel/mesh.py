"""Data parallelism over ranks (port of var_tpu/parallel/mesh.py).

The JAX package builds a Mesh over n devices in one process, shards the
leading (batch or env) axis over 'dp' and replicates the rest; XLA inserts
the reductions. Here the same contract takes PyTorch's idiom: one process
per rank in a torch.distributed group (NCCL on CUDA, gloo on the CPU), each
rank holding its contiguous block of the sharded axis, with the collectives
written out as the plain functions below. A dp=n run computes what a dp=1
run computes, up to the order of summation.

A Mesh carries the rank, the world size, the group and the rank's device.
A count that does not divide by dp raises, as XLA's uneven shard does, and
nothing quietly runs on fewer ranks than the mesh asks for: build_mesh
raises unless the group's world size is the product of the axis sizes.

Start ranks with `launch` (torch.multiprocessing under spawn, since CUDA
forbids fork after init; or the group of a `torchrun` launcher when
WORLD_SIZE is set). A failed init or collective raises; a rank that dies
makes the others raise at the group's timeout, and `launch` joins every
rank it started. Work that rank 0 does alone while the others wait for it
(pretext collection) goes through `run_on_lead`, whose wait is no
collective: a collective that waits longer than TIMEOUT_S raises (NCCL's
watchdog ends the rank), a collection may take longer.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for a rank before it raises
TIMEOUT_S = 600.0


def _default_backend(device) -> str:
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    return "nccl" if dev.type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join a process group; returns whether one is initialised.

    - a group already initialised in this process is kept;
    - WORLD_SIZE in the environment (a torchrun launch): the launcher's
      group (init_method env://, its RANK and WORLD_SIZE);
    - no address and at most one process: a no-op (single process);
    - otherwise `coordinator_address` (tcp://host:port or file://path) with
      `num_processes` ranks, this one `process_id`.
    The backend is NCCL when `device` is CUDA (by default when CUDA is
    available) and gloo on the CPU; `backend` names another."""
    if dist.is_initialized():
        return True
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    backend = backend or _default_backend(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    if coordinator_address is None and (num_processes or 1) <= 1:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, "
                         "the number of processes and this process's id")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    return True


@dataclass(frozen=True)
class Mesh:
    """The data-parallel layout: ranks along 'dp' split the sharded axis;
    axes other than 'dp' replicate, as var_tpu/parallel/mesh.py::
    batch_sharding does. The ranks are laid out row-major over the axes in
    their order, as numpy reshapes the JAX package's device list. `group`
    holds this rank's 'dp' line (the whole world when 'dp' is the only
    axis of more than one rank); `shard_index` is its place on it."""

    shape: Dict[str, int]
    rank: int
    world: int
    group: Optional[object]
    shard_index: int
    device: torch.device
    backend: Optional[str]

    @property
    def dp(self) -> int:
        return int(self.shape.get("dp", 1))

    @property
    def lead(self) -> bool:
        """The rank that writes checkpoints, logs and prints."""
        return self.rank == 0

    def local(self, n: int, what: str = "count") -> int:
        """n // dp; raises where XLA's uneven shard would."""
        if n % self.dp:
            raise ValueError(
                f"{what} {n} does not divide by the mesh's dp={self.dp}")
        return n // self.dp

    def block(self, n: int, what: str = "count") -> slice:
        """This rank's contiguous block of n items."""
        m = self.local(n, what)
        return slice(self.shard_index * m, (self.shard_index + 1) * m)

    def shard(self, x, axis: int = 0, what: str = "count"):
        """This rank's block of x (a tensor or an array) along `axis`."""
        sl = self.block(x.shape[axis], what)
        if isinstance(x, torch.Tensor):
            return x.narrow(axis, sl.start, sl.stop - sl.start)
        index = [slice(None)] * x.ndim
        index[axis] = sl
        return x[tuple(index)]


def mesh_size(mesh_shape: Dict[str, int]) -> int:
    return int(math.prod(int(v) for v in mesh_shape.values()))


def build_mesh(mesh_shape: Optional[Dict[str, int]] = None,
               device=None) -> Mesh:
    """The Mesh of {'dp': n, ...} over the initialised group (default: every
    rank on 'dp'). The axis sizes must multiply to the world size, or it
    raises; with no group, only a mesh of one rank builds. Every rank of
    the group calls it (the 'dp' lines are new groups when other axes
    hold more than one rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not mesh_shape:
        mesh_shape = {"dp": world}
    shape = {str(k): int(v) for k, v in mesh_shape.items()}
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh {shape}: every axis needs at least 1 rank")
    n = mesh_size(shape)
    if n != world:
        started = ("no process group is initialised" if not
                   dist.is_initialized() else f"the group has {world} ranks")
        raise ValueError(
            f"mesh {shape} needs {n} ranks, but {started}; start the run "
            "through the entry point or torchrun")
    dev = torch.device(device if device is not None else "cpu")
    if not dist.is_initialized():
        return Mesh(shape, 0, 1, None, 0, dev, None)
    rank = dist.get_rank()
    names = list(shape)
    sizes = [shape[k] for k in names]
    grid = np.arange(world).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    if "dp" not in names:
        grid, axis, index = grid[..., None], len(names), 0
    else:
        axis = names.index("dp")
        index = int(coords[axis])
    lines = np.moveaxis(grid, axis, -1).reshape(-1, grid.shape[axis])
    if len(lines) == 1:
        group = dist.group.WORLD
    else:
        group = None
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                group = g
    return Mesh(shape, rank, world, group, index, dev, dist.get_backend())


def pad_to_multiple(batch: np.ndarray, multiple: int, axis: int = 0):
    """Pad a host batch so its size divides the dp axis (edge mode);
    returns (padded, true_size)."""
    n = batch.shape[axis]
    rem = n % multiple
    if rem == 0:
        return batch, n
    widths = [(0, 0)] * batch.ndim
    widths[axis] = (0, multiple - rem)
    return np.pad(batch, widths, mode="edge"), n


# -- collectives ---------------------------------------------------------------


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]):
    """Sum each tensor over the mesh's 'dp' line, in place, in one
    collective (the tensors are flattened into one buffer of their common
    dtype).

    Where other axes replicate (world > dp), the sum runs over every rank
    and is divided by the number of 'dp' lines. Each line computes the
    same sum up to the last bits, but a card's kernels do not all repeat
    bit for bit (on four H100s the two lines of {'dp': 2, 'rep': 2} held
    different parameters after one step when each reduced its own line),
    so the replicas would drift apart; the mean of the lines' sums is the
    same bits on every rank."""
    tensors = list(tensors)
    if not _active(mesh) or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    lines = mesh.world // mesh.dp
    if lines > 1:
        if not flat.is_floating_point():
            raise TypeError("a replicated mesh averages its lines' sums: "
                            f"floating-point tensors only, got {flat.dtype}")
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(lines)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_gather_env(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: int = 0) -> torch.Tensor:
    """Every rank's block of x joined along `axis` in rank order (the
    global env or batch axis). NCCL gathers; gloo, which gathers CUDA
    tensors on no version the port relies on, sums each rank's block into
    a zero buffer of the global shape, which is exact."""
    if not _active(mesh):
        return x
    x = x.contiguous()
    if mesh.backend == "nccl":
        moved = x.movedim(axis, 0).contiguous()
        out = torch.empty((mesh.dp * moved.shape[0],) + moved.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, moved, group=mesh.group)
        return out.movedim(0, axis)
    dtype = x.dtype
    work = x.to(torch.uint8) if dtype == torch.bool else x
    shape = list(work.shape)
    m = shape[axis]
    shape[axis] = m * mesh.dp
    out = torch.zeros(shape, dtype=work.dtype, device=work.device)
    out.narrow(axis, mesh.shard_index * m, m).copy_(work)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.to(dtype) if dtype == torch.bool else out


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh],
               src: int = 0):
    """Rank `src`'s values (a global rank) into every rank's tensors, in
    place, over the whole group."""
    tensors = list(tensors)
    if not _active(mesh):
        return tensors
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src)
    return tensors


def run_on_lead(fn: Callable, poll_s: float = 0.2):
    """fn() on rank 0 while every other rank waits for it; returns fn's
    result on rank 0 and None elsewhere (without a group: fn() here).

    The others wait on a key in the group's store, which rank 0 sets when
    fn returns or raises, and no collective: a collective that waits past
    TIMEOUT_S raises, and NCCL's watchdog ends the rank, while rank 0's
    work (pretext collection at the recipes' sizes) may take longer. A
    rank 0 that raises makes every waiting rank raise."""
    if not dist.is_initialized():
        return fn()
    store = dist.distributed_c10d._get_default_store()
    # every rank counts its own calls in the store, so the n-th call of
    # each rank meets at one key
    calls = store.add(f"var_tpu_torch/run_on_lead/calls/{dist.get_rank()}",
                      1)
    key = f"var_tpu_torch/run_on_lead/{calls}"
    if dist.get_rank() == 0:
        try:
            out = fn()
        except BaseException as e:
            store.set(key, f"failed: {type(e).__name__}: {e}")
            raise
        store.set(key, "ok")
        return out
    while not store.check([key]):
        time.sleep(poll_s)
    said = store.get(key).decode()
    if said != "ok":
        raise RuntimeError(f"rank 0 {said}")
    return None


# -- starting ranks ------------------------------------------------------------


def rank_device(device, local_rank: int, world: int) -> torch.device:
    """The device of one rank: an unindexed 'cuda' pins rank r to cuda:r
    (raising where the host has fewer cards: NCCL puts one rank on a
    card); 'cpu' or an indexed 'cuda:k' is every rank's device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    count = torch.cuda.device_count()
    if world > count:
        raise RuntimeError(
            f"{world} ranks on {count} CUDA device(s): NCCL takes one rank "
            "per card; name a device (cuda:0) with backend='gloo' to run "
            "several ranks on one card")
    return torch.device("cuda", local_rank)


def _rank_main(rank, fn, args, n, device, backend, address, threads):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank, n)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(address, n, rank, backend=backend, device=dev)
    try:
        fn(*args, device=dev)
    finally:
        _leave()


def _leave():
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple, n: int, device=None,
           backend: Optional[str] = None,
           threads: Optional[int] = None,
           init_method: Optional[str] = None):
    """Run fn(*args, device=<the rank's device>) on each of n ranks.

    Under a torchrun launcher (WORLD_SIZE set) this process is one rank of
    the launcher's group and runs fn once; WORLD_SIZE must be n. Otherwise
    n ranks start here: one in this process when n == 1 (a group of one,
    so its collectives run on the backend all the same), else n processes
    under spawn, joined before this returns; a rank that raises makes the
    call raise. The group meets at `init_method` (default: a file in a
    fresh temporary directory). `threads` sets each rank's torch threads
    (spawned or under the launcher), and the OpenMP and BLAS threads of
    the ranks it spawns. Returns fn's result in this process (None when
    ranks were spawned)."""
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"the mesh has {n} ranks, the launcher {world}")
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = rank_device(device, local, min(world, int(os.environ.get(
            "LOCAL_WORLD_SIZE", world))))
        if threads:
            torch.set_num_threads(threads)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # a group this process already holds stays its holder's to end
        owned = not dist.is_initialized()
        init_distributed(backend=backend, device=dev)
        try:
            return fn(*args, device=dev)
        finally:
            if owned:
                _leave()
    tmp = tempfile.mkdtemp(prefix="var_tpu_torch_group_")
    address = init_method or "file://" + os.path.join(tmp, "store")
    try:
        if n == 1:
            dev = rank_device(device, 0, 1)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            init_distributed(address, 1, 0, backend=backend, device=dev)
            try:
                return fn(*args, device=dev)
            finally:
                _leave()
        import torch.multiprocessing as mp

        with _thread_env(threads):
            mp.start_processes(
                _rank_main, args=(fn, args, n, device, backend, address,
                                  threads),
                nprocs=n, join=True, start_method="spawn")
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


@contextlib.contextmanager
def _thread_env(threads: Optional[int]):
    """The OpenMP and BLAS thread variables set to `threads` while ranks
    are spawned (a spawned rank reads them as it starts, before numpy
    loads), restored after; nothing when `threads` is None."""
    saved = {k: os.environ.get(k) for k in THREAD_VARS}
    if threads:
        os.environ.update({k: str(threads) for k in THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
