"""The checks tests/test_torch_parallel.py runs on each rank of its gloo
group, and once more in the test process without a mesh (dp=1).

Each check reads its inputs from the work directory the test writes
(weights, batches, draws, permutations), runs one sharded path of the port
and returns what the test compares: everything a rank holds for the whole
run (the rollout gathered, the metrics, the parameters). Only the port is
imported here: the ranks start under spawn and import this module alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from var_tpu_torch.parallel.mesh import all_reduce_sum_, build_mesh, run_on_lead
from var_tpu_torch.tools import mesh_cards
from var_tpu_torch.train.pretext import PretextTrainer

# the meshes of the 4-rank group: dp=4, and dp=2 replicated over 'rep'
MESHES = mesh_cards.meshes_for(4)
SMALL = mesh_cards.WIDTHS["small"]
SIM_T, SIM_N = SMALL["sim_t"], SMALL["sim_n"]
FUSED_T, FUSED_N = SMALL["fused_t"], SMALL["fused_n"]
# the wait check: a collective timeout, and a lead that takes longer
SHORT_TIMEOUT_S, LEAD_S = 1.0, 3.0


def overrides(profile, **extra):
    """The config knobs of `profile` at the file's reduced widths (both
    packages take them)."""
    return mesh_cards.overrides(profile, "small", **extra)


def knobs(profile, **extra):
    """The port config of `profile` at the file's reduced widths."""
    return mesh_cards.knobs(profile, "small", **extra)


@contextlib.contextmanager
def mfcc_memo():
    """Each clip's host MFCC computed once in this process: a pure function
    of the clip and its STFT parameters, which every check's goal bank and
    host envs would compute again (a third of a rank's time)."""
    import var_tpu_torch.data.audio_store as store
    import var_tpu_torch.ops.audio as audio

    plain, memo = audio.mfcc_single, {}

    def mfcc_single(wav, params, backend="numpy"):
        a = np.asarray(wav)
        key = (a.dtype.str, a.shape, a.tobytes(), tuple(params), backend)
        if key not in memo:
            memo[key] = plain(wav, params, backend)
        return memo[key].copy()

    audio.mfcc_single = store.mfcc_single = mfcc_single
    try:
        yield
    finally:
        audio.mfcc_single = store.mfcc_single = plain


def run_checks(work, mesh):
    """var_tpu_torch/tools/mesh_cards.py's checks on the CPU."""
    return mesh_cards.run_checks(work, mesh, "cpu")


def entry_point_args(work, out):
    """The pretext entry point's arguments for a small arm run into
    `out` (collection on rank 0, then one epoch)."""
    with open(os.path.join(work, "entry.json")) as f:
        sets = json.load(f)["pretext"]
    return ["--env", "arms", "--device", "cpu", "--set",
            f"pretextDataDir=['{out}/data']",
            f"pretextModelSaveDir='{out}/model'", *sets]


def rl_entry_point_args(work, out):
    """The RL entry point's arguments for one device-sim update of 8 envs
    into `out`, on the VAR the test wrote."""
    with open(os.path.join(work, "entry.json")) as f:
        sets = json.load(f)["rl"]
    return ["--env", "arms", "--device", "cpu", "--set",
            f"pretextModelLoadDir='{work}/rl_var'",
            f"RLModelSaveDir='{out}'", *sets]


def mark_inputs(work, written):
    """Tell the ranks the test process has written the inputs (or failed
    to)."""
    with open(os.path.join(work, "inputs.tmp"), "w") as f:
        f.write("ok" if written else "failed")
    os.replace(os.path.join(work, "inputs.tmp"),
               os.path.join(work, "inputs"))


def _wait_for_inputs(work, timeout=600.0):
    path = os.path.join(work, "inputs")
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"no inputs in {work} after {timeout} s")
        time.sleep(0.05)
    with open(path) as f:
        if f.read() != "ok":
            raise RuntimeError("the test process failed to write the inputs")


def rank_main(work, device):
    """Every check on both meshes, once the test process has written the
    inputs; then both entry points joining this group as a torchrun
    launch's ranks do (WORLD_SIZE set), at dp=4."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    spawned_env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                                  "MKL_NUM_THREADS")}
    waited = lead_wait(work)
    waited["replica_sum"] = replica_sum(device)
    _wait_for_inputs(work)
    with mfcc_memo():
        for shape in MESHES:
            mesh = build_mesh(shape, device)
            torch.save(run_checks(work, mesh),
                       mesh_cards.check_file(work, "spawn", shape, rank))
    from var_tpu_torch.pretext import main as pretext_main
    from var_tpu_torch.rl import main as rl_main

    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank))
    dp4 = ["meshShape={'dp': 4}"]
    pretext_main(entry_point_args(work, os.path.join(work, "entry_dp4"))
                 + dp4)
    # the launcher's ranks take cli.py::sharded_main's share of the cores
    launched_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rl_main(rl_entry_point_args(work, os.path.join(work, "rl_dp4")) + dp4)
    with open(os.path.join(work, f"rank{rank}_threads.json"), "w") as f:
        json.dump({"spawned_env": spawned_env,
                   "launched_threads": launched_threads, **waited}, f)


def replica_sum(device):
    """all_reduce_sum_ on {'dp': 2, 'rep': 2} where the two replicas of a
    block hold values one ulp apart, as two cards' kernels that do not
    repeat bit for bit leave them: returns the sum's bits on this rank,
    which must be every rank's."""
    mesh = build_mesh({"dp": 2, "rep": 2}, device)
    rank = torch.distributed.get_rank()
    x = torch.tensor([1.0 + mesh.shard_index, 3.0], dtype=torch.float32)
    if rank % 2:  # the second line's replicas
        x = torch.nextafter(x, torch.full_like(x, 10.0))
    all_reduce_sum_([x], mesh)
    return x.view(torch.int32).tolist()


def lead_wait(work):
    """Rank 0's pretext collection takes LEAD_S while a gloo group's
    collectives time out after SHORT_TIMEOUT_S: through the trainer's run()
    (parallel/mesh.py::run_on_lead) every rank waits for it and then meets
    in a collective on that group; a barrier on such a group in its place
    (the wait before run_on_lead) raises on the waiting ranks. Returns
    what each rank saw."""
    import datetime

    import torch.distributed as dist

    rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=SHORT_TIMEOUT_S)
    short = dist.new_group(backend="gloo", timeout=timeout)
    barrier_group = dist.new_group(backend="gloo", timeout=timeout)
    tr = PretextTrainer(knobs("arms", pretextCollection=True,
                              pretextTrain=False), device="cpu")
    tr.collectPretextData = lambda: time.sleep(LEAD_S)
    t0 = time.monotonic()
    tr.run()
    waited = time.monotonic() - t0
    x = torch.ones(1)
    dist.all_reduce(x, group=short)
    # the barrier the wait was before: the ranks that wait raise
    t0 = time.monotonic()
    if rank == 0:
        time.sleep(LEAD_S)
    try:
        dist.barrier(group=barrier_group)
        barrier = "passed"
    except RuntimeError as e:
        barrier = f"raised: {type(e).__name__}"
    # every rank leaves the broken group behind before the next check
    run_on_lead(lambda: None)
    return {"waited_s": waited, "after_wait_sum": x.item(),
            "barrier": barrier}


def die_on_rank_1(device):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()
