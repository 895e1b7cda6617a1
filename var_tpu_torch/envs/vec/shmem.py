"""Multi-process shared-memory vec env (port of var_tpu/envs/vec/shmem.py).

One worker process per environment (reference:
Envs/vec_env/shmem_vec_env.py:24-154): command pipes carrying
reset / step / render / info / close, lockstep send-then-recv stepping,
auto-reset on done inside the worker, and a per-env `obs_list` of raw
dict observations for the triplet collector.

Observations travel through shared memory: by default ('auto' or
'posix') one POSIX segment (csrc/shmbuf.cpp, envs/vec/shm_transport.py)
with a batched region per key; with transport='array', one
multiprocessing.Array per (env, key), the reference's own mechanism. A
library that does not build raises; nothing drops to 'array' unasked.

Workers start from a forkserver by default: the learner holds a
multithreaded torch runtime (and maybe a CUDA context) by the time envs
are built, and forking such a parent risks deadlocks and hands the child
a CUDA state it must not touch. The forkserver imports
envs/vec/worker_preload.py once (numpy and the env and audio modules,
never a CUDA context) and forks every worker from that clean process,
started with one thread per pool (base.py::worker_environment). 'fork'
stays available by name; its workers keep the parent's numpy, BLAS pool
and all. Env constructors and the audio store
travel with plain pickle (factory.py::EnvThunk): the card's machine has
no cloudpickle.

An exception in a worker (its env's constructor, reset or step: say the
ImportError of a simulator adapter whose package is missing) is sent to
the parent, which stops every worker and raises it there, with the
worker's traceback as a note.
"""
from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import pickle
import traceback
from collections import OrderedDict

import numpy as np

from .base import VecEnv, worker_environment
from .shm_transport import ShmObsSegment, ShmObsWorker

_NP_TO_CT = {
    np.dtype(np.float32): ctypes.c_float,
    np.dtype(np.float64): ctypes.c_double,
    np.dtype(np.int32): ctypes.c_int32,
    np.dtype(np.int64): ctypes.c_int64,
    np.dtype(np.uint8): ctypes.c_uint8,
    np.dtype(bool): ctypes.c_bool,
}
TRANSPORTS = ("auto", "posix", "array")


class ShmemVecEnv(VecEnv):
    def __init__(self, env_fns, context="forkserver", audio=None,
                 transport="auto", timeout: float = 300.0):
        """`timeout`: seconds a worker may take to answer before the parent
        raises (a dead worker raises at once)."""
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; one of "
                             f"{TRANSPORTS}")
        ctx = mp.get_context(context)
        if context == "forkserver":
            ctx.set_forkserver_preload(
                ["var_tpu_torch.envs.vec.worker_preload"])
        self.timeout = float(timeout)
        # one env in this process for the spaces (the reference probes
        # the same way, shmem_vec_env.py:33-37)
        probe = env_fns[0]()
        observation_space, action_space = (probe.observation_space,
                                           probe.action_space)
        probe.close()
        del probe
        super().__init__(len(env_fns), observation_space, action_space)

        self.obs_keys, self.obs_shapes, self.obs_dtypes = [], {}, {}
        for key, space in observation_space.items():
            self.obs_keys.append(key)
            self.obs_shapes[key] = space.shape
            self.obs_dtypes[key] = np.dtype(space.dtype)

        self.segment = None
        if transport == "array":
            self.obs_bufs = [
                {k: ctx.Array(_NP_TO_CT[self.obs_dtypes[k]],
                              int(np.prod(self.obs_shapes[k])), lock=False)
                 for k in self.obs_keys}
                for _ in env_fns]
        else:
            self.segment = ShmObsSegment(self.obs_keys, self.obs_shapes,
                                         self.obs_dtypes, len(env_fns))
            self.obs_bufs = [self.segment.worker_handle() for _ in env_fns]
        self.parent_pipes, self.procs = [], []
        self.waiting_step = False
        self.obs_list = [None] * self.num_envs
        try:
            for i, (env_fn, obs_buf) in enumerate(zip(env_fns,
                                                      self.obs_bufs)):
                parent_pipe, child_pipe = ctx.Pipe()
                proc = ctx.Process(
                    target=_subproc_worker,
                    args=(child_pipe, parent_pipe, env_fn, obs_buf,
                          self.obs_shapes, self.obs_dtypes, self.obs_keys,
                          audio, i),
                    daemon=True)
                with worker_environment():
                    proc.start()
                self.procs.append(proc)
                self.parent_pipes.append(parent_pipe)
                child_pipe.close()
        except BaseException:
            self._stop()
            raise

    def reset(self):
        if self.waiting_step:
            self.step_wait()
        for pipe in self.parent_pipes:
            pipe.send(("reset", None))
        for i, pipe in enumerate(self.parent_pipes):
            self._recv_checked(pipe, i)
        return self._decode_obses()

    def step_async(self, actions):
        assert len(actions) == self.num_envs
        for pipe, act in zip(self.parent_pipes, actions):
            pipe.send(("step", act))
        self.waiting_step = True

    def _recv_checked(self, pipe, idx):
        """recv that raises when the worker has died or has not answered
        within the timeout; the reference's parent blocks forever then
        (SURVEY.md §5.3)."""
        proc, waited = self.procs[idx], 0.0
        while not pipe.poll(min(1.0, self.timeout)):
            if not proc.is_alive():
                break
            waited += min(1.0, self.timeout)
            if waited >= self.timeout:
                raise TimeoutError(f"ShmemVecEnv worker {idx} did not "
                                   f"answer within {self.timeout} s")
        try:
            msg = pipe.recv()
        except EOFError:  # the worker closed its end: it has died
            proc.join(timeout=min(self.timeout, 10.0))
            raise RuntimeError(f"ShmemVecEnv worker {idx} died (exitcode "
                               f"{proc.exitcode})") from None
        if isinstance(msg, _WorkerError):
            # the env stack is unusable: stop every worker, then raise the
            # worker's own exception here
            self.waiting_step = False
            self._stop()
            self.closed = True
            exc = msg.exc
            exc.add_note(f"in ShmemVecEnv worker {idx}:\n{msg.trace}")
            raise exc
        return msg

    def step_wait(self):
        self.waiting_step = False  # owed no more, even if a worker fails
        outs = [self._recv_checked(pipe, i)
                for i, pipe in enumerate(self.parent_pipes)]
        _, rews, dones, infos = zip(*outs)
        obs = self._decode_obses()
        return (obs, np.asarray(rews, dtype=np.float32),
                np.asarray(dones, dtype=bool), tuple(infos))

    def _broadcast(self, cmd, data=None):
        for pipe in self.parent_pipes:
            pipe.send((cmd, data))
        return [self._recv_checked(pipe, i)
                for i, pipe in enumerate(self.parent_pipes)]

    def get_images(self):
        """Every worker's rgb_array frame, in env order (reference:
        shmem_vec_env.py:97-100); the base render() tiles them."""
        return self._broadcast("render", "rgb_array")

    def worker_info(self):
        """Per worker: its pid, whether torch has a CUDA context there,
        torch's thread count, OPENBLAS_NUM_THREADS as the worker started
        with it, and its resident and private resident bytes (_memory)."""
        return self._broadcast("info")

    def close_extras(self):
        try:
            if self.waiting_step:
                self.step_wait()
            self._broadcast("close")
        finally:
            self._stop()

    def _stop(self):
        """Join the workers (terminating any that do not stop) and unlink
        the segment."""
        for pipe in self.parent_pipes:
            pipe.close()
        for proc in self.procs:
            proc.join(timeout=min(self.timeout, 10.0))
            if proc.is_alive():
                proc.terminate()
                proc.join()
        if self.segment is not None:
            self.segment.close()

    def _decode_obses(self):
        """Batched arrays and the per-env obs_list from the shared memory
        (reference: shmem_vec_env.py:105-115 keeps both forms)."""
        result = OrderedDict()
        self.obs_list = [dict() for _ in range(self.num_envs)]
        if self.segment is not None:
            # the segment is the batched array: one copy per key
            for k in self.obs_keys:
                batched = self.segment.batched(k).copy()
                result[k] = batched
                for i in range(self.num_envs):
                    self.obs_list[i][k] = batched[i]
            return result
        for k in self.obs_keys:
            per_env = [np.frombuffer(b[k], dtype=self.obs_dtypes[k]).reshape(
                self.obs_shapes[k]) for b in self.obs_bufs]
            for i, arr in enumerate(per_env):
                self.obs_list[i][k] = arr.copy()
            result[k] = np.stack(per_env)
        return result


def _memory():
    """(resident, private resident) bytes of this process, from
    /proc/self/statm (resident less the pages shared with other processes:
    the libraries and what the forkserver's pages still share)."""
    with open("/proc/self/statm") as f:
        resident, shared = map(int, f.read().split()[1:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page, (resident - shared) * page


class _WorkerError:
    """A worker's exception and its formatted traceback, sent in place of
    an answer."""

    def __init__(self, exc: BaseException, trace: str):
        try:
            pickle.dumps(exc)
        except Exception:
            exc = RuntimeError(f"{type(exc).__name__}: {exc}")
        self.exc, self.trace = exc, trace


def _subproc_worker(pipe, parent_pipe, env_fn, obs_buf, obs_shapes,
                    obs_dtypes, keys, audio, env_idx=0):
    """(reference: shmem_vec_env.py:117-154). One torch thread: with one
    worker per env, a thread pool in each would oversubscribe the host's
    cores (numpy's BLAS is held to one by worker_environment)."""
    import torch

    torch.set_num_threads(1)
    if isinstance(obs_buf, ShmObsWorker):
        views = obs_buf.open(env_idx)  # this env's rows of the segment

        def _write_obs(obs):
            for k in keys:
                np.copyto(views[k], np.asarray(obs[k]).reshape(obs_shapes[k]))
    else:
        def _write_obs(obs):
            for k in keys:
                dst = np.frombuffer(obs_buf[k], dtype=obs_dtypes[k]).reshape(
                    obs_shapes[k])
                np.copyto(dst, np.asarray(obs[k]).reshape(obs_shapes[k]))

    parent_pipe.close()
    env = None
    try:
        env = env_fn()
        if audio is not None:
            env.unwrapped.audio = audio
            audio.loadData()
        while True:
            cmd, data = pipe.recv()
            if cmd == "reset":
                _write_obs(env.reset())
                pipe.send(("ok",))
            elif cmd == "step":
                obs, reward, done, info = env.step(data)
                if done:
                    obs = env.reset()
                _write_obs(obs)
                pipe.send((None, reward, done, info))
            elif cmd == "render":
                pipe.send(env.render(mode=data))
            elif cmd == "info":
                rss, private = _memory()
                pipe.send(dict(pid=os.getpid(),
                               cuda_initialized=torch.cuda.is_initialized(),
                               threads=torch.get_num_threads(),
                               blas_threads=os.environ.get(
                                   "OPENBLAS_NUM_THREADS"),
                               rss=rss, private=private))
            elif cmd == "close":
                pipe.send(None)
                break
            else:
                raise RuntimeError(f"Got unrecognized cmd {cmd}")
    except KeyboardInterrupt:
        print("ShmemVecEnv worker: got KeyboardInterrupt")
    except (EOFError, BrokenPipeError):
        pass  # the parent closed its end: it has stopped the stack
    except Exception as e:
        try:
            pipe.send(_WorkerError(e, traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
    finally:
        if env is not None:
            env.close()
