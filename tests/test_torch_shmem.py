"""The port's ShmemVecEnv (envs/vec/shmem.py, shm_transport.py) against its
DummyVecEnv and against the JAX package's ShmemVecEnv: the counterparts of
tests/test_vec_rl.py's shared-memory tests, the real sims of both profiles
on both transports, worker faults, and grid pretext collection at both
packages' defaults.

Workers start with 'fork' where a test does not need the forkserver (it is
the cheap start); the tests of the default path use the forkserver. Every
env is closed in a finalizer, and the fault tests give the parent a short
timeout, so a hang fails within seconds instead of stalling the run."""
import os
import pickle
import time

import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data.audio_store import AudioStore as JAudioStore
from var_tpu.envs.vec import factory as jfactory
from var_tpu.envs.vec.shmem import ShmemVecEnv as JShmemVecEnv
from var_tpu_torch import config as tconfig
from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs.fake import FakeArmEnv
from var_tpu_torch.envs.vec import shm_transport
from var_tpu_torch.envs.vec.dummy import DummyVecEnv
from var_tpu_torch.envs.vec.factory import EnvThunk, make_vec_envs
from var_tpu_torch.envs.vec.shmem import ShmemVecEnv
from var_tpu_torch.envs.vec.wrappers import tile_images

TIMEOUT = 60.0  # seconds a worker may take to answer in these tests
EPISODE = 4  # steps; each test steps through 2 episodes


@pytest.fixture(scope="module", autouse=True)
def own_forkserver():
    """The forkserver is one per process: one that another test file of
    this pytest worker started (the JAX package's shmem tests) would fork
    the port's workers from its own preload and environment. Stop it, so
    this file's first forkserver worker starts the port's, and stop that
    one at the end."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()
    yield
    forkserver._forkserver._stop()


@pytest.fixture
def closing():
    """Register envs to close at the test's end, pass or fail."""
    envs = []
    yield envs.append
    for env in reversed(envs):
        env.close()


def _fake(seed, max_steps=3):
    def fn():
        e = FakeArmEnv(max_steps=max_steps)
        e.seed(seed)
        return e
    return fn


def _assert_obs_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_obs_lists_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(
                np.asarray(g[k]).reshape(np.shape(w[k])), w[k], err_msg=k)


# -- the counterparts of tests/test_vec_rl.py ---------------------------------


@pytest.mark.parametrize("transport", ["array", "posix"])
def test_shmem_vecenv_matches_dummy(transport, closing):
    """test_vec_rl.py:59 and :619: FakeArmEnv through both backends."""
    dummy = DummyVecEnv([_fake(7), _fake(7)])
    closing(dummy)
    shmem = ShmemVecEnv([_fake(7), _fake(7)], context="fork",
                        transport=transport, timeout=TIMEOUT)
    closing(shmem)
    assert (shmem.segment is not None) == (transport == "posix")
    _assert_obs_equal(shmem.reset(), dummy.reset())
    actions = np.ones((2, 2), np.float32) * 0.5
    for _ in range(4):
        od, rd, dd, _ = dummy.step(actions)
        osh, rs, ds, _ = shmem.step(actions)
        np.testing.assert_array_equal(dd, ds)
        np.testing.assert_array_equal(rd, rs)
        _assert_obs_equal(osh, od)
        for i in range(2):
            np.testing.assert_array_equal(shmem.obs_list[i]["image"],
                                          osh["image"][i])


def test_get_images_and_tiled_render(closing):
    """test_vec_rl.py:84: one frame per env in env order, tiled."""
    venvs = (DummyVecEnv([_fake(3), _fake(4)]),
             ShmemVecEnv([_fake(3), _fake(4)], context="fork",
                         timeout=TIMEOUT))
    for venv in venvs:
        closing(venv)
    for venv in venvs:
        venv.reset()
        imgs = venv.get_images()
        assert len(imgs) == 2
        assert imgs[0][1, 1, 0] == 3 and imgs[1][1, 1, 0] == 4
        big = venv.render("rgb_array")
        np.testing.assert_array_equal(big, tile_images(imgs))
        assert big.shape == (16, 8, 3)


def test_shmem_forkserver_with_registry(closing):
    """test_vec_rl.py:111: the default path (make_vec_envs, 'shmem', the
    forkserver) through a registered env. A forkserver worker's registry
    is empty, so the thunk carries the resolved constructor; it pickles
    with plain pickle, since the card's machine has no cloudpickle."""
    cfg = tconfig.main_config(env="arms")
    cfg.override(vecEnvBackend="shmem", RLTrain=True, RLModelFineTune=False,
                 RLEnvMaxSteps=3)
    tconfig.gym_register(cfg, env="arms")
    thunk = pickle.loads(pickle.dumps(EnvThunk(cfg.RLEnvName, 11, 1)))
    assert thunk().unwrapped.givenSeed == 12
    envs = make_vec_envs(cfg.RLEnvName, seed=11, num_processes=2, gamma=None,
                         randomCollect=True, config=cfg)
    closing(envs)
    assert type(envs) is ShmemVecEnv and envs.segment is not None
    obs = envs.reset()
    assert obs["image"].shape == (2, 3, 96, 96)
    obs, rew, done, infos = envs.step(np.zeros((2, 2), np.float32))
    assert rew.shape == (2,)
    info = envs.worker_info()
    assert [w["cuda_initialized"] for w in info] == [False, False]
    assert [w["threads"] for w in info] == [1, 1]
    assert [w["blas_threads"] for w in info] == ["1", "1"]
    assert all(0 < w["private"] <= w["rss"] for w in info)


def test_shm_posix_transport_roundtrip():
    """test_vec_rl.py:597: the parent's batched views see a worker's row."""
    assert shm_transport.available()
    seg = shm_transport.ShmObsSegment(
        ["image", "pose"], {"image": (3, 4, 4), "pose": (2,)},
        {"image": np.uint8, "pose": np.float32}, num_envs=3)
    try:
        handle = pickle.loads(pickle.dumps(seg.worker_handle()))
        views = handle.open(1)
        views["image"][:] = 7
        views["pose"][:] = [1.5, -2.5]
        assert (seg.batched("image")[1] == 7).all()
        assert (seg.batched("image")[0] == 0).all()
        np.testing.assert_array_equal(seg.batched("pose")[1], [1.5, -2.5])
    finally:
        seg.close()
    assert not os.path.exists("/dev/shm" + seg.name)


# -- the real sims, port against dummy and against JAX ---------------------


def _sim_setup(env, monkeypatch):
    """(JAX config, port config, JAX audio, port audio), envs registered."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env=env)
        cfg.override(RLTrain=True, RLEnvMaxSteps=EPISODE,
                     sound_dim=(1, 100, 40))
        mod.gym_register(cfg, env=env)
        out.append(cfg)
    jaudio, taudio = JAudioStore(out[0]), AudioStore(out[1])
    jaudio.loadData()
    taudio.loadData()
    return out[0], out[1], jaudio, taudio


def _actions(env, t, n):
    if env == "arms":
        rng = np.random.RandomState(t)
        return rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    return (np.arange(n) + 3 * t) % 8


@pytest.mark.parametrize("transport", ["array", "posix"])
@pytest.mark.parametrize("env", ["arms", "ai2thor"])
def test_real_sims_match_dummy_and_jax(env, transport, monkeypatch, closing):
    """Both profiles' RL sims over 2 episodes at 2 envs: the port's
    ShmemVecEnv, its DummyVecEnv and the JAX package's ShmemVecEnv give
    equal observations, rewards, dones and obs_list from the same seeds."""
    jcfg, tcfg, jaudio, taudio = _sim_setup(env, monkeypatch)
    n, seed = 2, 5
    port = ShmemVecEnv([EnvThunk(tcfg.RLEnvName, seed, i) for i in range(n)],
                       context="fork", audio=taudio, transport=transport,
                       timeout=TIMEOUT)
    closing(port)
    dummy = DummyVecEnv([EnvThunk(tcfg.RLEnvName, seed, i)
                         for i in range(n)], audio=taudio)
    closing(dummy)
    jax = JShmemVecEnv(
        [jfactory.make_env_thunk(jcfg.RLEnvName, seed, i) for i in range(n)],
        context="fork", audio=jaudio, transport=transport)
    closing(jax)
    want = jax.reset()
    _assert_obs_equal(port.reset(), want)
    _assert_obs_equal(dummy.reset(), want)
    dones = 0
    for t in range(2 * EPISODE):
        a = _actions(env, t, n)
        jo, jr, jd, _ = jax.step(a)
        for venv in (port, dummy):
            o, r, d, infos = venv.step(a)
            _assert_obs_equal(o, jo)
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(d, jd)
            assert len(infos) == n
        _assert_obs_lists_equal(port.obs_list, jax.obs_list)
        _assert_obs_lists_equal(port.obs_list, dummy.obs_list)
        dones += int(jd.sum())
    assert dones == 2 * n  # two whole episodes, auto-reset in the worker


# -- faults and clean-up ------------------------------------------------------


class _DyingEnv(FakeArmEnv):
    def step(self, action):
        if self.envStepCounter == 1:
            os._exit(3)
        return super().step(action)


class _StuckEnv(FakeArmEnv):
    def step(self, action):
        time.sleep(30)
        return super().step(action)


def _make(cls):
    def fn():
        e = cls(max_steps=5)
        e.seed(0)
        return e
    return fn


def test_a_dead_worker_raises_and_close_cleans_up():
    venv = ShmemVecEnv([_fake(0), _make(_DyingEnv)], context="fork",
                       timeout=TIMEOUT)
    name = venv.segment.name
    try:
        venv.reset()
        venv.step(np.zeros((2, 2), np.float32))
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="worker 1 died"):
            venv.step(np.zeros((2, 2), np.float32))
        assert time.perf_counter() - t0 < 10
    finally:
        with pytest.raises((RuntimeError, BrokenPipeError, EOFError)):
            venv.close()
    assert not any(p.is_alive() for p in venv.procs)
    assert not os.path.exists("/dev/shm" + name)


def test_a_stuck_worker_times_out():
    venv = ShmemVecEnv([_fake(0), _make(_StuckEnv)], context="fork",
                       timeout=1.0)
    try:
        venv.reset()
        with pytest.raises(TimeoutError, match="worker 1"):
            venv.step(np.zeros((2, 2), np.float32))
    finally:
        with pytest.raises(TimeoutError):
            venv.close()  # its step is still owed; the workers are stopped
    assert not any(p.is_alive() for p in venv.procs)


def test_close_leaves_no_segment_and_stops_workers(closing):
    venv = ShmemVecEnv([_fake(1), _fake(2)], context="fork", timeout=TIMEOUT)
    name = venv.segment.name
    assert os.path.exists("/dev/shm" + name)
    venv.reset()
    venv.close()
    assert not os.path.exists("/dev/shm" + name)
    assert [p.exitcode for p in venv.procs] == [0, 0]
    with pytest.raises(ValueError, match="unknown transport"):
        ShmemVecEnv([_fake(1)], context="fork", transport="mpi")


def test_worker_environment_pins_threads_and_restores(monkeypatch):
    """Workers start with one thread per pool and no MPI variables; the
    parent's environment comes back afterwards."""
    from var_tpu_torch.envs.vec.base import THREAD_VARS, worker_environment

    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    monkeypatch.delenv("MKL_NUM_THREADS", raising=False)
    before = dict(os.environ)
    with worker_environment():
        assert all(os.environ[k] == "1" for k in THREAD_VARS)
        assert "OMPI_COMM_WORLD_RANK" not in os.environ
    assert dict(os.environ) == before


def test_the_audio_store_pickles_without_torch(monkeypatch):
    """Each worker gets the store by plain pickle; it carries numpy only,
    no torch tensor (which would drag torch's sharing machinery and, for a
    CUDA tensor, a CUDA context into the worker)."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    import io

    for env in ("arms", "ai2thor"):
        store = AudioStore(tconfig.main_config(env=env))
        store.loadData()

        class NoTensors(pickle.Pickler):
            def persistent_id(self, obj):
                assert not isinstance(obj, torch.Tensor), "a tensor"
                return None

        NoTensors(io.BytesIO()).dump(store)


# -- grid pretext collection at both packages' defaults ----------------------


def test_grid_collection_at_the_defaults_matches_jax(tmp_path, monkeypatch):
    """vecEnvBackend 'auto' at 2 envs on both sides: each package's
    ShmemVecEnv from the forkserver, each sim on its native render. The
    shards are byte-identical."""
    from var_tpu.train import pretext as jpretext
    from var_tpu_torch.train import pretext as tpretext

    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    knobs = dict(pretextCollectNum=[2, 2, 2, 2, 4], pretextDataEpisode=3,
                 pretextDataNumFiles=1, pretextEnvMaxSteps=6,
                 pretextNumEnvs=2, sound_dim=(1, 100, 40))
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env="ai2thor")
        cfg.override(pretextDataDir=[str(tmp_path / tag)], **knobs)
        assert cfg.vecEnvBackend == "auto"
        assert cfg.vecEnvContext == "forkserver"
        mod.gym_register(cfg, env="ai2thor")
        if tag == "jax":
            jpretext.PretextTrainer(cfg).collectPretextData()
        else:
            tpretext.PretextTrainer(cfg, device="cpu").collectPretextData()
    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert names and names == sorted(os.listdir(tmp_path / "port" / "train"))
    for name in names:
        want = (tmp_path / "jax" / "train" / name).read_bytes()
        assert (tmp_path / "port" / "train" / name).read_bytes() == want
