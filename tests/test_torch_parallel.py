"""meshShape data parallelism on torch.distributed (var_tpu_torch/parallel/)
against dp=1 and against the JAX package's unsharded functions, on the CPU.

One spawn of 4 gloo ranks (init_method file:// in the test's directory,
one torch thread a rank) runs every check of tests/torch_parallel_ranks.py
on two meshes: {'dp': 4}, and {'dp': 2, 'rep': 2} (two lines of dp=2,
replicated over 'rep'); then the pretext entry point joins the group as a
torchrun launch's would, at dp=4. The ranks start first and wait for the
inputs this process writes. The same checks run in the test process with
no mesh (dp=1), and the JAX package's unsharded functions run on the same
inputs beside them. The test functions below assert the results, so each
check counts on its own:
- arm pretext, 3 steps through audioBackend='pallas' (its plain version
  on the CPU), batch 8, on the resident bank, on the streaming path (each
  rank uploading its block of the host batch) and through the multi-bank
  step (two banks holding the same clips); ai2thor pretext, 1 step,
  batch 4, sound 1x100x40;
- one collect and one PPO update of each device sim (8 envs x 4 steps,
  GRU 32, 2 epochs x 2 minibatches): the arm's from JAX's draws (global,
  each rank taking its block), the grid's from its generator's global
  draws;
- one rollout and update of the arm's fused host path (8 envs x 3 steps,
  each rank's host envs its block), the action noise from the trainer's
  generator;
- every rank's parameters bit-equal to rank 0's after the updates.
Both entry points then run in the group as under a torchrun launcher, at
dp=4 (pretext with collection on rank 0; one RL device-sim update).

Tolerances (those of the files that hold dp=1 to JAX):
- losses, rollout values, the return-RMS, rewards and metrics at rtol =
  atol = 1e-4 (IEEE float32 on both sides, another order of summation);
  the ai2thor CRNN's at rtol 1e-3 / atol 2e-4 (BASELINE.md);
- images and discrete actions equal;
- parameters within 2 x lr per optimizer step + 5e-5, median below 1e-6
  (Adam moves a weight by about lr whatever its gradient, so a gradient
  near zero that rounds to the other sign differs by 2 lr a step);
- across ranks: equal bit for bit.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.models.encoders import build_pretext_model, init_pretext_params
from var_tpu.parallel import mesh as jmesh
from var_tpu.train import pretext as jpretext
from var_tpu_torch.convert import ai2thor_state_dict, arm_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.envs import arm_sim_device as tsim
from var_tpu_torch.models.policy import build_policy
from var_tpu_torch.parallel import mesh as tmesh
from var_tpu_torch.rl.device_sim import CollectDraws
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from var_tpu_torch.train.rl import device_sim_profile

import torch_parallel_ranks as ranks

TOL = dict(rtol=1e-4, atol=1e-4)
CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
PRETEXT_STEPS = {"arms": 3, "ai2thor": 1}
CLIPS = 2  # synthetic clips per class (VAR_TPU_SYNTH_CLIPS)
ENTRY_SETS = {
    "pretext": ["pretextCollectNum=[4,4,4,4,8]", "pretextDataEpisode=4",
                "pretextDataNumFiles=2", "pretextEnvMaxSteps=8",
                "pretextNumEnvs=2", "pretextEpoch=1",
                "pretextModelSaveInterval=1", "pretextTrainBatchSize=8",
                "pretextModelFineTune=False", "pretextDataset='VARDataset'",
                "vecEnvBackend='dummy'", "audioBackend='pallas'"],
    "rl": ["RLTrain=True", "RLModelFineTune=False", "RLNumEnvs=8",
           "RLEnvMaxSteps=4", "ppoNumSteps=4", "RLTotalSteps=32",
           "ppoNumMiniBatch=2", "ppoEpoch=1", "RLRecurrentSize=32",
           "RLRecurrentInputSize=16", "RLModelSaveInterval=1",
           "RLLogInterval=1", "RLDeviceSimRollout=True",
           "vecEnvBackend='dummy'"]}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jconfig(profile, **extra):
    cfg = jconfig.main_config(env=profile)
    cfg.override(**ranks.overrides(profile, **extra))
    jconfig.gym_register(cfg, env=profile)
    return cfg


def _jax_collect_draws(key, k, n, t):
    """JAX's arm collect draws from `key` (var_tpu/rl/device_sim.py), as
    the port's CollectDraws (tests/test_torch_device_sim.py makes them so
    for 4 envs and 4 clips a class)."""
    from test_torch_device_sim import _jax_reset_draws

    kr, ki, kc, ka, ks = jax.random.split(key, 5)
    noise = [jax.random.normal(ka, (n, 2))] + [
        jax.random.normal(s, (n, 2)) for s in jax.random.split(ks, t)]
    return CollectDraws(
        _jax_reset_draws(kr, n, k),
        _t(jax.random.randint(ki, (n,), 0, 4)).long(),
        _t(jax.random.randint(kc, (n,), 0, CLIPS)).long(),
        _t(jnp.stack(noise)))


def _write_pretext(work, profile, jcfg, audio):
    """JAX's initial VAR (converted) and the steps' index rows over a
    random image set and the store's clip bank."""
    model = build_pretext_model(jcfg)
    params = jax.jit(lambda key: init_pretext_params(model, jcfg, key))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    convert = arm_state_dict if profile == "arms" else ai2thor_state_dict
    torch.save(convert(params), os.path.join(work, f"{profile}_var.pt"))
    bank, lengths, ranges = audio.build_clip_bank()
    rng = np.random.RandomState(1)
    steps, b = PRETEXT_STEPS[profile], jcfg.pretextTrainBatchSize
    images = rng.randint(0, 256, (12, 3, 96, 96)).astype(np.uint8)
    pos_ids, pos_zero = audio.sample_clip_ids(
        rng.randint(0, 5, steps * b), ranges, rng)
    neg_ids, neg_zero = audio.sample_clip_ids(
        rng.randint(0, 5, steps * b), ranges, rng)
    np.savez(os.path.join(work, f"{profile}_pretext.npz"), images=images,
             wav=bank, len=lengths,
             img=rng.randint(0, 12, (steps, b)).astype(np.int64),
             pos=pos_ids.reshape(steps, b).astype(np.int64),
             pos_zero=pos_zero.reshape(steps, b),
             neg=neg_ids.reshape(steps, b).astype(np.int64),
             neg_zero=neg_zero.reshape(steps, b))
    return params


def _jax_pretext(work, profile, jcfg, audio, params):
    """JAX's unsharded steps on the same inputs: (losses, parameters)."""
    d = np.load(os.path.join(work, f"{profile}_pretext.npz"))
    tr = jpretext.PretextTrainer(jcfg, audio=audio)
    tr._ensure_audio()
    tr.tx = jpretext.make_optimizer(jcfg, steps_per_epoch=10)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jpretext.TrainState(params, tr.tx.init(params),
                                jnp.asarray(0, jnp.int32))
    losses = []
    for s in range(PRETEXT_STEPS[profile]):
        state, loss = tr._train_step_indexed(
            state, *(jnp.asarray(d[k]) for k in ("images", "wav", "len")),
            *(jnp.asarray(d[k][s]) for k in ("img", "pos", "pos_zero",
                                              "neg", "neg_zero")))
        losses.append(float(loss))
    convert = arm_state_dict if profile == "arms" else ai2thor_state_dict
    return np.array(losses), convert(jax.tree_util.tree_map(np.asarray,
                                                            state.params))


def _policy_input(work, profile, seed):
    """The profile's policy, the port's draw from `seed` (the sim checks
    hold dp=n to dp=1, whose engines other files hold to JAX's)."""
    tcfg = ranks.knobs(profile)
    space, _ = device_sim_profile(tcfg)
    pol = build_policy(tcfg, space)
    pol.reset_parameters(torch.Generator().manual_seed(seed))
    torch.save(pol.state_dict(), os.path.join(work, f"{profile}_policy.pt"))


def _jax_runs(work, params):
    out = {}
    for profile in ("arms", "ai2thor"):
        jcfg = _jconfig(profile)
        jaudio = jstore.AudioStore(jcfg)
        jaudio.loadData()
        out[f"{profile}_pretext"] = _jax_pretext(work, profile, jcfg, jaudio,
                                                 params[profile])
    return out


def _arm_sim_inputs(work, jcfg):
    """The arm device sim's inputs: the policy; JAX's global collect draws
    from PRNGKey(2) over all envs and its update's permutations from
    PRNGKey(11), as tests/test_torch_device_sim.py makes them for the
    collect and update it holds to JAX's unsharded engine."""
    n, t = ranks.SIM_N, ranks.SIM_T
    _policy_input(work, "arms", 1)
    tcfg = ranks.knobs("arms")
    torch.save(_jax_collect_draws(jax.random.PRNGKey(2),
                                  tsim.consts_from_config(tcfg), n, t),
               os.path.join(work, "arms_draws.pt"))
    perms, k = [], jax.random.PRNGKey(11)
    for _ in range(jcfg.ppoEpoch):
        k, sub = jax.random.split(k)
        perms.append(np.asarray(jax.random.permutation(sub, n)))
    torch.save(torch.from_numpy(np.stack(perms)).long(),
               os.path.join(work, "arms_perms.pt"))


def _grid_inputs(work):
    """The grid policy and the update's permutations."""
    tcfg = ranks.knobs("ai2thor")
    _policy_input(work, "ai2thor", 3)
    g = torch.Generator().manual_seed(4)
    torch.save(torch.stack([torch.randperm(ranks.SIM_N, generator=g)
                            for _ in range(tcfg.ppoEpoch)]),
               os.path.join(work, "ai2thor_perms.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank spawn, started first (its ranks wait for the inputs);
    the inputs written; JAX and dp=1 in this process meanwhile."""
    work = str(tmp_path_factory.mktemp("parallel"))
    threads = torch.get_num_threads()
    os.environ["VAR_TPU_SYNTH_CLIPS"] = str(CLIPS)
    try:
        torch.set_num_threads(1)
        with ThreadPoolExecutor(max_workers=2) as ex:
            spawned = ex.submit(
                tmesh.launch, ranks.rank_main, (work,), 4, device="cpu",
                backend="gloo", threads=1,
                init_method="file://" + os.path.join(work, "store"))
            written = False
            try:
                params = {}
                for profile in ("arms", "ai2thor"):
                    audio = tstore.AudioStore(ranks.knobs(profile))
                    audio.loadData()
                    params[profile] = _write_pretext(
                        work, profile, _jconfig(profile), audio)
                _arm_sim_inputs(work, _jconfig("arms"))
                _grid_inputs(work)
                save_checkpoint(os.path.join(work, "rl_var"), {
                    "params": torch.load(os.path.join(work, "arms_var.pt"))})
                with open(os.path.join(work, "entry.json"), "w") as f:
                    json.dump(ENTRY_SETS, f)
                written = True
            finally:
                ranks.mark_inputs(work, written)
            # JAX's steps (mostly XLA compiling) beside dp=1's
            jax_run = ex.submit(_jax_runs, work, params)
            with ranks.mfcc_memo():
                dp1 = ranks.run_checks(work, None)
            from var_tpu_torch.pretext import main as pretext_main
            from var_tpu_torch.rl import main as rl_main

            pretext_main(ranks.entry_point_args(
                work, os.path.join(work, "entry_dp1")))
            rl_main(ranks.rl_entry_point_args(
                work, os.path.join(work, "rl_dp1")))
            jax_out = jax_run.result()
            spawned.result()
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
        torch.set_num_threads(threads)
    sharded = {(dp, r): torch.load(os.path.join(work, f"rank{r}_dp{dp}.pt"),
                                   weights_only=False)
               for dp in (4, 2) for r in range(4)}
    return dict(work=work, dp1=dp1, jax=jax_out, sharded=sharded)


def _assert_params(got, want, bound, what):
    diffs = torch.cat([(got[k].float() - want[k].float()).abs().ravel()
                       for k in want])
    assert diffs.max().item() <= bound, (what, diffs.max().item(), bound)
    assert diffs.median().item() < 1e-6, (what, diffs.median().item())


# -- the mesh alone ------------------------------------------------------------


@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 4, 0), ((8, 3), 4, 0), ((3, 7, 2), 3, 1), ((1,), 2, 0)])
def test_pad_to_multiple_equals_jax(shape, multiple, axis):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got, n = tmesh.pad_to_multiple(x, multiple, axis)
    want, wn = jmesh.pad_to_multiple(x, multiple, axis)
    assert n == wn
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [{"dp": 9}, {"dp": 3, "mp": 3}])
def test_build_mesh_raises_where_jax_raises(shape):
    """More ranks than the process has (JAX: than the host's 8 CPU
    devices of tests/conftest.py) raise on both sides."""
    with pytest.raises(ValueError, match="needs 9"):
        jmesh.build_mesh(shape)
    with pytest.raises(ValueError, match="needs 9 ranks"):
        tmesh.build_mesh(shape)


def test_indivisible_counts_raise():
    """Counts that do not divide by dp raise, as XLA's uneven shard does:
    the mesh's block, an engine's env count, a pretext batch."""
    mesh = tmesh.Mesh({"dp": 3}, 0, 3, None, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard(torch.zeros(8, 2), 0)
    assert mesh.shard(torch.arange(9), 0).tolist() == [0, 1, 2]
    cfg = ranks.knobs("arms")
    tr = ranks.PretextTrainer(cfg, device="cpu")
    tr.mesh = mesh
    with pytest.raises(ValueError, match="the batch 8 does not divide"):
        tr._local(torch.zeros(8))
    from var_tpu_torch.rl.rollout_device import DeviceRolloutEngine

    with pytest.raises(ValueError, match="RLNumEnvs 8 does not divide"):
        DeviceRolloutEngine(None, type("P", (), {
            "recurrent_hidden_state_size": 4})(), cfg, 3, 8, "robot_pose",
            (2,), torch.float32, (2,), torch.float32, mesh=mesh)


# -- the sharded paths against dp=1 and JAX ------------------------------------


@pytest.mark.parametrize("dp", [4, 2])
@pytest.mark.parametrize("profile", ["arms", "ai2thor"])
def test_pretext_matches_dp1_and_jax(runs, profile, dp):
    tol = TOL if profile == "arms" else CRNN_TOL
    got = runs["sharded"][(dp, 0)][f"{profile}_pretext"]
    dp1 = runs["dp1"][f"{profile}_pretext"]
    jlosses, jparams = runs["jax"][f"{profile}_pretext"]
    np.testing.assert_allclose(_np(got["losses"]), _np(dp1["losses"]), **tol)
    np.testing.assert_allclose(_np(got["losses"]), jlosses, **tol)
    bound = 2 * 1e-4 * PRETEXT_STEPS[profile] + 5e-5
    _assert_params(got["params"], dp1["params"], bound, "dp1")
    _assert_params(got["params"], jparams, bound, "jax")


@pytest.mark.parametrize("dp", [4, 2])
@pytest.mark.parametrize("path", ["arms_stream", "arms_multibank"])
def test_other_pretext_steps_match_dp1_and_the_indexed_step(runs, path,
                                                            dp):
    """The streaming step (each rank uploading its block of the host
    batch) and the multi-bank step (its (B, K) columns split by row) on
    the same batches: dp=n against dp=1, and against the indexed step's
    losses and parameters."""
    got = runs["sharded"][(dp, 0)][path]
    for want in (runs["dp1"][path], runs["dp1"]["arms_pretext"]):
        np.testing.assert_allclose(_np(got["losses"]), _np(want["losses"]),
                                   **TOL)
        _assert_params(got["params"], want["params"],
                       2 * 1e-4 * PRETEXT_STEPS["arms"] + 5e-5, "stream")


def _assert_rollout(got, want, exact_actions):
    np.testing.assert_array_equal(_np(got["image"]), _np(want["image"]))
    if exact_actions:
        np.testing.assert_array_equal(_np(got["actions"]),
                                      _np(want["actions"]))
    for k in ("actions", "value_preds", "returns", "old_log_probs", "rms",
              "ep_raw", "metrics"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("dp", [4, 2])
def test_arm_device_sim_matches_dp1(runs, dp):
    """The arm's collect from JAX's global draws and its update with JAX's
    permutations: dp=n steps what dp=1 does (dp=1's engine and update on
    JAX's draws are held to JAX's unsharded ones by
    tests/test_torch_device_sim.py)."""
    got, dp1 = runs["sharded"][(dp, 0)]["arms_sim"], runs["dp1"]["arms_sim"]
    _assert_rollout(got, dp1, False)
    np.testing.assert_allclose(_np(got["rewards"]), _np(dp1["rewards"]),
                               **TOL)
    cfg = ranks.knobs("arms")
    bound = 2 * cfg.RLLr * cfg.ppoEpoch * cfg.ppoNumMiniBatch + 5e-5
    _assert_params(got["params"], dp1["params"], bound, "dp1")


@pytest.mark.parametrize("dp", [4, 2])
def test_grid_device_sim_matches_dp1(runs, dp):
    """The grid's collect from its generator's global draws: dp=n draws and
    steps what dp=1 does (the grid engine's dp=1 is held to JAX by
    tests/test_torch_grid_rl.py)."""
    got, dp1 = runs["sharded"][(dp, 0)]["ai2thor_sim"], \
        runs["dp1"]["ai2thor_sim"]
    _assert_rollout(got, dp1, True)
    np.testing.assert_allclose(_np(got["rewards"]), _np(dp1["rewards"]),
                               **TOL)
    cfg = ranks.knobs("ai2thor")
    bound = 2 * cfg.RLLr * cfg.ppoEpoch * cfg.ppoNumMiniBatch + 5e-5
    _assert_params(got["params"], dp1["params"], bound, "dp1")


@pytest.mark.parametrize("dp", [4, 2])
def test_fused_host_cycle_matches_dp1(runs, dp):
    """The fused host path: each rank's host envs and its block of the
    generator's noise give dp=1's rollout, log and update (dp=1's fused
    engine is held to JAX by tests/test_torch_rl.py)."""
    got, dp1 = runs["sharded"][(dp, 0)]["fused"], runs["dp1"]["fused"]
    for k in ("actions", "rewards", "rms", "metrics"):
        np.testing.assert_allclose(_np(got[k]), _np(dp1[k]), err_msg=k,
                                   **TOL)
    assert len(got["episodes"]) == len(dp1["episodes"]) == 8
    np.testing.assert_allclose(_np(got["episodes"]), _np(dp1["episodes"]),
                               **TOL)
    cfg = ranks.knobs("arms")
    bound = 2 * cfg.RLLr * cfg.ppoEpoch * cfg.ppoNumMiniBatch + 5e-5
    _assert_params(got["params"], dp1["params"], bound, "dp1")


@pytest.mark.parametrize("dp", [4, 2])
def test_every_rank_holds_rank_0s_parameters_bit_for_bit(runs, dp):
    lead = runs["sharded"][(dp, 0)]
    for r in range(1, 4):
        other = runs["sharded"][(dp, r)]
        for check, out in lead.items():
            for k, v in out["params"].items():
                assert torch.equal(other[check]["params"][k], v), (check, k)
            if "metrics" in out:
                assert torch.equal(other[check]["metrics"], out["metrics"])


def test_pretext_entry_point_under_a_launcher_matches_dp1(runs):
    """The pretext entry point joined the 4-rank group as a torchrun
    launch's ranks do: rank 0 collected (the same shards as dp=1's), every
    rank trained its block of each batch, rank 0 alone wrote the files."""
    w = runs["work"]
    out = {}
    for tag in ("dp1", "dp4"):
        root = os.path.join(w, f"entry_{tag}")
        with open(os.path.join(root, "model", "progress.csv")) as f:
            out[tag] = (f.read().splitlines(), load_checkpoint(
                os.path.join(root, "model", "0"))["params"])
        assert os.path.exists(os.path.join(root, "model", "config.json"))
    (rows1, p1), (rows4, p4) = out["dp1"], out["dp4"]
    assert rows1[0] == rows4[0] == "avg_loss" and len(rows4) == 2
    np.testing.assert_allclose(float(rows4[1]), float(rows1[1]), **TOL)
    steps = -(-24 // 8)
    _assert_params(p4, p1, 2 * 1e-4 * steps + 5e-5, "entry point")


def test_rl_entry_point_under_a_launcher_matches_dp1(runs):
    """The RL entry point at dp=4 in the group: the device-sim run writes
    dp=1's progress.csv (eprewmean over every rank's episodes) and
    checkpoint, from rank 0."""
    rows, params = {}, {}
    for tag in ("dp1", "dp4"):
        root = os.path.join(runs["work"], f"rl_{tag}")
        with open(os.path.join(root, "progress.csv")) as f:
            rows[tag] = [r.split(",") for r in f.read().splitlines()]
        params[tag] = load_checkpoint(os.path.join(root, "00000"))["params"]
    header = rows["dp1"][0]
    assert rows["dp4"][0] == header and len(rows["dp4"]) == 2
    for name in ("misc/nupdates", "misc/total_timesteps", "eprewmean", "min",
                 "max", "loss/policy_entropy", "loss/policy_loss",
                 "loss/value_loss", "lr"):
        i = header.index(name)
        np.testing.assert_allclose(float(rows["dp4"][1][i]),
                                   float(rows["dp1"][1][i]), err_msg=name,
                                   **TOL)
    lr = ranks.knobs("arms").RLLr
    _assert_params(params["dp4"], params["dp1"], 2 * lr * 2 + 5e-5,
                   "rl entry point")


def test_a_rank_that_dies_makes_the_launch_raise(tmp_path):
    """A rank that raises while the other waits in a collective: the other
    raises too (gloo sees its peer close or reset the connection), launch
    raises the first error it joins, whichever rank's that is, and no rank
    is left running."""
    import multiprocessing
    import time

    t0 = time.time()
    with pytest.raises(Exception, match="rank 1 fails|by peer"):
        tmesh.launch(ranks.die_on_rank_1, (), 2, device="cpu",
                     backend="gloo", threads=1,
                     init_method="file://" + str(tmp_path / "store"))
    assert time.time() - t0 < 120
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("entry", ["pretext", "rl"])
def test_entry_points_start_n_ranks(entry, monkeypatch, tmp_path):
    """With meshShape={'dp': 2} and no launcher, each entry point starts 2
    ranks through parallel/mesh.py::launch (its spawn runs in the fixture
    above), CPU ranks sharing the host's cores; without meshShape it runs
    in this process."""
    import var_tpu_torch.parallel.mesh as pmesh
    from var_tpu_torch import pretext as tpre
    from var_tpu_torch import rl as trl_entry

    calls = []
    monkeypatch.setattr(pmesh, "launch",
                        lambda fn, args, n, **kw: calls.append((fn, n, kw)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = ["--env", "arms", "--device", "cpu", "--set",
            "meshShape={'dp': 2}"]
    if entry == "pretext":
        tpre.main(args + ["pretextCollection=False"])
        fn = tpre._rank
    else:
        trl_entry.main(args + ["RLTrain=True"])
        fn = trl_entry._rank
    (got, n, kw), = calls
    assert got is fn and n == 2 and kw["device"] == "cpu"
    assert kw["threads"] == max(1, (os.cpu_count() or 1) // 2)
