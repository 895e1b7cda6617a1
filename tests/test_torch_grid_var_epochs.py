"""Fault F1, step A2: the grid VAR trained over epochs, the port against
the JAX package on the CPU, where tests/test_torch_ai2thor.py holds one
step only.

Both packages' pretext trainers take the same grid triplets (one
collection, read by each package's own load_env_data; the epoch orders
and clip draws come from each dataset's seeded numpy RNG and are held
equal) and the same initial weights (JAX's, converted): the CRNN at sound
1x600x40, quotas [2, 2, 4, 4, 8], batch 4, 3 epochs with
pretextLRDecayEpoch [1, 2], so that the step decay acts inside them. The
port runs audioBackend='pallas' (on the CPU the kernel's plain version),
JAX its default 'fft'. The two packages' initial draws differ (a
torch.Generator against a PRNG key); a last test holds them to one
distribution, tensor by tensor.

Tolerances, each with its reason:
- the loss at every step at the CRNN's rtol 1e-3 / atol 2e-4
  (BASELINE.md:29-59: its 11x11 convolutions and 73-step BiGRU sum in
  another order on each side);
- the LR of every step equal in float32 (both are the base LR times gamma
  to the number of milestones passed);
- the parameters after each epoch within 2 x the LR summed over the steps
  so far + 5e-5 (Adam moves a weight by about lr whatever its gradient, so
  a near-zero gradient that rounds to the other sign differs by 2 lr a
  step), the median difference below 1e-6.

The same 3 epochs at computeDtype='bfloat16' (the conv stacks and heads
in bf16 on both sides, tests/test_torch_bf16.py) are held at that file's
bounds in units of bf16's EPS = 2^-8: each step's loss within 2 EPS, the
parameters within the same Adam bound with the median difference at most
lr/10 a step; and each step taken by the port from JAX's state before it
(teacher-forced) at the same bounds. Fault F5's yardsticks beside them: 8
twins of JAX's bf16 run that differ only in the order of each step's
batch rows (how far the reference parts from itself), and each step's
parameter update per element against JAX's. These cases carry `slow`:
they train both packages again.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import audio_store as jstore
from var_tpu.data import triplets as jtriplets
from var_tpu.ops.audio import sound_features as jsound_features
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.models.encoders import build_pretext_model
from var_tpu_torch.tools.rl_check import bf16_partial_sums
from var_tpu_torch.train import pretext as tpretext

CRNN_TOL = dict(rtol=1e-3, atol=2e-4)
QUOTA = [2, 2, 4, 4, 8]
VAR_BATCH, VAR_EPOCHS, VAR_DECAY = 4, 3, [1, 2]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two torch threads per test worker, the module's fixtures
    included: the machine is shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(**extra):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.main_config(env="ai2thor")
        cfg.override(vecEnvBackend="dummy", **extra)
        mod.gym_register(cfg, env="ai2thor")
        out.append(cfg)
    return out


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


EPS = 2.0 ** -8  # bf16's unit roundoff (tests/test_torch_bf16.py)


@pytest.fixture(scope="module")
def var_runs(tmp_path_factory):
    """One grid collection, then both trainers over VAR_EPOCHS epochs from
    JAX's initial weights. Returns what each recorded per epoch."""
    return _var_runs(tmp_path_factory.mktemp("grid_var"))


@pytest.fixture(scope="module")
def var_runs_bf16(tmp_path_factory):
    """var_runs at computeDtype='bfloat16' on both sides, with JAX's state
    and each package's batch recorded before every step."""
    return _var_runs(tmp_path_factory.mktemp("grid_var_bf16"),
                     teacher=True, computeDtype="bfloat16")


def _var_runs(work, teacher=False, **dtype):
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        knobs = dict(
            pretextDataDir=[str(work / "triplets")],
            pretextModelSaveDir=str(work / "var"),
            pretextCollectNum=QUOTA, pretextDataEpisode=200,
            pretextDataNumFiles=1, pretextNumEnvs=2, pretextEpoch=VAR_EPOCHS,
            pretextLRDecayEpoch=VAR_DECAY, pretextTrainBatchSize=VAR_BATCH,
            pretextModelSaveInterval=100, pretextModelFineTune=False,
            pretextDataset="VARDataset", **dtype)
        jcfg, tcfg = _configs(**knobs)
        tcfg.override(audioBackend="pallas")
        jaudio, taudio = jstore.AudioStore(jcfg), tstore.AudioStore(tcfg)
        jaudio.loadData()
        taudio.loadData()
        collector = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
        collector.collectPretextData()
        jds = jtriplets.load_env_data(jcfg, jaudio)
        tds = ttriplets.load_env_data(tcfg, taudio)
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]

    jtr = jpretext.PretextTrainer(jcfg, audio=jaudio)
    jtr._ensure_audio()
    init = _np_tree(jtr.init_model(seed=0)["params"])
    steps_per_epoch = -(-len(jds) // VAR_BATCH)
    jsched = jpretext.multistep_lr(jcfg.pretextLR, VAR_DECAY,
                                   jcfg.pretextLRDecayGamma, steps_per_epoch)
    jlog = []
    jrun = jtr._run_epoch_indexed

    def jrecord(ds, bank, batch_size, epoch):
        count = int(jtr.state.opt_state[-1].count)
        losses, n = jrun(ds, bank, batch_size, epoch)
        jlog.append(dict(
            losses=[float(v) for v in losses],
            lr=[np.float32(jsched(count + s)) for s in range(len(losses))],
            order=ds.epoch_order(epoch, shuffle=True),
            params=_np_tree(jtr.state.params)))
        return losses, n

    jtr._run_epoch_indexed = jrecord
    jsteps, jbank, jstep = [], [], None
    if teacher:
        jstep = jtr._train_step_indexed

        def jteacher(state, *args):
            # copies: the jitted step donates its state
            jbank[:] = args[:3]
            jsteps.append(dict(params=_np_tree(state.params),
                               adam=_np_tree(state.opt_state[1]),
                               batch=[np.array(a) for a in args[3:]]))
            return jstep(state, *args)

        jtr._train_step_indexed = jteacher
    jtr.trainRepresentation(log_csv=False)

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = build_pretext_model(tcfg)  # at the config's computeDtype
    ttr.model.load_state_dict(ai2thor_state_dict(init))
    tlog = []
    trun, topt = ttr._run_epoch_indexed, ttr._optimize
    lrs = []

    def toptimize(*args):
        lrs.append(np.float32(ttr.lr_fn(ttr.step)))
        return topt(*args)

    def trecord(ds, bank, batch_size, epoch):
        lrs.clear()
        losses, n = trun(ds, bank, batch_size, epoch)
        tlog.append(dict(
            losses=list(losses), lr=list(lrs),
            order=ds.epoch_order(epoch, shuffle=True),
            params={k: v.clone() for k, v in ttr.model.state_dict().items()}))
        return losses, n

    ttr._optimize = toptimize
    ttr._run_epoch_indexed = trecord
    tsteps = []
    if teacher:
        tstep = ttr._train_step_indexed

        def tteacher(bank, *args):
            named = dict(ttr.model.named_parameters())
            tsteps.append(dict(
                bank=bank, batch=args,
                params={k: v.detach().clone() for k, v in named.items()},
                adam={k: {n: t.clone() for n, t in
                          ttr.optimizer.state[p].items()}
                      for k, p in named.items() if p in ttr.optimizer.state}))
            return tstep(bank, *args)

        ttr._train_step_indexed = tteacher
    ttr.trainRepresentation(log_csv=False)
    if teacher:
        del ttr._train_step_indexed
    return dict(jds=jds, tds=tds, jlog=jlog, tlog=tlog, init=init,
                jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr, jsteps=jsteps,
                tsteps=tsteps, jstep=jstep, jbank=jbank)


def test_var_datasets_and_epoch_draws_are_equal(var_runs):
    jds, tds = var_runs["jds"], var_runs["tds"]
    assert len(jds) == len(tds) == sum(QUOTA)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.gts, jds.gts)
    for j, t in zip(var_runs["jlog"], var_runs["tlog"]):
        np.testing.assert_array_equal(t["order"], j["order"])


def test_var_losses_and_lr_match_jax_every_step(var_runs):
    jlog, tlog = var_runs["jlog"], var_runs["tlog"]
    assert len(jlog) == len(tlog) == VAR_EPOCHS
    for ep, (j, t) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(t["losses"], j["losses"],
                                   err_msg=f"epoch {ep}", **CRNN_TOL)
        np.testing.assert_array_equal(t["lr"], j["lr"], err_msg=f"epoch {ep}")
    # the decay acted inside the run: 1e-4, then 2e-5, then 4e-6
    assert [t["lr"][0] for t in tlog] == [np.float32(1e-4),
                                          np.float32(2e-5),
                                          np.float32(1e-4 * 0.2 * 0.2)]


def test_var_parameters_match_jax_after_each_epoch(var_runs):
    jlog, tlog = var_runs["jlog"], var_runs["tlog"]
    moved = 0.0
    for ep, (j, t) in enumerate(zip(jlog, tlog)):
        moved += 2 * float(np.sum(t["lr"]))
        want = ai2thor_state_dict(j["params"])
        diffs = []
        for k, v in want.items():
            d = (t["params"][k] - v).abs()
            assert d.max().item() <= moved + 5e-5, (ep, k, d.max().item())
            diffs.append(d.ravel())
        med = torch.cat(diffs).median().item()
        print(f"epoch {ep}: params max {max(x.max().item() for x in diffs):.3e}"
              f" median {med:.3e} bound {moved + 5e-5:.3e}")
        assert med < 1e-6, (ep, med)


@pytest.mark.slow
@pytest.mark.parametrize("what", ["losses", "parameters"])
def test_var_at_bf16_matches_jax_every_epoch(var_runs_bf16, var_runs, what,
                                            request):
    """A2's 3 epochs at computeDtype='bfloat16': every step's loss within 2
    EPS of JAX's and the LR equal; the parameters after each epoch within
    the Adam bound, the median at most lr/10 a step. Beside the port's
    loss gaps it prints JAX's own bf16-against-float32 gaps and the JAX
    twins' largest gap at each step."""
    jlog, tlog = var_runs_bf16["jlog"], var_runs_bf16["tlog"]
    assert len(jlog) == len(tlog) == VAR_EPOCHS
    if what == "losses":
        gaps = [np.abs(np.subtract(t["losses"], j["losses"])) / EPS
                for j, t in zip(jlog, tlog)]
        for ep, (g, j, t, f) in enumerate(zip(gaps, jlog, tlog,
                                              var_runs["jlog"])):
            own = np.abs(np.subtract(j["losses"], f["losses"])) / EPS
            print(f"epoch {ep}: loss gaps in EPS {np.round(g, 3).tolist()}; "
                  f"JAX bf16 against JAX float32 "
                  f"{np.round(own, 3).tolist()}")
            np.testing.assert_array_equal(t["lr"], j["lr"])
        twins = request.getfixturevalue("bf16_twins")["jax"]
        print("the 8 JAX twins' largest gap to JAX at each step, in EPS:",
              np.round(twins.max(axis=0), 3).tolist())
        assert max(g.max() for g in gaps) <= 2
        return
    moved = median = 0.0
    for ep, (j, t) in enumerate(zip(jlog, tlog)):
        moved += 2 * float(np.sum(t["lr"]))
        median += float(np.sum(t["lr"])) / 10
        want = ai2thor_state_dict(j["params"])
        diffs = torch.cat([(t["params"][k] - v).abs().ravel()
                           for k, v in want.items()])
        print(f"epoch {ep}: params max {diffs.max().item():.3e} (bound "
              f"{moved + 5e-5:.3e}), median {diffs.median().item():.3e} "
              f"(bound {median:.3e})")
        assert diffs.max().item() <= moved + 5e-5, ep
        assert diffs.median().item() <= median, ep


def _port_step(run, step, params, adam):
    """The port's bf16 step `step` on its own batch of that step (whose
    indices equal JAX's), from the given parameters and Adam state (both
    keyed by the port's parameter names). Returns (loss, state_dict
    after the step)."""
    ttr = run["ttr"]
    ttr.model.load_state_dict(params)
    ttr.optimizer.state.clear()
    for name, p in ttr.model.named_parameters():
        if name in adam:
            ttr.optimizer.state[p] = {k: v.clone()
                                      for k, v in adam[name].items()}
    ttr.step = step
    t = run["tsteps"][step]
    loss = ttr._train_step_indexed(t["bank"], *t["batch"])
    return float(loss), {k: v.clone() for k, v in
                         ttr.model.state_dict().items()}


def _jax_state(run, source):
    """JAX's parameters and optax Adam state before step `source`, in the
    port's names and layouts."""
    rec = run["jsteps"][source]
    adam = rec["adam"]
    mu, nu = ai2thor_state_dict(adam.mu), ai2thor_state_dict(adam.nu)
    count = torch.tensor(float(adam.count))
    return ai2thor_state_dict(rec["params"]), {
        k: {"step": count, "exp_avg": mu[k], "exp_avg_sq": nu[k]}
        for k in mu}


TWINS = range(1, 9)
PARTED = (9, 13)  # the steps at which the port's loss parts from JAX's


def _twin_orders(k, n):
    """Twin k's row order at each of n steps: permutations of the batch
    drawn from numpy.random.default_rng(k), the identity redrawn."""
    rng, out = np.random.default_rng(k), []
    while len(out) < n:
        order = rng.permutation(VAR_BATCH)
        if (order != np.arange(VAR_BATCH)).any():
            out.append(order)
    return out


def _update_gaps(after, start, want_after, want_start):
    """Per parameter (dicts in the port's names): the sum over its
    elements of |(after - start) - (want_after - want_start)|, the
    difference between two steps' parameter updates (in float64, so each
    update is exact), and its element count."""
    out = {}
    for k, w in want_after.items():
        d = ((np.asarray(after[k], np.float64)
              - np.asarray(start[k], np.float64))
             - (np.asarray(w, np.float64)
                - np.asarray(want_start[k], np.float64)))
        out[k] = (float(np.abs(d).sum()), d.size)
    return out


def _mean_gap(per, lr, keep=lambda name: True):
    """F5's per-element statistic U from per-parameter gaps
    (_update_gaps): the mean over the elements of the parameters `keep`
    selects (every one by default), in units of lr."""
    kept = [v for k, v in per.items() if keep(k)]
    return sum(g for g, _ in kept) / sum(n for _, n in kept) / lr


def _spacing_floor(params, lr):
    """One float32 rounding of every parameter, as U: the mean spacing of
    the parameters' float32 values in units of lr."""
    sp = [np.spacing(np.abs(np.asarray(v, np.float32))).ravel()
          for v in params.values()]
    return float(np.concatenate(sp).astype(np.float64).mean()) / lr


def _jax_free_run(run, orders=None, twins=(), at=()):
    """JAX's bf16 run again from its initial weights and a fresh Adam
    state, through its own jitted step on each step's recorded batch, the
    batch's rows (each with all its indices and clip draws) in `orders`
    (None: as recorded). Returns every step's loss and, for each row
    order in `twins` and each step of `at`, the per-parameter gaps
    (_update_gaps, in the port's names) of JAX's step from this run's
    state on the batch in that order against the run's own step (None at
    the other steps)."""
    params = jax.tree_util.tree_map(jnp.asarray, run["init"])
    state = jpretext.TrainState(params, run["jtr"].tx.init(params),
                                jnp.asarray(0, jnp.int32))
    losses = []
    gaps = [[None] * len(run["jsteps"]) for _ in twins]
    for s, rec in enumerate(run["jsteps"]):
        batch = [a if orders is None else a[orders[s]] for a in rec["batch"]]
        stepped = [run["jstep"](jax.tree_util.tree_map(jnp.copy, state),
                                *run["jbank"], *(jnp.asarray(a[o[s]])
                                                 for a in batch))[0].params
                   for o in (twins if s in at else ())]
        state, loss = run["jstep"](state, *run["jbank"],
                                   *(jnp.asarray(a) for a in batch))
        losses.append(float(loss))
        # both steps start from one state: the update gap is |after - after'|
        after = ai2thor_state_dict(_np_tree(state.params))
        for k, p in enumerate(stepped):
            gaps[k][s] = _update_gaps(ai2thor_state_dict(_np_tree(p)), after,
                                      after, after)
    return np.array(losses), gaps


def _port_free_run(run, orders=None):
    """_jax_free_run for the port: its bf16 run again from JAX's initial
    weights and a fresh Adam state on its own recorded batches."""
    ttr = run["ttr"]
    ttr.model.load_state_dict(ai2thor_state_dict(run["init"]))
    ttr.optimizer.state.clear()
    losses = []
    for s, rec in enumerate(run["tsteps"]):
        batch = [a if orders is None else a[torch.as_tensor(orders[s])]
                 for a in rec["batch"]]
        ttr.step = s
        losses.append(float(ttr._train_step_indexed(rec["bank"], *batch)))
    return np.array(losses)


@pytest.fixture(scope="module")
def bf16_twins(var_runs_bf16):
    """F5's yardstick, the reference's own bf16 spread: 8 twins of JAX's
    bf16 run that differ from it only in the order of each step's 4
    triplet rows (the triplet loss is a batch mean, so only the order in
    which its terms are summed changes), and the port's 8 twins of its
    own run. In units of EPS, at every step: `port` the port's gap to
    JAX, `jax` each JAX twin's gap to JAX (g_k), `own` each port twin's
    gap to the port; `one_step` each JAX twin's U (_mean_gap) from
    JAX's own state at every step, `one_step_parts` the per-parameter
    gaps it is made of (_update_gaps); the replays of both runs in their
    recorded order."""
    run = var_runs_bf16
    jloss = np.concatenate([j["losses"] for j in run["jlog"]])
    tloss = np.concatenate([t["losses"] for t in run["tlog"]])
    orders = [_twin_orders(k, len(jloss)) for k in TWINS]
    jreplay, parts = _jax_free_run(run, twins=orders, at=range(len(jloss)))
    lrs = np.concatenate([t["lr"] for t in run["tlog"]])
    return dict(
        port=np.abs(tloss - jloss) / EPS,
        jax=np.abs([_jax_free_run(run, o)[0] - jloss for o in orders]) / EPS,
        own=np.abs([_port_free_run(run, o) - tloss for o in orders]) / EPS,
        one_step=np.array([[_mean_gap(per, lr) for per, lr in zip(k, lrs)]
                           for k in parts]),
        one_step_parts=parts,
        replays=(jloss, jreplay, tloss, _port_free_run(run)))


@pytest.mark.slow
def test_var_at_bf16_twins_of_the_reference(bf16_twins):
    """The twins' harness: each run replayed in its recorded order gives
    its free-running losses exactly, and the permutation moves JAX's
    losses by more than 0.5 EPS at some step (else it is too weak a
    perturbation to measure the spread by). Prints every twin's gap
    beside the port's."""
    jloss, jreplay, tloss, treplay = bf16_twins["replays"]
    np.testing.assert_array_equal(jreplay, jloss)
    np.testing.assert_array_equal(treplay, tloss)
    for s, p in enumerate(bf16_twins["port"]):
        print(f"step {s:2d}: port {p:.3f} EPS; JAX twins "
              f"{np.round(bf16_twins['jax'][:, s], 3).tolist()}; port twins "
              f"{np.round(bf16_twins['own'][:, s], 3).tolist()}")
    assert bf16_twins["jax"].max() > 0.5


@pytest.mark.slow
def test_var_at_bf16_teacher_forced(var_runs_bf16, bf16_twins):
    """F5's discriminator: at every one of the 15 steps the port's bf16
    step starts from JAX's parameters and optax Adam state before that
    step, on the same batch. Its loss must lie within 2 EPS of JAX's (the
    one-step bound of tests/test_torch_bf16.py) and its parameters after
    the step within the one-step Adam bound of JAX's (2 lr + 5e-5, the
    median at most lr/10). The replay from the port's own state before
    each step must give its free-running loss exactly.

    What the loss comparison can see, as controls:
    - JAX's state before step s-1 in place of s must fail the loss bound
      at every step that follows a step at the base LR (1e-4). After the
      decay (2e-5, then 4e-6) one Adam step moves the loss by less than
      2 EPS, so there it is only printed.
    - The port's VAR convs summing their partial sums in bf16
      (rl_check.bf16_partial_sums), from JAX's state: printed. It moves a
      step's loss by less than 2 EPS, so the bound cannot tell such a
      one-step fault from the port's arithmetic.

    Per element, the update gap U (_mean_gap: the mean of |update -
    JAX's update| in units of the step's LR) against its threshold, the
    larger of the 8 JAX twins' U from JAX's own state (bf16_twins, at
    PARTED only) and one float32 spacing of the parameters: both controls
    must exceed it at PARTED, where the free-running losses part. The
    port's U is printed with the three parameters that carry most of
    it."""
    run = var_runs_bf16
    jsteps, tsteps = run["jsteps"], run["tsteps"]
    jloss = np.concatenate([j["losses"] for j in run["jlog"]])
    tfree = np.concatenate([t["losses"] for t in run["tlog"]])
    lrs = np.concatenate([t["lr"] for t in run["tlog"]])
    n = len(jloss)
    assert len(jsteps) == len(tsteps) == n == VAR_EPOCHS * 5
    after = _teacher_after(run)
    free = np.abs(tfree - jloss) / EPS
    forced, behind, planted = np.zeros(n), np.full(n, np.nan), np.zeros(n)
    gap = {k: np.full(n, np.nan) for k in ("port", "behind", "planted")}
    floor, tops = np.zeros(n), []
    for s in range(n):
        for a, b in zip(jsteps[s]["batch"], tsteps[s]["batch"]):
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"step {s}")
        start = _jax_state(run, s)
        loss, params = _port_step(run, s, *start)
        forced[s] = abs(loss - jloss[s]) / EPS
        want = ai2thor_state_dict(after[s])
        lr = float(lrs[s])
        per = _update_gaps(params, start[0], want, start[0])
        total = sum(g for g, _ in per.values())
        gap["port"][s] = _mean_gap(per, lr)
        worst = sorted(per, key=lambda k: -per[k][0])[:3]
        tops.append(", ".join(f"{k} {per[k][0] / (total or 1):.0%}"
                              for k in worst))
        floor[s] = _spacing_floor(want, lr)
        diffs = torch.cat([(params[k] - v).abs().ravel()
                           for k, v in want.items()])
        bound, mid = 2 * float(lrs[s]) + 5e-5, float(lrs[s]) / 10
        print(f"step {s:2d}: loss gap {forced[s]:.3f} EPS teacher-forced, "
              f"{free[s]:.3f} free-running; params max "
              f"{diffs.max().item():.3e} (bound {bound:.3e}) median "
              f"{diffs.median().item():.3e} (bound {mid:.3e})")
        assert diffs.max().item() <= bound, s
        assert diffs.median().item() <= mid, s
        if s > 0:
            prev = _jax_state(run, s - 1)
            loss, stepped = _port_step(run, s, *prev)
            behind[s] = abs(loss - jloss[s]) / EPS
            gap["behind"][s] = _mean_gap(_update_gaps(
                stepped, prev[0], want, start[0]), lr)
        with bf16_partial_sums(run["ttr"].model):
            loss, stepped = _port_step(run, s, *start)
        planted[s] = abs(loss - jloss[s]) / EPS
        gap["planted"][s] = _mean_gap(_update_gaps(
            stepped, start[0], want, start[0]), lr)
        loss = _port_step(run, s, tsteps[s]["params"], tsteps[s]["adam"])[0]
        assert loss == tfree[s], (s, loss, tfree[s])
    print("control, JAX's state one step behind, loss gap in EPS:",
          np.round(behind, 3).tolist())
    print("control, bf16 partial sums from JAX's state, loss gap in EPS:",
          np.round(planted, 3).tolist())
    twins = bf16_twins["one_step"].max(axis=0)
    u_bound = np.fmax(twins, floor)
    for s in range(n):
        print(f"step {s:2d}: update gap U in lr: port {gap['port'][s]:.3e}, "
              f"one step behind {gap['behind'][s]:.3e}, bf16 partial sums "
              f"{gap['planted'][s]:.3e}; JAX twins' largest {twins[s]:.3e}, "
              f"float32 spacing {floor[s]:.3e}; the port's largest shares "
              f"{tops[s]}")
    assert forced.max() <= 2, np.round(forced, 3).tolist()
    at_base = np.flatnonzero(lrs[:-1] == lrs[0]) + 1
    assert (behind[at_base] > 2).all(), np.round(behind, 3).tolist()
    # U sees both controls where the loss bound does not
    at = list(PARTED)
    for name in ("behind", "planted"):
        assert (gap[name][at] > u_bound[at]).all(), (name, gap[name])


def _teacher_after(run):
    """JAX's parameters after each of the recorded steps."""
    return ([rec["params"] for rec in run["jsteps"][1:]]
            + [run["jlog"][-1]["params"]])


def _jax_inputs(run, s):
    """Step `s`'s batch as JAX's indexed step feeds its model: the images
    in [0, 1] and both sounds' MFCC (its own gathers and MFCC)."""
    if "jinputs" not in run:
        jtr = run["jtr"]
        cfg = jtr.config

        def inputs(bank_img, bank_wav, bank_len, img_idx, pos_idx, pos_zero,
                   neg_idx, neg_zero):
            feats = [jsound_features(
                jnp.take(bank_wav, i, axis=0), jnp.take(bank_len, i, axis=0),
                cfg.sound_dim[1], jtr._param, backend=cfg.audioBackend,
                zero_mask=z) for i, z in ((pos_idx, pos_zero),
                                           (neg_idx, neg_zero))]
            image = jnp.take(bank_img, img_idx, axis=0)
            if image.dtype == jnp.uint8:  # as its _loss_fn scales them
                image = image.astype(jnp.float32) * (1.0 / 255.0)
            return (image, *feats)

        run["jinputs"] = jax.jit(inputs)
    return run["jinputs"](*run["jbank"], *(jnp.asarray(a) for a in
                                            run["jsteps"][s]["batch"]))


def _jax_embed(run, params, s):
    """JAX's batch embeddings of step `s` at `params`: the image and both
    sounds."""
    if "japply" not in run:
        run["japply"] = jax.jit(run["jtr"].model.apply)
    out = run["japply"]({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, *_jax_inputs(run, s))
    return {k: np.asarray(out[k], np.float32) for k in EMBEDDINGS}


def _port_inputs(run, s):
    """_jax_inputs for the port: its gathers and MFCC."""
    ttr = run["ttr"]
    rec = run["tsteps"][s]
    bank = rec["bank"]
    img_idx, pos_idx, pos_zero, neg_idx, neg_zero = rec["batch"]
    with torch.no_grad():
        image = bank["images"].index_select(0, img_idx)
        if image.dtype == torch.uint8:  # as its _optimize scales them
            image = image.float() * (1.0 / 255.0)
        return (image, ttr._features(bank, pos_idx, pos_zero),
                ttr._features(bank, neg_idx, neg_zero))


def _port_embed(run, params, s):
    """The port's batch embeddings of step `s` at `params` (the port's
    names)."""
    ttr = run["ttr"]
    ttr.model.load_state_dict(params)
    with torch.no_grad():
        out = ttr.model(*_port_inputs(run, s))
    return {k: out[k].float().numpy() for k in EMBEDDINGS}


EMBEDDINGS = ("image_feat", "sound_feat_positive", "sound_feat_negative")
EMBED_EPS = 4  # a component, in EPS (tests/test_torch_bf16.py)


def _embed_gap(got, want):
    """E: the largest per-component gap over the three embeddings, in
    EPS."""
    return max(float(np.abs(got[k] - want[k]).max()) for k in EMBEDDINGS) / EPS


@pytest.mark.slow
def test_var_at_bf16_embeddings_per_element(var_runs_bf16):
    """F5's A1, the forward pass: at every step, the port from JAX's
    parameters before it and JAX embed the step's batch (the image and
    both sounds, each through its own package's gathers and MFCC); E(s)
    is the largest per-component gap, in EPS, against EMBED_EPS. Controls
    that must exceed it at PARTED for E to decide anything: JAX's
    parameters one step behind, and the port's VAR convs summing their
    partial sums in bf16 (rl_check.bf16_partial_sums)."""
    run = var_runs_bf16
    n = len(run["jsteps"])
    port, behind, planted = np.zeros(n), np.full(n, np.nan), np.zeros(n)
    for s in range(n):
        want = _jax_embed(run, run["jsteps"][s]["params"], s)
        start = ai2thor_state_dict(run["jsteps"][s]["params"])
        got = _port_embed(run, start, s)
        port[s] = _embed_gap(got, want)
        if s > 0:
            behind[s] = _embed_gap(_port_embed(
                run, ai2thor_state_dict(run["jsteps"][s - 1]["params"]), s),
                want)
        with bf16_partial_sums(run["ttr"].model):
            planted[s] = _embed_gap(_port_embed(run, start, s), want)
        print(f"step {s:2d}: E in EPS: port {port[s]:.3f} ("
              + ", ".join(f"{k} {np.abs(got[k] - want[k]).max() / EPS:.3f}"
                          for k in EMBEDDINGS)
              + f"), one step behind {behind[s]:.3f}, bf16 partial sums "
              f"{planted[s]:.3f}")
    valid = {k: bool((v[list(PARTED)] > EMBED_EPS).all())
             for k, v in (("behind", behind), ("planted", planted))}
    print("A1: the port's largest E", round(port.max(), 3), "at step",
          int(port.argmax()), "; controls that fail at", PARTED, valid)
    assert port.max() <= EMBED_EPS, np.round(port, 3).tolist()
    # E sees one Adam step at the base LR (1e-4); at 2e-5 and 4e-6, and
    # for the planted partial sums, it need not: then A1 decides nothing
    lrs = np.concatenate([t["lr"] for t in run["tlog"]])
    at_base = np.flatnonzero(lrs[:-1] == lrs[0]) + 1
    assert (behind[at_base] > EMBED_EPS).all(), np.round(behind, 3).tolist()


def _image_and_heads(name):
    """A2's subset: the image branch and the two heads, no sound branch."""
    return name.startswith(("img_branch.", "img_triplet.", "sound_triplet."))


@pytest.mark.slow
def test_var_at_bf16_update_without_the_bigru(var_runs_bf16, bf16_twins):
    """F5's A2: U(s) and its threshold T(s) (the larger of the 8 JAX
    twins' one-step U from JAX's state and one float32 spacing of the
    parameters) over the image branch and the two heads only; the port
    from JAX's state, and the two controls of the teacher-forced test,
    which must exceed T at PARTED."""
    run = var_runs_bf16
    lrs = np.concatenate([t["lr"] for t in run["tlog"]])
    after = _teacher_after(run)
    n = len(lrs)
    u = {k: np.full(n, np.nan) for k in ("port", "behind", "planted")}
    twins, floor, per_layer = np.zeros(n), np.zeros(n), []
    for s in range(n):
        lr = float(lrs[s])
        start = _jax_state(run, s)
        want = ai2thor_state_dict(after[s])
        params = _port_step(run, s, *start)[1]
        per = _update_gaps(params, start[0], want, start[0])
        u["port"][s] = _mean_gap(per, lr, _image_and_heads)
        per_layer.append({k: per[k][0] / per[k][1] / lr for k in per
                          if _image_and_heads(k)})
        if s > 0:
            prev = _jax_state(run, s - 1)
            stepped = _port_step(run, s, *prev)[1]
            u["behind"][s] = _mean_gap(_update_gaps(
                stepped, prev[0], want, start[0]), lr, _image_and_heads)
        with bf16_partial_sums(run["ttr"].model):
            stepped = _port_step(run, s, *start)[1]
        u["planted"][s] = _mean_gap(_update_gaps(
            stepped, start[0], want, start[0]), lr, _image_and_heads)
        twins[s] = max(_mean_gap(k[s], lr, _image_and_heads)
                       for k in bf16_twins["one_step_parts"])
        floor[s] = _spacing_floor({k: v for k, v in want.items()
                                   if _image_and_heads(k)}, lr)
    bound = np.fmax(twins, floor)
    for s in range(n):
        top = sorted(per_layer[s], key=lambda k: -per_layer[s][k])[:3]
        print(f"step {s:2d}: U without the sound branch, in lr: port "
              f"{u['port'][s]:.3e}, one step behind {u['behind'][s]:.3e}, "
              f"bf16 partial sums {u['planted'][s]:.3e}; T {bound[s]:.3e} "
              f"(JAX twins' largest {twins[s]:.3e}, float32 spacing "
              f"{floor[s]:.3e}); the port's largest per-layer U "
              + ", ".join(f"{k} {per_layer[s][k]:.3e}" for k in top))
    fails = np.flatnonzero(u["port"] > bound).tolist()
    print("A2: the port fails T at steps", fails)
    at = list(PARTED)
    for name in ("behind", "planted"):
        assert (u[name][at] > bound[at]).all(), (name, u[name])
    # located: at each failing step, the tensor that carries the port's
    # largest per-element U, each package's gradient against float64
    ratios = []
    for s in fails:
        k = max(per_layer[s], key=per_layer[s].get)
        port, jax_ = _gradient_errors(run, s)[k]
        ratios.append(port / jax_)
        print(f"step {s:2d}: {k} carries the port's largest U "
              f"{per_layer[s][k]:.3e}; relative error from float64: port "
              f"{port:.3e}, JAX {jax_:.3e} ({port / jax_:.2f}x)")
    print("A2 located: port / JAX relative error at the located tensors",
          np.round(ratios, 2).tolist(), "median", np.median(ratios))
    assert max(ratios) <= 2, ratios  # over 2x would be a port fault


def _bf16(x):
    """x rounded to bf16, held in float64."""
    return x.to(torch.bfloat16).double()


def _f64_grads(run, params, inputs):
    """The bf16 training loss's gradient evaluated in float64 at the same
    bf16-rounded inputs: the images, both MFCCs and every parameter the
    bf16 route casts (all but the BiGRU's, which it keeps in float32)
    rounded to bf16, then the VAR's forward and backward in float64 with
    no rounding inside (the CRNN's GRU in float64 too)."""
    from var_tpu_torch.models.encoders import VARPretextNet, conv
    from var_tpu_torch.ops.gru import bigru_final
    from var_tpu_torch.ops.losses import l2_normalize, triplet_margin_loss

    model = VARPretextNet(3, "ai2thor", torch.float64).double()
    model.load_state_dict({k: v.double() if "gru" in k else _bf16(v)
                           for k, v in params.items()})
    sb = model.sound_branch

    def sound(x):
        for layer in sb.convs:
            x = torch.relu(conv(layer, x, torch.float64))
        h = bigru_final(sb._gru("fwd"), sb._gru("bwd"),
                        x.permute(0, 2, 3, 1).flatten(2))
        return l2_normalize(model.sound_triplet(h))

    image, pos, neg = (_bf16(x) for x in inputs)
    loss = triplet_margin_loss(
        l2_normalize(model.img_triplet(model.img_branch(image))), sound(pos),
        sound(neg), run["tcfg"].tripletMargin)
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _gradient_errors(run, s):
    """At step `s`, from JAX's state and batch: each package's bf16
    gradient of every parameter against _f64_grads at its own
    bf16-rounded inputs, as (port, JAX) relative errors |g - g64| /
    |g64| per parameter tensor."""
    if "jgrad" not in run:
        run["jgrad"] = jax.jit(jax.grad(run["jtr"]._loss_fn))
    params = run["jsteps"][s]["params"]
    start = ai2thor_state_dict(params)
    jin = _jax_inputs(run, s)
    jg = ai2thor_state_dict(_np_tree(run["jgrad"](jax.tree_util.tree_map(
        jnp.asarray, params), *jin)))
    tin = _port_inputs(run, s)
    tg = _port_grads(run, start, tin)
    jref = _f64_grads(run, start, [torch.from_numpy(np.asarray(x))
                                   for x in jin])
    tref = _f64_grads(run, start, tin)
    return {k: (float((tg[k] - tref[k]).norm() / tref[k].norm()),
                float((jg[k].double() - jref[k]).norm() / jref[k].norm()))
            for k in tref}


def _port_grads(run, params, inputs):
    """The port's bf16 gradient of the step's loss at `params`."""
    from var_tpu_torch.ops.losses import triplet_margin_loss

    model = run["ttr"].model
    model.load_state_dict(params)
    model.zero_grad(set_to_none=True)
    out = model(*inputs)
    triplet_margin_loss(out["image_feat"], out["sound_feat_positive"],
                        out["sound_feat_negative"],
                        run["tcfg"].tripletMargin).backward()
    return {k: p.grad.double() for k, p in model.named_parameters()}


def _bf16_losses(out_dir):
    """Both packages' bf16 run (var_runs_bf16's, without the recording)
    in this process, every step's loss written to OUT_DIR/losses.json."""
    import json

    run = _var_runs(out_dir, computeDtype="bfloat16")
    out = {k: np.concatenate([e["losses"] for e in run[log]]).tolist()
           for k, log in (("jax", "jlog"), ("port", "tlog"))}
    with open(os.path.join(out_dir, "losses.json"), "w") as f:
        json.dump(out, f)
    return out


@pytest.mark.slow
def test_var_at_bf16_losses_at_xla_default_flags(var_runs_bf16, tmp_path):
    """F5 at XLA's own compile flags. tests/conftest.py compiles JAX at
    --xla_backend_optimization_level=0 with the expensive LLVM passes off;
    at bf16 that changes JAX's arithmetic (which bf16 roundings a fusion
    keeps), and with it JAX's initial draw, which both runs start from.
    In a process of its own, without those flags (as the JAX package runs
    for a user), the same 15 bf16 steps: the port's loss at every step
    within 2 EPS of JAX's, [losses]' bound. Printed beside it: JAX at the
    default flags against JAX at the tests' flags (this process's
    var_runs_bf16), how far the reference parts from itself under its
    compile flags alone."""
    import json
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         env.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, __file__, "bf16-losses", str(tmp_path)],
                   env=env, check=True, timeout=1200)
    with open(tmp_path / "losses.json") as f:
        default = {k: np.array(v) for k, v in json.load(f).items()}
    gap = np.abs(default["port"] - default["jax"]) / EPS
    here = np.concatenate([j["losses"] for j in var_runs_bf16["jlog"]])
    own = np.abs(default["jax"] - here) / EPS
    print("XLA's default flags, port against JAX, loss gap in EPS:",
          np.round(gap, 3).tolist())
    print("JAX at the default flags against JAX at the tests' flags, EPS:",
          np.round(own, 3).tolist())
    assert gap.max() <= 2, np.round(gap, 3).tolist()


def test_initial_draw_matches_jax_in_distribution():
    """The port's VAR draws its initial state from a torch.Generator, JAX
    from its PRNG key, so the two draws differ; each tensor's values must
    still come from the same distribution: a two-sample KS test per
    weight tensor at p >= 1e-3 (as tests/test_torch_draws.py), the
    non-recurrent biases zero on both sides."""
    from scipy import stats

    from var_tpu.models.encoders import (build_pretext_model,
                                         init_pretext_params)
    from var_tpu_torch.models.encoders import build_pretext_model as tbuild

    jcfg, tcfg = _configs()
    jparams = _np_tree(init_pretext_params(build_pretext_model(jcfg), jcfg,
                                           jax.random.PRNGKey(977))["params"])
    want = ai2thor_state_dict(jparams)
    got = tbuild(tcfg).reset_parameters(
        torch.Generator().manual_seed(977)).state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        a, b = w.numpy().ravel(), got[name].numpy().ravel()
        if name.endswith("bias"):
            assert not a.any() and not b.any(), name
            continue
        assert stats.ks_2samp(a, b).pvalue >= 1e-3, name


# -- F5's bf16 run outside pytest ---------------------------------------------------
#
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_grid_var_epochs.py \
#         bf16-losses OUT_DIR
#
# runs both packages' 15 bf16 steps (var_runs_bf16's collection, knobs and
# JAX's initial draw) under whatever XLA_FLAGS the shell gives, and writes
# every step's loss of each package to OUT_DIR/losses.json.

if __name__ == "__main__":
    import argparse
    import pathlib

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="command", required=True)
    sub.add_parser("bf16-losses").add_argument("out_dir")
    a = ap.parse_args()
    torch.set_num_threads(2)  # as the module's fixtures
    pathlib.Path(a.out_dir).mkdir(parents=True, exist_ok=True)
    _bf16_losses(pathlib.Path(a.out_dir))
