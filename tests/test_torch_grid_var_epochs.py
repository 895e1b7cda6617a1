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
from var_tpu.train import pretext as jpretext
from var_tpu_torch import config as tconfig
from var_tpu_torch.convert import ai2thor_state_dict
from var_tpu_torch.data import audio_store as tstore
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.models.encoders import VARPretextNet
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


@pytest.fixture(scope="module")
def var_runs(tmp_path_factory):
    """One grid collection, then both trainers over VAR_EPOCHS epochs from
    JAX's initial weights. Returns what each recorded per epoch."""
    work = tmp_path_factory.mktemp("grid_var")
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "3"
    try:
        knobs = dict(
            pretextDataDir=[str(work / "triplets")],
            pretextModelSaveDir=str(work / "var"),
            pretextCollectNum=QUOTA, pretextDataEpisode=200,
            pretextDataNumFiles=1, pretextNumEnvs=2, pretextEpoch=VAR_EPOCHS,
            pretextLRDecayEpoch=VAR_DECAY, pretextTrainBatchSize=VAR_BATCH,
            pretextModelSaveInterval=100, pretextModelFineTune=False,
            pretextDataset="VARDataset")
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
    jtr.trainRepresentation(log_csv=False)

    ttr = tpretext.PretextTrainer(tcfg, device="cpu", audio=taudio)
    ttr._ensure_audio()
    ttr.model = VARPretextNet(3, "ai2thor")
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
    ttr.trainRepresentation(log_csv=False)
    return dict(jds=jds, tds=tds, jlog=jlog, tlog=tlog, init=init,
                jcfg=jcfg, tcfg=tcfg, jtr=jtr, ttr=ttr)


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
