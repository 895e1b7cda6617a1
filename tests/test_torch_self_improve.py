"""Self-improvement (var_tpu_torch/train/self_improve.py) against the JAX
package's driver, on the CPU at tiny sizes (4 synthetic clips per class,
a few triplets a class, the arm device sim at N = 2 envs, T = 4 steps,
GRU 32).

- next_selfimprove_index: equal to var_tpu's on the same directories (the
  JAX case is tests/test_drivers.py's test_next_selfimprove_index);
- the collected selfimprove_<i>.pickle shard: byte for byte the JAX
  package's (both collectors draw from numpy RNGs in the same order and
  pickle the same dicts);
- the fine-tune dataset's frozen association: VARFineTuneDataset's clip
  and negative draws are the same in every epoch and equal to JAX's, where
  VARDataset's change from epoch to epoch;
- one round of each mode: the port runs it for real; the JAX driver runs
  with its VAR training, loads and PPO replaced by recorders (its real
  path compiles for minutes on the CPU, tests/test_drivers.py marks it
  slow). Both make the same sequence of calls: the same shard name, the
  same dataset class and fine-tune flag, the same number of VAR epochs,
  the same VAR load target, RL from the newest checkpoint with
  RLModelFineTune and the round's steps. The port's policy labels then
  continue from the base run's.
"""
import os

import numpy as np
import pytest
import torch

import var_tpu.config as jconfig
from var_tpu.data import triplets as jtriplets
from var_tpu.train import pretext as jpretext
from var_tpu.train import rl as jrl
from var_tpu.train import self_improve as jsi
from var_tpu_torch import config as tconfig
from var_tpu_torch.data import triplets as ttriplets
from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.train import pretext as tpretext
from var_tpu_torch.train import rl as trl
from var_tpu_torch.train import self_improve as tsi
from var_tpu_torch.train.checkpoint import latest_checkpoint, save_checkpoint

T, N = 4, 2
SMALL = dict(
    pretextCollectNum=[3, 3, 3, 3, 6], pretextDataEpisode=4,
    pretextDataNumFiles=2, pretextEnvMaxSteps=8, pretextNumEnvs=2,
    pretextTrainBatchSize=8, pretextEpoch=1, pretextModelSaveInterval=1,
    pretextModelFineTune=False, pretextDataset="VARDataset",
    vecEnvBackend="dummy", RLDeviceSimRollout=True, RLNumEnvs=N,
    RLEnvMaxSteps=T, ppoNumSteps=T, RLRecurrentSize=32,
    RLRecurrentInputSize=16, ppoNumMiniBatch=2, ppoEpoch=2,
    RLModelSaveInterval=1, RLTotalSteps=2 * T * N, RLLogInterval=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker, the module's fixtures included:
    the tier-1 run puts several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")


def _configs(root, **extra):
    out = []
    for mod, tag in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.main_config(env="arms")
        cfg.override(
            pretextDataDir=[os.path.join(str(root), tag, "data")],
            pretextModelSaveDir=os.path.join(str(root), tag, "var_model"),
            pretextModelLoadDir=os.path.join(str(root), tag, "var_model",
                                             "0"),
            RLModelSaveDir=os.path.join(str(root), tag, "rl_model"),
            **{**SMALL, **extra})
        mod.gym_register(cfg, env="arms")
        out.append(cfg)
    return out


@pytest.mark.parametrize("existing", [[], [0, 1], [0, 2], [1]])
def test_next_selfimprove_index_matches_jax(tmp_path, existing):
    jcfg, tcfg = _configs(tmp_path)
    for cfg in (jcfg, tcfg):
        train = os.path.join(cfg.pretextDataDir[0], "train")
        os.makedirs(train)
        for i in existing:
            open(os.path.join(train, f"selfimprove_{i}.pickle"), "w").close()
        open(os.path.join(train, "data_0.pickle"), "w").close()
    assert tsi.next_selfimprove_index(tcfg) == jsi.next_selfimprove_index(
        jcfg) == (0 if existing[:1] != [0] else (2 if existing == [0, 1]
                                                 else 1))


def _shard(cfg, name):
    with open(os.path.join(cfg.pretextDataDir[0], "train", name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Both packages' selfimprove_0 collections from one seed."""
    root = tmp_path_factory.mktemp("si_collect")
    os.environ["VAR_TPU_SYNTH_CLIPS"] = "4"
    try:
        jcfg, tcfg = _configs(root)
        jtr = jpretext.PretextTrainer(jcfg)
        jtr.collectPretextData(fileName="selfimprove_0")
        ttr = tpretext.PretextTrainer(tcfg, device="cpu")
        ttr.collectPretextData(fileName="selfimprove_0")
    finally:
        del os.environ["VAR_TPU_SYNTH_CLIPS"]
    return jcfg, tcfg, jtr.audio, ttr.audio


def test_selfimprove_shard_is_byte_identical(shards):
    jcfg, tcfg, _, _ = shards
    names = sorted(os.listdir(os.path.join(tcfg.pretextDataDir[0], "train")))
    assert names == sorted(os.listdir(
        os.path.join(jcfg.pretextDataDir[0], "train")))
    assert any(n.startswith("selfimprove_0") for n in names)
    for name in names:
        assert _shard(tcfg, name) == _shard(jcfg, name), name


@pytest.mark.parametrize("dataset,frozen", [("VARFineTuneDataset", True),
                                            ("VARDataset", False)])
def test_finetune_dataset_keeps_its_association(shards, dataset, frozen):
    jcfg, tcfg, jaudio, taudio = shards
    jcfg.override(pretextDataset=dataset)
    tcfg.override(pretextDataset=dataset)
    tds = ttriplets.load_env_data(tcfg, taudio)
    jds = jtriplets.load_env_data(jcfg, jaudio)
    assert type(tds) is ttriplets.DATASET_REGISTRY[dataset]
    assert tds.resample_each_epoch is not frozen
    ranges = taudio.build_clip_bank()[2]
    draws = [tds.epoch_clip_ids(ranges, e) for e in range(3)]
    for e, draw in enumerate(draws):
        for a, b in zip(jds.epoch_clip_ids(ranges, e), draw):
            np.testing.assert_array_equal(a, b)
    same = all(np.array_equal(a, b) for d in draws[1:]
               for a, b in zip(draws[0], d))
    assert same is frozen


class _Recorder:
    """Records the config each of the driver's VAR trainings, VAR loads and
    PPO runs saw; `real` runs them too (calls they make inside are not
    recorded), else they are replaced."""

    def __init__(self, monkeypatch, trainer_mod, rl_mod, real=False):
        self.calls = []
        depth = [0]

        class calls:
            @staticmethod
            def append(record):
                if depth[0] == 0:
                    self.calls.append(record)

        def run(orig, *args):
            depth[0] += 1
            try:
                return orig(*args)
            finally:
                depth[0] -= 1

        def on_train(orig):
            def train(self, epoch=None, lr=None, start_ep=0, dataset=None,
                      log_csv=True):
                cfg = self.config
                calls.append(("var", epoch, type(dataset).__name__,
                              cfg.pretextDataset,
                              bool(cfg.pretextModelFineTune)))
                if real:
                    return run(lambda: orig(self, epoch=epoch,
                                            dataset=dataset))
            return train

        def on_load(orig):
            def load(self, path=None):
                calls.append(("var_load", os.path.basename(
                    path or self.config.pretextModelLoadDir)))
                if real:
                    return run(orig, self, path)
            return load

        def on_rl(orig):
            def train_rl(self, total_steps=None, log_interval=None):
                cfg = self.config
                calls.append(("rl", os.path.basename(cfg.RLModelLoadDir),
                              bool(cfg.RLModelFineTune), total_steps,
                              os.path.basename(cfg.pretextModelLoadDir)))
                if real:
                    return run(orig, self, total_steps, log_interval)
            return train_rl

        def on_rl_load(orig):
            def load(self, path=None):
                calls.append(("rl_var", os.path.basename(
                    path or self.config.pretextModelLoadDir)))
                if real:
                    return run(orig, self, path)
            return load

        P, R = trainer_mod.PretextTrainer, rl_mod.RLTrainer
        for cls, name, wrap in ((P, "trainRepresentation", on_train),
                                (P, "loadPretextModel", on_load),
                                (R, "trainRL", on_rl),
                                (R, "load_pretext", on_rl_load)):
            monkeypatch.setattr(cls, name, wrap(getattr(cls, name)))


def _base_run(tcfg):
    """The port's base: a VAR at pretextModelLoadDir and 2 PPO updates."""
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(tcfg.pretextModelLoadDir,
                    {"params": model.state_dict(), "step": 0})
    rl = trl.RLTrainer(tcfg, env="arms", device="cpu")
    rl.load_pretext()
    rl.trainRL()
    return sorted(p for p in os.listdir(tcfg.RLModelSaveDir) if p.isdigit())


@pytest.mark.parametrize("mode", ["finetune", "scratch"])
def test_one_round_matches_the_jax_driver(tmp_path, monkeypatch, mode):
    jcfg, tcfg = _configs(tmp_path)
    assert _base_run(tcfg) == ["00000", "00001"]
    # the JAX driver's base checkpoint directories (their contents are
    # never read: the recorder stands in for every load)
    for label in ("00000", "00001"):
        os.makedirs(os.path.join(jcfg.RLModelSaveDir, label))
    os.makedirs(jcfg.pretextModelLoadDir)

    jrec = _Recorder(monkeypatch, jpretext, jrl)
    jsi.self_improve(jcfg, rounds=1, env="arms", pretext_epochs=2,
                     rl_steps=T * N, var_mode=mode)
    trec = _Recorder(monkeypatch, tpretext, trl, real=True)
    tsi.self_improve(tcfg, rounds=1, env="arms", pretext_epochs=2,
                     rl_steps=T * N, var_mode=mode, device="cpu")

    assert trec.calls == jrec.calls
    dataset = {"finetune": "FineTune", "scratch": ""}[mode]
    var = [c for c in trec.calls if c[0] == "var"]
    assert var == [("var", 2, f"Triplet{dataset}Dataset",
                    f"VAR{dataset}Dataset", mode == "finetune")]
    assert ("rl", "00001", True, T * N, "1") in trec.calls
    assert tcfg.pretextModelLoadDir == os.path.join(
        tcfg.pretextModelSaveDir, "1")
    train = os.path.join(tcfg.pretextDataDir[0], "train")
    assert os.path.exists(os.path.join(train, "selfimprove_0.pickle"))
    assert _shard(tcfg, "selfimprove_0.pickle") == _shard(
        jcfg, "selfimprove_0.pickle")
    # the round's one update continues the labels
    assert latest_checkpoint(tcfg.RLModelSaveDir).endswith("00002")
    assert tsi.next_selfimprove_index(tcfg) == 1
    with pytest.raises(ValueError, match="finetune|scratch"):
        tsi.self_improve(tcfg, var_mode="both", device="cpu")


def test_self_improve_demo_rehearses_on_the_cpu(tmp_path):
    """tools/self_improve_demo.py's stages at tiny sizes: a weak run, its
    device eval, one scratch round and its eval, in two calls (the second
    keeps the first's weak baseline in the JSON)."""
    from var_tpu_torch.tools import self_improve_demo

    out = tmp_path / "si.json"
    argv = [str(tmp_path / "work"), "--device", "cpu", "--weak-per-class",
            "4", "--weak-var-epochs", "1", "--weak-rl-steps", str(2 * T * N),
            "--improve-per-class", "4", "--ft-var-epochs", "1",
            "--ft-rl-steps", str(T * N), "--num-envs", str(N),
            "--eval-per-class", "2", "--eval-envs", str(N), "--no-probe",
            "--out", str(out), "--set", f"RLEnvMaxSteps={T}",
            "RLRecurrentSize=32", "RLRecurrentInputSize=16",
            "pretextEnvMaxSteps=8"]
    weak = self_improve_demo.main(argv + ["--stages", "weak,weak_eval"])
    assert weak["weak"]["eval_episodes"] == 8 and not weak["rounds"]
    assert weak["weak"]["checkpoint"].endswith("00001")
    full = self_improve_demo.main(argv + ["--stages", "improve,final_eval"])
    assert full["weak"]["success_rate"] == weak["weak"]["success_rate"]
    (rnd,) = full["rounds"]
    assert rnd["round"] == 1 and rnd["var_mode"] == "scratch"
    assert rnd["checkpoint"].endswith("00002") and 0 <= rnd["success_rate"] <= 1
    assert len(rnd["per_class"]) == 4 and rnd["eval_episodes"] == 8
