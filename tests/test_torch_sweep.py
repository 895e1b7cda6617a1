"""The checkpoint sweep (var_tpu_torch/tools/success_curve.py) and
e2e_run --select-best-per-class, on the CPU at tiny width.

list_checkpoints and select_best are held against scripts/success_curve.py
on the same directories and rows, exactly (both are pure host logic). The
curve itself runs on a tiny arm device-sim run (N = 2 envs, T = 4 steps,
GRU 32, a random VAR): its CSV has the columns of
artifacts/arm_success_curve_12M_r5.csv, one row per checkpoint in label
order, the env steps of each label, per-class rates that are whole counts
of episodes, and the overall rate their mean; the sweep's own seeded
stream makes a second sweep give the same rows.
"""
import csv
import json
import os
import sys

import pytest
import torch

from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.tools import e2e_run
from var_tpu_torch.tools import success_curve as tcurve
from var_tpu_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N = 4, 2


@pytest.fixture(scope="module")
def jcurve():
    os.environ.setdefault("VAR_TPU_JIT_CACHE", "0")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import success_curve

    return success_curve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker, the module's fixtures included:
    the tier-1 run puts several workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_cpu(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")


def test_list_checkpoints_matches_jax(tmp_path, jcurve):
    for name in ["999", "01000", "00200", "0", "00050"]:
        (tmp_path / name).mkdir()
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "test_00200.csv").write_text("")
    (tmp_path / "best").symlink_to("00200")
    (tmp_path / "12").write_text("")  # a file, not a checkpoint
    got = tcurve.list_checkpoints(str(tmp_path))
    assert got == jcurve.list_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in got] == [
        "0", "00050", "00200", "999", "01000"]


ROWS = [
    [(100, 0.84), (300, 0.78), (200, 0.84)],
    [(0, 0.0)],
    [(50, 0.9), (100, 0.95), (150, 0.95), (200, 0.95), (250, 0.1)],
    [(400, 0.5), (50, 0.7), (90, 0.69999)],
]


@pytest.mark.parametrize("pairs", ROWS)
def test_select_best_matches_jax(pairs, jcurve):
    rows = [{"checkpoint": "%.5i" % u, "update": u, "success_rate": r}
            for u, r in pairs]
    assert tcurve.select_best(rows) is jcurve.select_best(rows)
    with pytest.raises(ValueError):
        tcurve.select_best([])


def _train(work, updates=3):
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(str(work / "var_model" / "0"),
                    {"params": model.state_dict(), "step": 0})
    return e2e_run.main([
        str(work), "--device", "cpu", "--device-sim", "--num-envs", str(N),
        "--rl-steps", str(updates * T * N), "--var-epochs", "1",
        "--stages", "rl", "--out", str(work / "e2e.json"),
        "--select-best-per-class", "4", "--device-eval-envs", "2",
        "--set", f"RLEnvMaxSteps={T}", "RLRecurrentSize=32",
        "RLRecurrentInputSize=16", "ppoNumMiniBatch=2", "ppoEpoch=2",
        "RLModelSaveInterval=1"])


def test_curve_and_selection_on_a_tiny_run(tmp_path):
    work = tmp_path / "run"
    result = _train(work)
    rl_dir = work / "rl_model"
    with open(os.path.join(REPO, "artifacts",
                           "arm_success_curve_12M_r5.csv")) as f:
        columns = next(csv.reader(f))
    with open(rl_dir / "success_curve.csv") as f:
        reader = csv.DictReader(f)
        assert reader.fieldnames == columns
        rows = list(reader)
    assert [r["checkpoint"] for r in rows] == ["00000", "00001", "00002"]
    assert [int(r["env_steps"]) for r in rows] == [T * N, 2 * T * N,
                                                   3 * T * N]
    for r in rows:
        per_class = [float(r[f"class_{c}"]) for c in range(4)]
        # 4 episodes a class: 2 batches of 2 envs
        assert all(p * 4 == int(p * 4) for p in per_class)
        assert float(r["success_rate"]) == pytest.approx(
            sum(per_class) / 4, abs=1e-4)
        assert 0 <= float(r["ci95"]) < 1

    sel = result["checkpoint_selection"]
    assert sel["episodes_per_point"] == 16
    best = tcurve.select_best(tcurve.read_curve(str(rl_dir /
                                                    "success_curve.csv")))
    assert sel["best_checkpoint"] == str(rl_dir / best["checkpoint"])
    assert os.readlink(rl_dir / "best") == best["checkpoint"]
    with open(rl_dir / "best_checkpoint.json") as f:
        assert json.load(f)["best_success_rate"] == best["success_rate"]

    # a second sweep (every 2nd checkpoint, the final one kept) repeats the
    # rows it shares: the sweep seeds its own stream
    again = tcurve.run_curve("arms", str(work), episodes_per_class=4,
                             envs=2, every=2, out_csv=str(tmp_path / "b.csv"),
                             device="cpu")
    assert [r["checkpoint"] for r in again] == ["00000", "00002"]
    assert again[0] == tcurve.read_curve(str(rl_dir / "success_curve.csv"))[0]

    # --merge: the later file's row wins, rows sorted by update
    merged = tcurve.merge_curves([str(rl_dir / "success_curve.csv"),
                                  str(tmp_path / "b.csv")])
    assert [r["update"] for r in merged] == [0, 1, 2]
    assert merged[2] == again[1]
    out = tmp_path / "merged.csv"
    picked = tcurve.main(["--merge", str(out), str(tmp_path / "b.csv")])
    assert picked == tcurve.select_best(again)
    assert tcurve.read_curve(str(out)) == again
