"""tools/e2e_run.py --leg-steps: a run split into legs against the same run
in one piece, on the CPU at tiny width (arm device sim, N = 2 envs, T = 4
steps, GRU 32, a random VAR).

Two legs of K updates are held against one run of 2K updates:
- the LR at every optimizer step, exactly: both runs compute it on the
  host from Adam's restored count and the same horizon (RLTotalSteps is
  the whole recipe in every leg), so any difference is a fault;
- the checkpoint labels: the unsplit run's labels, plus each leg's last;
- leg 2's first update starts from leg 1's last parameters and Adam state
  (count, mu, nu, update counter), exactly: torch.save round-trips float32
  bit for bit.

The trajectories themselves differ after the split, by design: a leg
re-seeds its generator from RLEnvSeed and starts a fresh return-RMS, as
the JAX package's resume does (neither is in the checkpoint).
"""
import os

import pytest
import torch

from var_tpu_torch.models.encoders import VARPretextNet
from var_tpu_torch.rl import ppo as tppo
from var_tpu_torch.tools import e2e_run
from var_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

T, N, K = 4, 2, 2


@pytest.fixture(autouse=True)
def _small_cpu(monkeypatch):
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def record(monkeypatch):
    """Every optimizer step's (count, LR) and the state entering it."""
    steps = []
    apply_adam = tppo.PPO._apply_adam

    def spy(self, state, grads):
        steps.append({
            "count": state.opt_state.count,
            "lr": self.lr_at(state.opt_state.count),
            "step": state.step,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "mu": {k: v.clone() for k, v in state.opt_state.mu.items()},
            "nu": {k: v.clone() for k, v in state.opt_state.nu.items()}})
        return apply_adam(self, state, grads)

    monkeypatch.setattr(tppo.PPO, "_apply_adam", spy)
    return steps


def _work(root):
    model = VARPretextNet(3).reset_parameters(torch.Generator().manual_seed(0))
    save_checkpoint(str(root / "var_model" / "0"),
                    {"params": model.state_dict(), "step": 0})
    return root


def _run(work, interval, leg_steps=0):
    args = [str(work), "--device", "cpu", "--device-sim", "--num-envs",
            str(N), "--rl-steps", str(2 * K * T * N), "--var-epochs", "1",
            "--stages", "rl", "--out", str(work / "e2e.json"),
            "--set", f"RLEnvMaxSteps={T}", "RLRecurrentSize=32",
            "RLRecurrentInputSize=16", "ppoNumMiniBatch=2", "ppoEpoch=2",
            "RLLrDecay='linear'", "RLLrDecayStart=0.25",
            f"RLModelSaveInterval={interval}"]
    if leg_steps:
        args += ["--leg-steps", str(leg_steps)]
    return e2e_run.main(args)


def _labels(work):
    return sorted(p for p in os.listdir(work / "rl_model") if p.isdigit())


@pytest.mark.parametrize("interval", [1, 2])
def test_two_legs_equal_one_run(tmp_path, record, interval):
    whole = _work(tmp_path / "whole")
    _run(whole, interval)
    whole_steps = list(record)
    record.clear()

    legs = _work(tmp_path / "legs")
    first = _run(legs, interval, leg_steps=K * T * N)
    assert first["leg"] == {"resumed_from": None, "updates_done": K,
                            "updates_total": 2 * K, "done": False}
    assert not os.path.exists(legs / "rl_model" / e2e_run.DONE_MARKER)
    leg1 = list(record)
    record.clear()
    end1 = load_checkpoint(str(legs / "rl_model" / ("%.5i" % (K - 1))))
    second = _run(legs, interval, leg_steps=K * T * N)
    assert second["leg"]["resumed_from"].endswith("%.5i" % (K - 1))
    assert second["leg"]["updates_done"] == 2 * K and second["leg"]["done"]
    assert os.path.exists(legs / "rl_model" / e2e_run.DONE_MARKER)
    leg2 = list(record)

    # the LR at every optimizer step (2 epochs x 2 minibatches an update)
    per_update = 2 * 2
    assert len(whole_steps) == len(leg1) + len(leg2) == 2 * K * per_update
    assert ([(s["count"], s["lr"]) for s in leg1 + leg2]
            == [(s["count"], s["lr"]) for s in whole_steps])
    lrs = [s["lr"] for s in whole_steps]
    assert lrs[0] > lrs[-1]  # the linear decay acts inside the run

    # labels: the unsplit run's, plus leg 1's last
    assert set(_labels(legs)) == set(_labels(whole)) | {"%.5i" % (K - 1)}
    assert _labels(whole)[-1] == _labels(legs)[-1] == "%.5i" % (2 * K - 1)

    # leg 2 starts where leg 1 ended, exactly
    start = leg2[0]
    assert start["count"] == end1["opt_state"]["count"] == K * per_update
    assert start["step"] == end1["step"] == K
    for k, v in end1["params"].items():
        assert torch.equal(start["params"][k], v), k
        assert torch.equal(start["mu"][k], end1["opt_state"]["mu"][k]), k
        assert torch.equal(start["nu"][k], end1["opt_state"]["nu"][k]), k

    # a third leg has nothing left: it trains no update and keeps the marker
    record.clear()
    third = _run(legs, interval, leg_steps=K * T * N)
    assert record == [] and third["leg"]["done"]
    assert _labels(legs)[-1] == "%.5i" % (2 * K - 1)
