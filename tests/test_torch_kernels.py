"""The port's CUDA kernels against their plain versions, and the RL paths
(the fused step, the device sim, the PPO update) against the same on the
CPU, on the card.

This file imports nothing of JAX or var_tpu, so that it also runs on a CUDA
machine without JAX, where tests/conftest.py (which imports jax) is left
out:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda

The `cuda` tests skip where no card is present (the kernel has no CPU
mode). Tolerance rtol = atol = 1e-4: kernel and plain version are both
IEEE float32 and differ only in the order of summation. The RL check's
tolerances are stated in var_tpu_torch/tools/rl_check.py.
"""
import shutil

import numpy as np
import pytest
import torch

from var_tpu_torch.config import main_config
from var_tpu_torch.ops import audio
from var_tpu_torch.ops import mel_log_dct as mld
from var_tpu_torch.tools.rl_check import (card_against_cpu,
                                          device_sim_card_against_cpu,
                                          render_card_against_host)

TOL = dict(rtol=1e-4, atol=1e-4)


def _require_card(reason="the kernel has no CPU mode"):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA card: {reason}")


def _power(preset, B, frames, seed, layout="contiguous"):
    """The gemm STFT's power of seeded noise on the card, with a silent row
    and masked frames, as the view the STFT returns ("stft view") or
    contiguous."""
    params = audio.PARAM_TABLE[preset]
    rng = np.random.RandomState(seed)
    wav = rng.randn(B, frames * params.hop_length + params.n_fft) * 0.2
    wav[-1] = 0.0  # a silent row
    wav = torch.from_numpy(wav.astype(np.float32)).cuda()
    power = audio._stft_power_gemm(wav, params, pre_padded=True)
    power[0, -3:] = 0.0  # masked frames
    return params, wav, power if layout == "stft view" else power.contiguous()


SHAPES = [
    ("GoogleCommand", 128, 100),  # the arm main path
    ("GoogleCommand", 8, 600),    # the ai2thor frame count, a short last unit
    ("FSC", 128, 600),            # the ai2thor path: (128, 601, 257)
    ("FSC", 256, 600),            # its pos + neg batch, were they fused
    ("NSynth", 8, 100),           # n_fft 1024: F = 513
]
LAYOUTS = ["stft view", "contiguous"]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("preset,B,frames", SHAPES)
def test_mel_log_dct_kernel_matches_plain_version(preset, B, frames, layout):
    _require_card()
    params, _, power = _power(preset, B, frames, seed=0, layout=layout)
    assert mld._freq_major(power) == (layout == "stft view")
    before = mld.mel_log_dct.launches
    got = mld.mel_log_dct(power, params)
    torch.cuda.synchronize()
    assert mld.mel_log_dct.launches == before + 1
    torch.testing.assert_close(
        got, mld.mel_log_dct_reference(power, params), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("preset,B,frames", SHAPES)
def test_non_finite_rows_are_nan_as_in_the_plain_version(preset, B, frames,
                                                          layout):
    _require_card()
    params, _, power = _power(preset, B, frames, seed=3, layout=layout)
    F = power.shape[-1]
    power[0, 1, 17] = float("nan")
    power[0, 2, 0] = float("inf")  # bin 0 lies in no band
    power[-1, 3, F - 1] = -float("inf")
    got = mld.mel_log_dct(power, params)
    torch.cuda.synchronize()
    assert got[0, 1:3].isnan().all() and got[-1, 3].isnan().all()
    torch.testing.assert_close(got, mld.mel_log_dct_reference(power, params),
                               equal_nan=True, **TOL)


@pytest.mark.cuda
def test_pallas_backend_launches_the_kernel_and_matches_gemm():
    _require_card()
    params, wav, _ = _power("GoogleCommand", 16, 100, seed=1)
    before = mld.mel_log_dct.launches
    got = audio.mfcc_batch(wav, params, backend="pallas", pre_padded=True)
    torch.cuda.synchronize()
    assert mld.mel_log_dct.launches == before + 1
    torch.testing.assert_close(
        got, audio.mfcc_batch(wav, params, backend="gemm", pre_padded=True),
        **TOL)


@pytest.mark.cuda
def test_rl_step_and_update_agree_on_card_and_cpu(monkeypatch):
    """chip_smoke.py phase 9 at reduced width: GRU 32, 4 envs, 3 steps."""
    _require_card("it holds the card against the CPU")
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    cfg = main_config(env="arms")
    cfg.override(RLNumEnvs=4, ppoNumSteps=3, RLEnvMaxSteps=3,
                 RLRecurrentSize=32, RLRecurrentInputSize=16,
                 RLActionHiddenSize=32, vecEnvBackend="dummy", RLTrain=True)
    report = card_against_cpu(cfg)
    assert report["ok"], report


@pytest.mark.cuda
def test_device_sim_agrees_on_card_and_cpu(monkeypatch):
    """chip_smoke.py phase 13 at reduced width: GRU 32, 4 envs, 6 steps;
    render against the host sim at 200 states."""
    _require_card("it holds the card against the CPU")
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "4")
    cfg = main_config(env="arms")
    cfg.override(RLNumEnvs=4, ppoNumSteps=6, RLEnvMaxSteps=6,
                 RLRecurrentSize=32, RLRecurrentInputSize=16,
                 RLActionHiddenSize=32, RLTrain=True)
    report = device_sim_card_against_cpu(cfg)
    assert report["ok"], report
    assert render_card_against_host(cfg, n=200)["ok"]


@pytest.mark.cuda
def test_grid_paths_agree_on_card_and_cpu(monkeypatch):
    """chip_smoke.py phase 18 at reduced width: the ai2thor fused step and
    update, the grid device sim (GRU 32, 4 envs, 6 steps, sound 1x100x40),
    and the grid render, crop and visibility against the host sim at 200
    states."""
    _require_card("it holds the card against the CPU")
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    cfg = main_config(env="ai2thor")
    cfg.override(RLNumEnvs=4, ppoNumSteps=6, RLEnvMaxSteps=3,
                 RLRecurrentSize=32, RLRecurrentInputSize=16,
                 RLActionHiddenSize=32, vecEnvBackend="dummy", RLTrain=True,
                 sound_dim=(1, 100, 40))
    report = card_against_cpu(cfg)
    assert report["ok"], report
    cfg.override(RLEnvMaxSteps=6)
    report = device_sim_card_against_cpu(cfg)
    assert report["ok"], report
    assert render_card_against_host(cfg, n=200)["ok"]


@pytest.mark.cuda
def test_grid_var_training_agrees_on_card_and_cpu(tmp_path, monkeypatch):
    """The grid VAR's first epoch at sound 1x600x40 on the card (the
    kernel at (B, 601, 257)) and on the CPU (its plain version), from one
    initial state drawn on the CPU, over one small grid collection: every
    step's loss at the CRNN's rtol 1e-3 / atol 2e-4 (its convolutions and
    73-step BiGRU sum in another order on each device), the parameters
    after the epoch within 2 lr a step + 5e-5 (Adam's bound: a near-zero
    gradient may round to the other sign)."""
    from var_tpu_torch.config import gym_register
    from var_tpu_torch.train.pretext import PretextTrainer

    _require_card("it holds the card against the CPU")
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    cfg = main_config(env="ai2thor")
    cfg.override(vecEnvBackend="dummy", audioBackend="pallas",
                 pretextDataDir=[str(tmp_path / "triplets")],
                 pretextModelSaveDir=str(tmp_path / "var"),
                 pretextCollectNum=[2, 2, 4, 4, 8], pretextDataEpisode=200,
                 pretextDataNumFiles=1, pretextNumEnvs=2, pretextEpoch=1,
                 pretextTrainBatchSize=4, pretextModelSaveInterval=100,
                 pretextModelFineTune=False, pretextDataset="VARDataset")
    gym_register(cfg, env="ai2thor")
    PretextTrainer(cfg, device="cpu").collectPretextData()
    losses, params = {}, {}
    for device in ("cpu", "cuda"):
        trainer = PretextTrainer(cfg, device=device)
        trainer.init_model(seed=977)
        run = trainer._run_epoch_indexed
        steps = losses[device] = []

        def record(ds, bank, batch_size, epoch, run=run, steps=steps):
            out, n = run(ds, bank, batch_size, epoch)
            steps.extend(out)
            return out, n

        monkeypatch.setattr(trainer, "_run_epoch_indexed", record)
        before = mld.mel_log_dct.launches
        trainer.trainRepresentation(log_csv=False)
        launched = mld.mel_log_dct.launches - before
        assert (launched > 0) == (device == "cuda")
        params[device] = {k: v.cpu() for k, v in
                          trainer.model.state_dict().items()}
    assert len(losses["cuda"]) == len(losses["cpu"]) == 5
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3,
                               atol=2e-4)
    bound = 2 * cfg.pretextLR * 5 + 5e-5
    for k, v in params["cpu"].items():
        assert (params["cuda"][k] - v).abs().max().item() <= bound, k


def _bf16_order(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their numeric order (adjacent bf16 values
    differ by 1; +0 and -0 are both 0)."""
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _image_stacks():
    """(name, convs, forward plan) of every image conv stack: the VAR's
    arm and ai2thor image branches, the arm and grid policies' image
    convs. A plan lists 'conv' and 'pool' in order."""
    from var_tpu_torch.models.encoders import (AI2ThorImageBranch,
                                               ArmImageBranch,
                                               flax_default_init_)
    from var_tpu_torch.models.policy import AI2THOR_CONVS, _convs, conv_plan

    g = torch.Generator().manual_seed(0)
    stacks = []
    arm = ArmImageBranch()
    stacks.append(("VAR arm image", arm.convs, ["conv"] * 5))
    grid = AI2ThorImageBranch()
    stacks.append(("VAR ai2thor image", grid.convs,
                   ["conv", "conv", "pool", "conv", "pool", "conv", "pool",
                    "conv", "pool", "conv"]))
    for name, plan in (("policy arm image", conv_plan((3, 96, 96))),
                       ("policy grid image", AI2THOR_CONVS)):
        stacks.append((name, _convs(plan, 3),
                       ["pool" if p == "pool" else "conv" for p in plan]))
    for _, convs, _ in stacks:
        flax_default_init_(convs, g)
    return stacks


@pytest.mark.cuda
def test_bf16_convs_within_one_step_of_exact_rounding():
    """Each conv of every image stack at computeDtype='bfloat16' on the
    card, through models/encoders.py::conv (a zero bias, so the output is
    the product cuDNN rounded to bf16), against the float64 product of the
    same bf16 inputs rounded to bf16: at most one bf16 step apart. Each
    conv reads the activations the stack gives it at bf16 from seeded
    images (ReLU, 2x2 max-pools). This is the ground of the bf16
    tolerances tests/test_torch_bf16.py and tools/rl_check.py state."""
    import torch.nn.functional as F

    from var_tpu_torch.models.encoders import conv

    _require_card("it holds cuDNN's bf16 convolutions")
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randint(0, 256, (8, 3, 96, 96)).astype(np.float32) / 255.0)
    worst = {}
    for name, convs, plan in _image_stacks():
        convs = convs.cuda()
        x = images.cuda().to(torch.bfloat16)
        it = iter(convs)
        for i, step in enumerate(plan):
            if step == "pool":
                x = F.max_pool2d(x, 2)
                continue
            layer = next(it)
            with torch.no_grad():
                bias = layer.bias.detach().clone()
                layer.bias.zero_()
                got = conv(layer, x, torch.bfloat16)
                layer.bias.copy_(bias)
                exact = F.conv2d(x.cpu().double(),
                                 layer.weight.detach().cpu().to(
                                     torch.bfloat16).double(),
                                 None, layer.stride, layer.padding)
                want = exact.to(torch.bfloat16)
                gap = (_bf16_order(got.cpu()) - _bf16_order(want)).abs()
                worst[f"{name} conv {i}"] = int(gap.max())
                # beside it, not asserted: the largest gap in units of the
                # layer's output scale, and the share over one step
                scale = (got.cpu().double() - exact).abs().max() \
                    / exact.abs().max()
                print(f"{name} conv {i}: {int(gap.max())} step(s) at most, "
                      f"{(gap > 1).double().mean().item():.2e} of outputs "
                      f"beyond one step, largest gap {scale.item():.2e} "
                      "of the layer's largest output")
                x = F.relu(conv(layer, x, torch.bfloat16))
    print("largest gap in bf16 steps, by conv:", worst)
    print("largest gap seen:", max(worst.values()), "bf16 step(s)")
    assert max(worst.values()) <= 1, worst


def test_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present; the build itself is tested on the card")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        mld.build(force=True)
