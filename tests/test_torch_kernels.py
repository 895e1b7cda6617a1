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


def _benchmark_checks(cfg, card, bench):
    """The profile's fused step and update, its device sim's collect and
    update, and one pretext step, card against CPU, with cudnn.benchmark
    `bench` on the card: the three reports."""
    from var_tpu_torch.tools.rl_check import pretext_card_against_cpu

    fused = card_against_cpu(cfg, card=card, cudnn_benchmark=bench)
    devsim = device_sim_card_against_cpu(cfg, card=card,
                                         cudnn_benchmark=bench)
    pretext = pretext_card_against_cpu(cfg, card=card, cudnn_benchmark=bench)
    return fused, devsim, pretext


def _small_grid(**knobs):
    cfg = main_config(env="ai2thor")
    cfg.override(**{**dict(
        RLNumEnvs=4, ppoNumSteps=6, RLEnvMaxSteps=6, RLRecurrentSize=32,
        RLRecurrentInputSize=16, RLActionHiddenSize=32,
        vecEnvBackend="dummy", RLTrain=True, sound_dim=(1, 100, 40),
        audioBackend="pallas", pretextTrainBatchSize=4), **knobs})
    return cfg


def test_cudnn_benchmark_check_rehearses_on_the_cpu(monkeypatch):
    """tools/rl_check.py's cudnn_benchmark=True for the fused step (its
    throwaway rollout and update on copies of the card's engine, then the
    compared pass) with the CPU in the card's place, tiny arm widths: the
    same computation on both sides, so the report passes with no error,
    and the flag is left as it was."""
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "2")
    cfg = main_config(env="arms")
    cfg.override(RLNumEnvs=2, ppoNumSteps=2, RLEnvMaxSteps=2,
                 RLRecurrentSize=16, RLRecurrentInputSize=8,
                 RLActionHiddenSize=16, vecEnvBackend="dummy", RLTrain=True)
    before = torch.backends.cudnn.benchmark
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # several test workers share the machine
    try:
        report = card_against_cpu(cfg, card="cpu", cudnn_benchmark=True)
    finally:
        torch.set_num_threads(threads)
    assert torch.backends.cudnn.benchmark == before
    assert report["ok"] and report["param_max_diff"] == 0.0, report


@pytest.mark.cuda
def test_grid_checks_hold_with_cudnn_benchmark(monkeypatch):
    """tools/e2e_run.py's runs may set cudnn.benchmark; the grid's card
    checks at reduced width hold at the same tolerances with it on (after
    a throwaway pass, so cuDNN has chosen) as with it off. Both sets of
    gaps are printed (chip_smoke.py phase 18 runs them at full width)."""
    _require_card("it holds the card against the CPU")
    monkeypatch.setenv("VAR_TPU_SYNTH_CLIPS", "3")
    for bench in (False, True):
        names = ("fused", "device sim", "pretext")
        for name, report in zip(names, _benchmark_checks(
                _small_grid(), "cuda", bench)):
            print(f"cudnn.benchmark={bench} {name}: {report}")
            assert report["ok"], (bench, name, report)


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


def _bf16_conv_rows(device):
    """Each conv of every image stack at computeDtype='bfloat16' on
    `device`, through models/encoders.py::conv with a zero bias (so the
    output is the product rounded to bf16), each conv reading the
    activations the stack gives it at bf16 from seeded images (ReLU, 2x2
    max-pools). On the CPU also the float32 product of the same bf16
    operands rounded once, XLA's contract for JAX's bf16 Conv. Returns
    {(stack conv, route): (steps from the float64 product rounded to
    bf16, share beyond one step, largest gap over the layer's largest
    output, largest gap over tools/bf16_bound.py's bound (1))}."""
    import torch.nn.functional as F

    from var_tpu_torch.models.encoders import conv
    from var_tpu_torch.tools.bf16_bound import product_bound

    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randint(0, 256, (8, 3, 96, 96)).astype(np.float32) / 255.0)
    rows = {}
    for name, convs, plan in _image_stacks():
        convs = convs.to(device)
        x = images.to(device).to(torch.bfloat16)
        it = iter(convs)
        for i, step in enumerate(plan):
            if step == "pool":
                x = F.max_pool2d(x, 2)
                continue
            layer = next(it)
            with torch.no_grad():
                w = layer.weight.detach().cpu().to(torch.bfloat16).double()
                xd = x.cpu().double()
                exact = F.conv2d(xd, w, None, layer.stride, layer.padding)
                bound = product_bound(exact, F.conv2d(
                    xd.abs(), w.abs(), None, layer.stride, layer.padding),
                    w[0].numel())
                bias = layer.bias.detach().clone()
                layer.bias.zero_()
                routes = {"port conv": conv(layer, x, torch.bfloat16)}
                layer.bias.copy_(bias)
                if device == "cpu":
                    routes["float32 product"] = F.conv2d(
                        xd.float(), w.float(), None, layer.stride,
                        layer.padding).to(torch.bfloat16)
                for route, got in routes.items():
                    got = got.cpu()
                    gap = (_bf16_order(got)
                           - _bf16_order(exact.to(torch.bfloat16))).abs()
                    err = (got.double() - exact).abs()
                    rows[(f"{name} conv {i}", route)] = (
                        int(gap.max()), (gap > 1).double().mean().item(),
                        (err.max() / exact.abs().max()).item(),
                        (err / bound).max().item())
                x = F.relu(conv(layer, x, torch.bfloat16))
    for (conv_name, route), (steps, beyond, rel, ratio) in rows.items():
        print(f"{conv_name} [{route}, {device}]: {steps} step(s) at most, "
              f"{beyond:.2e} of outputs beyond one step, largest gap "
              f"{rel:.2e} of the layer's largest output, {ratio:.3f} of "
              "the bound")
    return rows


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_bf16_convs_within_the_fp32_accumulation_bound(device):
    """Every conv of the four image stacks at bf16 lies within
    tools/bf16_bound.py's bound (1) of the float64 product of its bf16
    operands, element by element: what any float32 accumulation rounded
    once guarantees. The same assertion on the CPU (the port's conv and the
    float32 product rounded once) and on the card (cuDNN's bf16 conv): a
    route that rounded partial sums to bf16 would break it. The older claim,
    one bf16 step of the exactly rounded product, is printed beside it and
    not asserted: near-zero outputs of sums that cancel land many steps away
    on the CPU's float32 product too."""
    if device == "cuda":
        _require_card("it holds cuDNN's bf16 convolutions")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # several test workers share the machine
    try:
        rows = _bf16_conv_rows(device)
    finally:
        torch.set_num_threads(threads)
    print("largest gap in bf16 steps:", max(r[0] for r in rows.values()))
    worst = max(rows.items(), key=lambda kv: kv[1][3])
    print("closest to the bound:", worst)
    assert worst[1][3] <= 1.0, worst


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_bf16_dense_within_the_fp32_accumulation_bound(device):
    """Every dense layer of the VAR heads (both profiles, image and sound)
    at bf16 through models/encoders.py::dense, zero bias, on 64 seeded
    rows of post-ReLU activations (a third of them zero), against the
    float64 product of its bf16 operands: within the bound (1) of
    tools/bf16_bound.py, element by element. On the card this is cuBLAS
    with allow_bf16_reduced_precision_reduction off (device.py), which
    sums in float32 as the JAX package's bf16 Dense does."""
    from var_tpu_torch.device import configure_precision
    from var_tpu_torch.models.encoders import VARPretextNet, dense
    from var_tpu_torch.tools.bf16_bound import product_bound

    if device == "cuda":
        _require_card("it holds cuBLAS's bf16 matmul")
        configure_precision()
    rng = np.random.RandomState(1)
    worst = 0.0
    for variant in ("arm", "ai2thor"):
        var = VARPretextNet(3, variant).reset_parameters(
            torch.Generator().manual_seed(0))
        for head in (var.img_triplet, var.sound_triplet):
            for layer in head.layers:
                n_in = layer.weight.shape[1]
                x = rng.rand(64, n_in) * (rng.rand(64, n_in) > 1 / 3)
                x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                w = layer.weight.detach().to(torch.bfloat16).double()
                with torch.no_grad():
                    layer.bias.zero_()
                    got = dense(layer.to(device), x.to(device),
                                torch.bfloat16).cpu().double()
                exact = x.double() @ w.t()
                bound = product_bound(exact, x.double().abs() @ w.abs().t(),
                                      n_in)
                ratio = ((got - exact).abs() / bound).max().item()
                print(f"{variant} head dense {n_in}->{w.shape[0]} "
                      f"[{device}]: {ratio:.3f} of the bound")
                worst = max(worst, ratio)
    assert worst <= 1.0


def test_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present; the build itself is tested on the card")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        mld.build(force=True)
