#!/usr/bin/env python3
"""Smoke run of the PyTorch port (var_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase is skipped:
1. card: CUDA must be present; prints the precision flags;
2. build: compiles every kernel of the pretext path from var_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape and two other shapes the repo's configs give, at
   rtol = atol = 1e-4, with its time (CUDA events) beside the plain
   version's and the card's bound;
4. the slice: `python -m var_tpu_torch.pretext`'s main at full arm width
   (batch 128, image 3x96x96, sound 1x100x40, representationDim 3,
   synthetic audio) with audioBackend='pallas': collect, then 5 epochs of
   6 steps. The kernel launch counts are reset just before and read just
   after; the mel-log-DCT kernel must have run twice per training step;
5. one training step from one initial state and batch with
   audioBackend='pallas' and with 'gemm': the losses agree at rtol 1e-4;
6. where an epoch's time goes: torch.profiler over one epoch of 6 steps,
   the device's busy share of the wall time and the top ops.

It then prints the card's name and power limit as nvidia-smi gives them,
one JSON line with the kernels' numbers, and, last, one JSON line
{"ok": true, "device": {...}}. Scratch output goes to build/chip_smoke/.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN_DIR = ROOT / "build" / "chip_smoke"
RTOL = ATOL = 1e-4  # both sides IEEE float32; only the summation order differs

# (name fragment, memory bytes/s, float32 FLOP/s without tensor cores),
# NVIDIA data sheets; the SXM part is the default
PEAKS = (("PCIe", 2.0e12, 51.2e12), ("NVL", 3.9e12, 60.0e12),
         ("", 3.35e12, 67.0e12))


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for frag, bw, flops in PEAKS:
        if frag in name:
            return bw, flops
    raise AssertionError("unreachable")


def time_ms(torch, fn, samples: int = 25, per_sample: int = 20):
    """Median, min and max ms per call over `samples` runs of
    `per_sample` back-to-back calls, timed with CUDA events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times), min(times), max(times)


def check_mel_log_dct(torch, np, bw, flops):
    """Phase 3 for the mel-log-DCT kernel."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.ops import mel_log_dct as mld

    rng = np.random.RandomState(0)
    # (label, STFT preset, B, frames): the main path (arm, n_fft 512), the
    # ai2thor frame count, and the n_fft-1024 presets (NSynth/UrbanSound)
    cases = (("main", "GoogleCommand", 128, 100),
             ("ai2thor T", "GoogleCommand", 8, 600),
             ("n_fft 1024", "NSynth", 8, 100))
    max_abs = 0.0
    timing = None
    for label, preset, B, frames in cases:
        params = audio.PARAM_TABLE[preset]
        L = frames * params.hop_length + params.n_fft
        wav = (rng.randn(B, L) * 0.2).astype(np.float32)
        wav[-1] = 0.0  # a silent row: every frame gives log(1e-6)
        wav_t = torch.from_numpy(wav).cuda()
        with torch.no_grad():
            power = audio._stft_power_gemm(wav_t, params,
                                           pre_padded=True).contiguous()
            power[0, -5:] = 0.0  # masked-frame rows
            got = mld.mel_log_dct(power, params)
            torch.cuda.synchronize()
            want = mld.mel_log_dct_reference(power, params)
            torch.cuda.synchronize()
        diff = (got - want).abs()
        abs_err = diff.max().item()
        big = want.abs() >= 1e-2  # relative error only where it means one
        rel_err = (diff[big] / want.abs()[big]).max().item()
        print(f"mel_log_dct {label} {tuple(power.shape)}: max abs err "
              f"{abs_err:.3e}, max rel err {rel_err:.3e} (where |ref| >= "
              f"1e-2)", flush=True)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"mel_log_dct disagrees with its plain version at {label}")
        max_abs = max(max_abs, abs_err)
        if label == "main":
            B_, T, F = power.shape
            rows = B_ * T
            n_bytes = 4 * (rows * F + F * 40 + 40 * 40 + rows * 40)
            n_flops = 2 * rows * 40 * F + 2 * rows * 40 * 40
            t_bytes, t_flops = n_bytes / bw * 1e3, n_flops / flops * 1e3
            with torch.no_grad():
                k = time_ms(torch, lambda: mld.mel_log_dct(power, params))
                p = time_ms(torch,
                            lambda: mld.mel_log_dct_reference(power, params))
            timing = dict(ms=k[0], plain_ms=p[0],
                          bound_ms=max(t_bytes, t_flops),
                          bound_by="bytes" if t_bytes >= t_flops
                          else "operations")
            print(f"mel_log_dct {tuple(power.shape)}: kernel median "
                  f"{k[0]:.5f} ms (min {k[1]:.5f}, max {k[2]:.5f}); plain "
                  f"median {p[0]:.5f} ms (min {p[1]:.5f}, max {p[2]:.5f}); "
                  f"bound {timing['bound_ms']:.5f} ms ({n_bytes} bytes, "
                  f"{n_flops} flops, {timing['bound_by']})", flush=True)
    return dict(name="mel_log_dct", route="cuda",
                source="var_tpu_torch/csrc/mel_log_dct.cu",
                replaces="var_tpu/ops/audio_pallas.py:31",
                max_abs_err=max_abs, library_ms=None, **timing)


def run_slice(torch):
    """Phase 4: the port's pretext entry point at full arm width."""
    from var_tpu_torch.ops import mel_log_dct as mld
    from var_tpu_torch.pretext import main as pretext_main

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    argv = [
        "--env", "arms", "--set",
        f'pretextDataDir=["{RUN_DIR / "data"}"]',
        f'pretextModelSaveDir="{RUN_DIR / "model"}"',
        'audioBackend="pallas"', "pretextModelFineTune=False",
        'pretextDataset="VARDataset"', 'vecEnvBackend="dummy"',
        "pretextCollectNum=[128,128,128,128,256]",
        "pretextEpoch=5", "pretextModelSaveInterval=5",
    ]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = pretext_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mel_log_dct": mld.mel_log_dct.launches}

    cfg = trainer.config
    if cfg.pretextTrainBatchSize != 128 or tuple(cfg.sound_dim) != (1, 100, 40):
        fail("the slice did not run at full arm width")
    steps = trainer.step
    print(f"slice: {steps} training steps, mel_log_dct launches "
          f"{launches['mel_log_dct']}, wall {wall:.2f} s", flush=True)
    if steps < 8 or launches["mel_log_dct"] != 2 * steps:
        fail(f"expected 2 kernel launches per step over >= 8 steps, got "
             f"{launches['mel_log_dct']} over {steps}")
    progress = RUN_DIR / "model" / "progress.csv"
    ckpt = RUN_DIR / "model" / "4" / "checkpoint.pt"
    if not progress.exists() or not ckpt.exists():
        fail("missing progress.csv or checkpoint")
    losses = [float(v) for v in progress.read_text().split()[1:]]
    print(f"slice: epoch losses {losses}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        fail(f"bad epoch losses {losses}")
    # epoch 0 holds the first-call set-up (cuDNN plans, allocator growth)
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    print(f"slice: triplets/s over epochs 1-{len(rates)}: median "
          f"{statistics.median(rates):.1f} (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); epoch seconds "
          f"{[round(t, 5) for _, t in trainer.epoch_stats]}", flush=True)
    return trainer, launches


def backend_agreement(torch, cfg):
    """Phase 5: one step, same state and batch, 'pallas' vs 'gemm'."""
    from var_tpu_torch.data.triplets import load_env_data
    from var_tpu_torch.train.pretext import PretextTrainer

    trainer = PretextTrainer(cfg, device="cuda")
    ds = load_env_data(cfg, trainer._ensure_audio())
    trainer.init_model(seed=cfg.pretextEnvSeed)
    init_state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bank = trainer._upload_dataset(ds)
    idx = ds.epoch_order(0)[:cfg.pretextTrainBatchSize]
    pos_ids, pos_zero, neg_ids, neg_zero = ds.epoch_clip_ids(bank["ranges"], 0)

    def put(a):
        return torch.from_numpy(a).cuda()

    batch = (put(idx.astype("int64")), put(pos_ids[idx].astype("int64")),
             put(pos_zero[idx]), put(neg_ids[idx].astype("int64")),
             put(neg_zero[idx]))
    losses, feats = {}, {}
    for backend in ("pallas", "gemm"):
        cfg.override(audioBackend=backend)
        trainer.model.load_state_dict(init_state)
        trainer.setup_optimizer(steps_per_epoch=1)
        with torch.no_grad():
            feats[backend] = trainer._features(bank, batch[1], batch[2])
        losses[backend] = trainer._train_step_indexed(bank, *batch).item()
    feat_err = (feats["pallas"] - feats["gemm"]).abs().max().item()
    print(f"backends: loss pallas {losses['pallas']!r} gemm "
          f"{losses['gemm']!r}; sound features max abs diff {feat_err:.3e}",
          flush=True)
    if not math.isclose(losses["pallas"], losses["gemm"], rel_tol=1e-4):
        fail("pallas and gemm losses disagree")
    cfg.override(audioBackend="pallas")
    return trainer, ds, bank


def breakdown(torch, trainer, ds, bank):
    """Phase 6: where one epoch's time goes (torch.profiler): the device's
    busy share of the wall time and the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.config.pretextTrainBatchSize
    trainer.setup_optimizer(steps_per_epoch=1)
    trainer._run_epoch_indexed(ds, bank, batch, epoch=1)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, n = trainer._run_epoch_indexed(ds, bank, batch, epoch=2)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / -(-n // batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, n = trainer._run_epoch_indexed(ds, bank, batch, epoch=3)
        torch.cuda.synchronize()
    steps = -(-n // batch)
    # device-side kernel events only: the CPU ops that launched them, and
    # annotated ranges such as Optimizer.step, carry the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    print(f"breakdown: device kernel time {device_ms:.4f} ms/step "
          f"(profiled epoch), wall {wall_ms:.4f} ms/step (unprofiled "
          f"epoch): device busy {100 * device_ms / wall_ms:.1f}% of wall",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"breakdown:   {ms:8.4f} ms/step {100 * ms / device_ms:5.1f}% "
              f"x{e.count // steps:<3d} {e.key[:80]}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from var_tpu_torch.device import precision_flags, resolve_device
    from var_tpu_torch.ops import mel_log_dct as mld

    resolve_device("cuda")
    line = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {name}; precision {precision_flags()}", flush=True)

    t0 = time.perf_counter()
    mld.build(force=True)
    print(f"build: mel_log_dct.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)

    bw, flops = peaks(line)
    kernel = check_mel_log_dct(torch, np, bw, flops)
    trainer, launches = run_slice(torch)
    kernel["launches"] = launches[kernel["name"]]
    breakdown(torch, *backend_agreement(torch, trainer.config))

    print(line)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
