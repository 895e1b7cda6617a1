#!/usr/bin/env python3
"""Smoke run of the PyTorch port (var_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase is skipped:
1. card: CUDA must be present; prints the precision flags and fails
   unless TF32 and cuBLAS's bf16 reduced-precision reduction are off;
2. build: compiles every kernel of the pretext path from var_tpu_torch/csrc
   with nvcc (sm_90a), and the host libraries (csrc/simcore.cpp, the grid
   sim's raycast; csrc/shmbuf.cpp, ShmemVecEnv's shared memory) with g++,
   all started together, and prints the build times;
3. each kernel against its plain PyTorch version on the card, at the arm
   path's shape (128, 101, 257), a dp=2 rank's share of it (64, 101, 257)
   and a dp=4 rank's (32, 101, 257), the ai2thor path's (128, 601, 257)
   and a dp=4 rank's share of it (32, 601, 257), the
   pos + neg batch (256, 601, 257), a short last unit (8, 601, 257) and
   the n_fft-1024 presets, in both input layouts (the gemm STFT's view,
   contiguous), at rtol = atol = 1e-4, with NaN and inf rows; then its
   times (CUDA events, queued behind a spin kernel so that the host's
   launch overhead stays out): cold, rotating over > 100 MB of inputs so
   each call reads device memory, and warm, one input back to back as on
   the path; the wrapper's host time per call; at the arm and ai2thor
   shapes and the dp ranks' the plain version's times beside them, and
   the card's bound;
4. the slice: `python -m var_tpu_torch.pretext`'s main at full arm width
   (batch 128, image 3x96x96, sound 1x100x40, representationDim 3,
   synthetic audio) with audioBackend='pallas': collect, then 5 epochs of
   6 steps. The kernel launch counts are reset just before and read just
   after; the mel-log-DCT kernel must have run twice per training step;
5. one training step from one initial state and batch with
   audioBackend='pallas' and with 'gemm': the losses agree at rtol 1e-4;
6. where an epoch's time goes: torch.profiler over one epoch of 6 steps,
   the device's busy share of the wall time, the kernel launches per step
   and every kernel's time;
7. RL train: `python -m var_tpu_torch.rl`'s main at full arm width (8 envs
   x 100 steps, GRU 512, GRU input 128, action hidden 128, 4 PPO epochs x
   2 minibatches) on phase 4's VAR checkpoint: 3 PPO updates, each saved.
   The kernel launch counts are reset just before and read just after (the
   RL path launches no TPU-kernel port: mel_log_dct stays at 0). Checks 3
   checkpoints, finite losses in progress.csv and changed parameters;
   prints env-steps/s and the p50 of fused_step, env_step and ppo_update;
8. RL eval: deterministic testRL on phase 7's last checkpoint, 8 envs, 16
   episodes: test_<ckpt>.csv has 16 rows, the success rate is in [0, 1];
9. the card against the CPU: a 10-step fused rollout (episodes of 5
   steps) and one PPO update at full width, from the same weights, noise,
   batch and permutations (var_tpu_torch/tools/rl_check.py): values,
   log-probs, normalised rewards, returns and losses at rtol = atol = 1e-4,
   parameters at the Adam-step tolerance stated there;
10. where an RL update's time goes: torch.profiler over one 100-step
   rollout and over its PPO update: kernel launches per env step and per
   update, the device's busy share of the wall, the ten longest kernels;
11. device-sim train: `python -m var_tpu_torch.rl`'s main with
   RLDeviceSimRollout=True at full arm width with 64 envs (the arm E2E
   recipe's) on phase 4's VAR: 3 PPO updates, each saved. Checks the
   width, 3 checkpoints, finite losses, changed parameters and no
   mel_log_dct launch; prints env-steps/s (median over updates 1-2), the
   p50 of collect and ppo_update and the peak device memory;
12. device-sim eval: RLDeviceSimEval on phase 11's last checkpoint, 64
   envs, 1024 episodes (the E2E eval count): test_<ckpt>_devicesim.csv has
   1024 rows, the success rate is in [0, 1]; prints episodes/s and
   env-steps/s, set-up included;
13. the device sim, card against CPU (var_tpu_torch/tools/rl_check.py):
   one collect (8 envs x 10 steps, full width), one eval batch and one PPO
   update from the same weights and draws: images, gripper poses, success
   bits and counts equal, the rest at rtol = atol = 1e-4, parameters at
   the Adam-step tolerance; render on the card against the host sim's
   get_image at 1,000 seeded states, every pixel equal;
14. where a device-sim update's time goes: torch.profiler over one
   collect at 64 envs (GAE included) and over its PPO update, beside their
   unprofiled wall times: kernel launches per env step and per update, the
   device's busy share of each, the ten longest kernels.

Phases 15-19 run the ai2thor profile at its full width (image 3x96x96,
sound 1x600x40, representationDim 3, GRU 1024, GRU input 128, action
hidden 128, 8 actions, 50-step episodes, 4 PPO epochs x 2 minibatches),
after the arm's device memory is released:
15. pretext: `python -m var_tpu_torch.pretext --env ai2thor` with
   audioBackend='pallas' on the synthetic FSC source: collect 768 triplets
   on the grid pretext sim, then 5 epochs of 6 steps at batch 128; 2
   mel-log-DCT launches per step, finite and falling losses; triplets/s
   over epochs 1-4; one step with 'pallas' against 'gemm' (losses at the
   CRNN's rtol 1e-3); where an epoch's time goes, as phase 6;
16. the fused host path: 2 PPO updates at 8 envs x 50 steps on phase 15's
   VAR, then a deterministic eval of 16 episodes (4 envs, 4 per class);
17. the grid device sim: 3 PPO updates at 64 envs x 50 steps (the grid
   E2E recipe's num_envs), then RLDeviceSimEval over 1024 episodes;
   env-steps/s, episodes/s, peak device memory;
18. card against CPU: the grid's fused step and update (8 envs x 10
   steps), its device sim's collect, eval batch and update (8 envs x 10
   steps), images, occupancy crops and success bits equal; the card's
   render, occupancy crop and visibility against the host grid sim at
   1,000 seeded states; then the fused and device-sim checks again with
   torch.backends.cudnn.benchmark on (tools/e2e_run.py's runs may set
   it), each after a throwaway pass so that cuDNN has chosen, and one
   CRNN pretext step at batch 128 with the flag off and on, every gap
   printed beside its twin at the same tolerances;
19. where a grid device-sim collect and its update spend their time, as
   phase 14.

Phases 20-23 run the arm profile's E2E tools and the paths ported with
them, at full arm width, on phase 4's VAR:
20. legs: `python -m var_tpu_torch.tools.e2e_run --stages rl --leg-steps`
   on the device sim at 64 envs, a run of 3 PPO updates split 2 + 1 with
   RLLrDecay='linear': labels 00000-00002 and the done marker only after
   leg 2; the optimizer steps' counts continue across the legs and every
   step's LR is the unsplit run's schedule; leg 2's first optimizer step
   starts from leg 1's last parameters, Adam count and moments, exactly;
21. the sweep: tools/success_curve.py through e2e_run's selection over
   those checkpoints at 256 episodes a class (1024 each), 128 envs: the
   curve CSV's rows and columns, the rl_model/best link;
22. self-improvement: one 'scratch' round of train/self_improve.py at full
   arm width with audioBackend='pallas' (collect 384 triplets, 2 VAR
   epochs at batch 128, 1 device-sim PPO update at 64 envs resuming from
   phase 20's newest checkpoint): 2 mel-log-DCT launches per VAR step, the
   kernel held against its plain version on the first input the path gave
   it, the new VAR as the RL load target and the label 00003;
23. the reward-wrapper path (fusedRollout=False): 2 PPO updates at 8 envs
   x 100 steps through `python -m var_tpu_torch.rl`, a wrapped eval of 16
   episodes, then card against CPU (tools/rl_check.py
   wrapped_card_against_cpu: a 10-step rollout, each step's act and image
   features, one PPO update).

Phases 24-28 run pretext's other paths and the pipelined rollout at full
arm width (batch 128, image 3x96x96, sound 1x100x40,
audioBackend='pallas'):
24. the 'mix' preset (GoogleCommand 512/160 + UrbanSound 1024/640) through
   the multi-bank path, its store built as tests/test_hetero_bank.py builds
   it (synthetic UrbanSound clips in the preset's layout, sizes
   [25, 0, 0, 25]): collect 768 triplets, 3 epochs of 6 steps; 4 kernel
   launches a step, 2 at (128, 101, 257) and 2 at (128, 101, 513); the
   kernel held against its plain version on the path's first F = 513
   input and timed there, cold and warm, beside its plain version and its
   bound; one step's loss with 'pallas' against 'gemm' at rtol 1e-4;
   triplets/s;
25. the chunked path on phase 4's data and VAR: a one-chunk epoch against
   the resident one at rtol 1e-5; then a pretextHBMBudgetMB that leaves
   256 items a slab, 3 slabs of 2 steps an epoch, 3 epochs at 2 launches
   a step; triplets/s beside phase 4's resident rate;
26. the streaming path: `python -m var_tpu_torch.pretext` over shards
   collected with pretextDataHasSound=True, 3 epochs of 6 feature steps
   with one batch's upload in flight, no kernel launch; triplets/s;
27. testRepresentation on phase 4's VAR through the pretext entry's
   dispatch: representation.npz with a row per item, one launch a batch
   (the positive sound's MFCC);
28. RLPipelinedRollout: 2 PPO updates at 8 envs x 100 steps through
   `python -m var_tpu_torch.rl` on phase 4's VAR: the warning, finite
   losses, no kernel launch; env-steps/s beside phase 7's exact-protocol
   rate, the p50 of fused_step and env_step.

Phases 1-28 run their vec envs in-process (vecEnvBackend='dummy'), so
their numbers compare with earlier runs'. Phases 29-32 run the host env
layer the JAX package runs by default:
29. the native raycast (csrc/simcore.cpp) against the numpy one at 300
   seeded grid states: frames and pixels that differ, the largest
   difference, within tests/test_native.py's bound (0.5% of a frame's
   pixels); ms per frame of each; rotate_crop at 0 and 90 degrees against
   scipy; the host's CPU model and count;
30. ShmemVecEnv (forkserver workers) against DummyVecEnv at 8 envs, both
   profiles' RL sims, both transports ('posix', 'array'), 2 full episodes
   of seeded actions: observations, rewards, dones and obs_list equal; the
   env_step p50 of each; no segment left in /dev/shm after close; no
   worker with a CUDA context;
31. the main path at the JAX package's defaults, no vecEnvBackend
   override, each profile: pretext collection at pretextNumEnvs (4)
   through ShmemVecEnv, 2 VAR epochs at batch 128 through the kernel (2
   launches a step at (128, 101, 257) or (128, 601, 257), held against
   its plain version on the path's first input), 2 fused PPO updates at 8
   envs (x 100 or x 50 steps) and a 16-episode eval, each through
   ShmemVecEnv; env-steps/s, fused_step and env_step p50 beside phases 7
   and 16's DummyVecEnv numbers;
32. the grid's fused host path at 64 envs x 50 steps, 2 PPO updates:
   env-steps/s, the peak summed resident and private resident memory of
   the worker processes, the host's available memory.

Phase 33 runs what a user drives by hand:
33. manual control (RLTrainer.manualControl) with render=True and an
   episode frame recorded every step, each profile on its phase-4 VAR on
   the card, from a scripted stream (grid keys, arm 'dx dy' lines, a
   repeat, a refused command, 'quit'): one finite step reward per valid
   command, every frame a PNG of episodeImgSize read back with zlib, the
   live view 96x96x3, no mel-log-DCT launch (the goal MFCC is the host's);
   then run() with RLManualControlLoaded=False (a fresh VAR) reading
   commands from stdin.

Phase 34 runs computeDtype='bfloat16' (the conv stacks in bf16, as the
JAX package's knob) on both profiles at full width:
34. each profile's pretext entry point at bf16 on phase 4's or 15's
   triplets, 3 epochs of 6 steps at batch 128 through the kernel (2
   launches a step): triplets/s over epochs 1-2 beside phase 4's or 15's
   float32 median; the device sim at 64 envs on that VAR, 2 PPO updates:
   env-steps/s, collect and ppo_update p50 beside phase 11's or 17's; then
   the card against the CPU at bf16 (tools/rl_check.py's bf16
   tolerances, tests/test_torch_bf16.py's): one pretext step at batch 16
   and one fused rollout of 10 steps at 8 envs with its PPO update; then
   that rollout's control, the card's VAR convs reducing their partial
   sums in bf16 (rl_check.bf16_partial_sums), which must fail them.

Phase 35 runs meshShape data parallelism (var_tpu_torch/parallel/):
35. arm pretext (one epoch of 6 steps at batch 128 on phase 4's triplets
   through the kernel), the arm's fused host path (one PPO update at 8
   envs x 100 steps) and each profile's device sim (one update at 64
   envs), each from phase 4's or 15's VAR: at meshShape={'dp': 1}
   through the entry points, one rank on an NCCL group, held against the
   unsharded phases 4, 7, 11 and 17 of this call (the first epoch's loss,
   the first update's progress row at rtol = atol = 1e-4 and its
   checkpoint within 2 lr a step + 5e-5); then at dp=2 on this card (two
   spawned ranks on cuda:0 over gloo, since NCCL takes one rank a card),
   held against dp=1 the same way; each dp=2 rank's kernel launches (2 a
   step, every one at (64, 101, 257)) and the kernel against its plain
   version on the rank's first input; wall time and rate of each.

Phase 36 runs the last modules ported:
36. testRepresentation to representation.png on phase 4's arm VAR (D =
   3, the sphere), a seeded arm VAR at D = 8 (its t-SNE on the card,
   seconds and N printed) and phase 15's ai2thor VAR, each through the
   kernel (one launch a batch); realTimeVec on the arm's reward-wrapper
   path through manual control and in scripted manual collection (the
   frame file rewritten at each step, ms a frame); every number logged
   through utils/kvlogger.py into TensorBoard events and read back with
   utils/tb_writer.py's read_events.

Phase 37 runs meshShape across cards (var_tpu_torch/tools/mesh_cards.py):
37. with two or more cards visible, the tool over all of them (rank r on
   cuda:r, NCCL): every check at dp=N against dp=1 on cuda:0, through the
   entry points' spawn and under torchrun, each rank's parameters bit for
   bit against rank 0's, each rank's first kernel input against the plain
   version, the entry points as a user starts them, and the rates at dp =
   1, 2, ..., N; with one card it prints that it needs two or more.

Phase 38 runs the simulator adapters (var_tpu_torch/envs/adapters/) on
recording stand-ins of PyBullet and AI2-THOR that label
(tests/torch_adapter_standins.py), since no machine here has either:
38. for simBackend='pybullet' (the arm) and 'ithor' (the grid), through
   the entry points at full width with vecEnvBackend='dummy': pretext
   collection through the adapter (quotas [32, 32, 32, 32, 64]), 3 VAR
   epochs at batch 128 through the kernel (2 launches a step), 2 fused PPO
   updates (8 envs x 100 steps at GRU 512; 8 x 50 at GRU 1024), testRL's
   host evaluation over 8 episodes to its CSV; the launches of that path
   under launches_by_path["adapters_arms"] and ["adapters_ai2thor"];
   then RLDeviceSimEval=True must raise ValueError, the kernel on the
   path's first input against its plain version, and the fused step and
   update card against CPU (tools/rl_check.py). Prints the adapter's
   frames/s, the collection's triplets/s and the env-steps/s.

It then stops the processes it started (the forkserver and the resource
tracker are stopped and waited for; a worker left running fails the run;
this runs on failure too), prints the card's name and power limit as
nvidia-smi gives them, one JSON line with the kernels' numbers, and, last,
one JSON line
{"ok": true, "device": {...}}. Scratch output goes to build/chip_smoke/.
"""
from __future__ import annotations

import copy
import csv
import functools
import gc
import json
import math
import os
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


# (label, STFT preset, B, frames): the arm path ("main", n_fft 512), the
# ai2thor path (two launches of batch 128 a step; 256 if the step fused
# pos + neg; 8 leaves a short last unit of rows), and the n_fft-1024
# presets (NSynth/UrbanSound)
CASES = (("main", "GoogleCommand", 128, 100),
         ("main dp=2 rank", "GoogleCommand", 64, 100),
         ("main dp=4 rank", "GoogleCommand", 32, 100),
         ("ai2thor", "FSC", 128, 600),
         ("ai2thor dp=4 rank", "FSC", 32, 600),
         ("ai2thor pos+neg", "FSC", 256, 600),
         ("ai2thor short unit", "FSC", 8, 600),
         ("n_fft 1024", "NSynth", 8, 100))
# the paths' shapes, a dp=4 rank's share of each profile's batch among them
TIMED_PLAIN = ("main", "main dp=2 rank", "main dp=4 rank", "ai2thor",
               "ai2thor dp=4 rank")
COLD_BYTES = 100e6  # rotating inputs this large cannot stay in the 50 MB L2
_spin = {}


def spectrograms(torch, np, audio, preset, B, frames, seed=0):
    """The kernel's input at one case, from the gemm STFT of seeded noise
    with a silent batch row and masked frames, in both layouts: the STFT's
    (B, T, F) view of its (B, F, T) output, which the main path hands the
    kernel, and the contiguous (B, T, F) tensor."""
    params = audio.PARAM_TABLE[preset]
    rng = np.random.RandomState(seed)
    wav = (rng.randn(B, frames * params.hop_length + params.n_fft) * 0.2
           ).astype(np.float32)
    wav[-1] = 0.0  # a silent row: every frame gives log(1e-6)
    with torch.no_grad():
        view = audio._stft_power_gemm(torch.from_numpy(wav).cuda(), params,
                                      pre_padded=True)
        view[0, -5:] = 0.0  # masked-frame rows
    return params, {"stft view": view, "contiguous": view.contiguous()}


def spin_cycles(torch, host_ms: float) -> int:
    """Cycles of torch.cuda._sleep that keep the device busy for three
    times `host_ms`, calibrated once per process."""
    if "ms_per_mcycle" not in _spin:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1_000_000)
        end.record()
        end.synchronize()
        _spin["ms_per_mcycle"] = start.elapsed_time(end)
    return int(1e6 * 3 * host_ms / _spin["ms_per_mcycle"]) + 1


def time_ms(torch, fn, inputs, samples: int = 15, per_sample: int = 20):
    """Median, min and max device ms per call of `fn`, taking `inputs` in
    turn, over `samples` runs of `per_sample` back-to-back calls timed with
    CUDA events, and the host's median ms per call. Each run is queued
    behind a spin kernel that outlasts the host's launch time, so the device
    runs the calls without gaps and the host's overhead stays out of the
    device time."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(per_sample):
        fn(inputs[j % len(inputs)])
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = spin_cycles(torch, host_ms)
    times, host, k = [], [], 0
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per_sample):
            fn(inputs[k % len(inputs)])
            k += 1
        host.append((time.perf_counter() - t0) * 1e3 / per_sample)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return (statistics.median(times), min(times), max(times),
            statistics.median(host))


def cold_warm(torch, fn, x):
    """(cold, warm) timings of fn: cold rotates over enough clones of x
    (strides kept) that each call reads its input from device memory;
    warm calls fn on x back to back, as the path does right after the STFT
    has written x."""
    n = max(8, math.ceil(COLD_BYTES / (4 * x.numel())) + 1)
    clones = [x.clone() for _ in range(n)]
    cold = time_ms(torch, fn, clones)
    del clones
    return cold, time_ms(torch, fn, [x])


def fmt(t) -> str:
    return f"{t[0]:.5f} ms (min {t[1]:.5f}, max {t[2]:.5f})"


def kernel_times(torch, np, mld, audio):
    """Cold and warm times of `mld.mel_log_dct` (the wrapper) at every case
    and layout, and of `mld.mel_log_dct_reference` at the main one."""
    rows = []
    with torch.no_grad():
        for label, preset, B, frames in CASES:
            params, layouts = spectrograms(torch, np, audio, preset, B, frames)
            for layout, power in layouts.items():
                fn = functools.partial(mld.mel_log_dct, params=params)
                cold, warm = cold_warm(torch, fn, power)
                row = dict(case=label, shape=list(power.shape), layout=layout,
                           cold_ms=cold[0], warm_ms=warm[0],
                           host_ms=warm[3])
                print(f"time {label} {tuple(power.shape)} {layout}: "
                      f"cold {fmt(cold)}; warm {fmt(warm)}; host "
                      f"{warm[3]:.5f} ms a call", flush=True)
                if label in TIMED_PLAIN:
                    ref = functools.partial(mld.mel_log_dct_reference,
                                            params=params)
                    pcold, pwarm = cold_warm(torch, ref, power)
                    row.update(plain_cold_ms=pcold[0], plain_warm_ms=pwarm[0])
                    print(f"time {label} {layout} plain: cold {fmt(pcold)}; "
                          f"warm {fmt(pwarm)}", flush=True)
                    # yardstick, not the same function: one PyTorch
                    # reduction that reads the same input once
                    rcold, rwarm = cold_warm(
                        torch, lambda x: torch.sum(x, dim=-1), power)
                    row.update(read_cold_ms=rcold[0], read_warm_ms=rwarm[0])
                    print(f"time {label} {layout} torch.sum(power, -1) "
                          f"(reads the input once): cold {fmt(rcold)}; warm "
                          f"{fmt(rwarm)}", flush=True)
                rows.append(row)
    return rows


def mld_bound(np, audio, params, shape, bw, flops, cold_ms):
    """The least time of a mel-log-DCT call at `shape` (B, T, F): the
    larger of its bytes (the power read once, the tables, the output
    written once) over the memory rate and its float32 operations (the
    banded mel sums and the DCT) over the peak rate. Prints it beside the
    kernel's cold time; returns (bound ms, 'bytes' or 'operations')."""
    Bm, T, F = shape
    n_rows = Bm * T
    mel = audio._frontend_constants(params, "float32")[2]
    nnz = int(np.count_nonzero(mel))
    n_bytes = 4 * (n_rows * F + F * 40 + 40 * 40 + n_rows * 40)
    n_flops = 2 * n_rows * (nnz + 40 * 40)  # the banded product's needs
    t_bytes, t_flops = n_bytes / bw * 1e3, n_flops / flops * 1e3
    bound = max(t_bytes, t_flops)
    print(f"mel_log_dct {tuple(shape)}: bound {bound:.5f} ms "
          f"({n_bytes} bytes, {n_flops} flops); kernel cold "
          f"{cold_ms:.5f} ms = {100 * bound / cold_ms:.1f}% of the bound",
          flush=True)
    return bound, "bytes" if t_bytes >= t_flops else "operations"


def check_mel_log_dct(torch, np, bw, flops):
    """Phase 3 for the mel-log-DCT kernel: against its plain version at
    every case and layout, finite and non-finite rows."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.ops import mel_log_dct as mld

    max_abs = 0.0
    with torch.no_grad():
        for label, preset, B, frames in CASES:
            params, layouts = spectrograms(torch, np, audio, preset, B, frames)
            for layout, power in layouts.items():
                got = mld.mel_log_dct(power, params)
                want = mld.mel_log_dct_reference(power, params)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                abs_err = diff.max().item()
                big = want.abs() >= 1e-2  # relative error where it means one
                rel_err = (diff[big] / want.abs()[big]).max().item()
                print(f"mel_log_dct {label} {tuple(power.shape)} {layout}: "
                      f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                      f"(where |ref| >= 1e-2)", flush=True)
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"mel_log_dct disagrees with its plain version at "
                         f"{label}, {layout}")
                max_abs = max(max_abs, abs_err)
                # one NaN bin, one inf bin outside every band (bin 0), one
                # -inf bin: the dense form makes each such row all NaN
                bad = power.clone()
                F = bad.shape[-1]
                bad[0, 1, 17] = math.nan
                bad[0, 2, 0] = math.inf
                bad[-1, 3, F - 1] = -math.inf
                got = mld.mel_log_dct(bad, params)
                want = mld.mel_log_dct_reference(bad, params)
                rows_nan = got[0, 1:3].isnan().all() and got[-1, 3].isnan().all()
                if not (rows_nan and torch.allclose(got, want, rtol=RTOL,
                                                    atol=ATOL, equal_nan=True)):
                    fail(f"mel_log_dct non-finite rows differ from the plain "
                         f"version at {label}, {layout}")
        print("mel_log_dct: NaN/inf rows all NaN, as in the plain version",
              flush=True)
        rows = kernel_times(torch, np, mld, audio)
    timed = {}
    for label, preset, _, _ in CASES:
        if label not in TIMED_PLAIN:
            continue
        row = next(r for r in rows
                   if r["case"] == label and r["layout"] == "stft view")
        bound, bound_by = mld_bound(np, audio, audio.PARAM_TABLE[preset],
                                    row["shape"], bw, flops, row["cold_ms"])
        timed[label] = dict(
            shape=row["shape"], ms=row["cold_ms"], warm_ms=row["warm_ms"],
            plain_ms=row["plain_cold_ms"], bound_ms=bound, bound_by=bound_by)
    main = timed.pop("main")
    return dict(name="mel_log_dct", route="cuda",
                source="var_tpu_torch/csrc/mel_log_dct.cu",
                replaces="var_tpu/ops/audio_pallas.py:31",
                max_abs_err=max_abs, ms=main["ms"], warm_ms=main["warm_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                # the ai2thor pretext's shape, timed the same way
                by_shape=[dict(case=k, library_ms=None, **v)
                          for k, v in timed.items()])


# each profile's full width and this script's depth on it; `key` prefixes
# the profile's entries in the kernels line's launches_by_path
PROFILES = {
    "arms": dict(key="", sound=(1, 100, 40), steps=100, gru=512,
                 rl_updates=3, eval_envs=8, eval_per_class=None,
                 pretext_rel_tol=1e-4),
    # the CRNN's allowance (BASELINE.md) for the pallas-vs-gemm loss
    "ai2thor": dict(key="ai2thor_", sound=(1, 600, 40), steps=50, gru=1024,
                    rl_updates=2, eval_envs=4, eval_per_class=1,
                    pretext_rel_tol=1e-3),
}


def run_slice(torch, env="arms"):
    """Phases 4 and 15: the port's pretext entry point at full width."""
    from var_tpu_torch.ops import mel_log_dct as mld
    from var_tpu_torch.pretext import main as pretext_main

    prof, run = PROFILES[env], RUN_DIR / env
    argv = [
        "--env", env, "--set",
        f'pretextDataDir=["{run / "data"}"]',
        f'pretextModelSaveDir="{run / "model"}"',
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
    if cfg.pretextTrainBatchSize != 128 or \
            tuple(cfg.sound_dim) != prof["sound"]:
        fail(f"the {env} slice did not run at full width")
    steps = trainer.step
    print(f"slice [{env}]: {steps} training steps, mel_log_dct launches "
          f"{launches['mel_log_dct']}, wall {wall:.2f} s", flush=True)
    if steps < 8 or launches["mel_log_dct"] != 2 * steps:
        fail(f"expected 2 kernel launches per step over >= 8 steps, got "
             f"{launches['mel_log_dct']} over {steps}")
    progress = run / "model" / "progress.csv"
    ckpt = run / "model" / "4" / "checkpoint.pt"
    if not progress.exists() or not ckpt.exists():
        fail("missing progress.csv or checkpoint")
    losses = [float(v) for v in progress.read_text().split()[1:]]
    print(f"slice [{env}]: epoch losses {losses}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"bad epoch losses {losses}: finite and falling expected")
    # epoch 0 holds the first-call set-up (cuDNN plans, allocator growth)
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    RATES[env + " pretext"] = statistics.median(rates)
    print(f"slice [{env}]: triplets/s over epochs 1-{len(rates)}: median "
          f"{statistics.median(rates):.1f} (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); epoch seconds "
          f"{[round(t, 5) for _, t in trainer.epoch_stats]}", flush=True)
    return trainer, launches


def backend_agreement(torch, cfg, rel_tol=1e-4):
    """Phases 5 and 15: one step, same state and batch, 'pallas' vs
    'gemm'."""
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
    if not math.isclose(losses["pallas"], losses["gemm"], rel_tol=rel_tol):
        fail("pallas and gemm losses disagree")
    cfg.override(audioBackend="pallas")
    return trainer, ds, bank


def _profiled_kernels(prof):
    """Device-side kernel events only: the CPU ops that launched them, and
    annotated ranges, carry the same time again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def breakdown(torch, trainer, ds, bank):
    """Phase 6: where one epoch's time goes (torch.profiler): the device's
    busy share of the wall time and the ops with the most device time."""
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
        t0 = time.perf_counter()
        _, n = trainer._run_epoch_indexed(ds, bank, batch, epoch=3)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    steps = -(-n // batch)
    prof_wall_ms /= steps
    kernels = _profiled_kernels(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    # kernels that overlap on several streams (cuDNN's bidirectional RNN)
    # sum to more than the wall, so a share over 100% marks a device-bound
    # step; the profiled epoch's own wall shows it is not tracing overhead
    print(f"breakdown: device kernel time {device_ms:.4f} ms/step "
          f"(profiled epoch), wall {wall_ms:.4f} ms/step (unprofiled "
          f"epoch): device busy {100 * device_ms / wall_ms:.1f}% of wall; "
          f"profiled epoch's wall {prof_wall_ms:.4f} ms/step, busy "
          f"{100 * device_ms / prof_wall_ms:.1f}% of it", flush=True)
    launches = sum(e.count for e in kernels) / steps
    print(f"breakdown: {launches:.1f} kernel launches per step", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        ms = e.self_device_time_total / 1e3 / steps
        print(f"breakdown:   {ms:8.4f} ms/step {100 * ms / device_ms:5.1f}% "
              f"x{e.count // steps:<3d} {e.key[:80]}", flush=True)


RL_UPDATES = 3  # device-sim updates of either profile
# mel_log_dct launches on each path, each counted from 0 just before it
LAUNCHES = {}
# phases 4 and 15's triplets/s, 7's and 11 and 17's env-steps/s, for 25,
# 28 and 34
RATES = {}
# phases 7 and 16's fused_step and env_step p50 ms, for 31; 11 and 17's
# collect and ppo_update p50 ms, for 34
P50 = {}


def _width(cfg):
    return (cfg.RLNumEnvs, cfg.ppoNumSteps, cfg.RLRecurrentSize,
            cfg.RLRecurrentInputSize, cfg.RLActionHiddenSize, cfg.ppoEpoch,
            cfg.ppoNumMiniBatch, tuple(cfg.img_dim), cfg.representationDim)


def _start_policy(torch, cfg):
    """The trainers' start: a fresh policy from RLEnvSeed."""
    from var_tpu_torch.models.policy import build_policy
    from var_tpu_torch.train.rl import device_sim_profile

    return build_policy(cfg, device_sim_profile(cfg)[0]).reset_parameters(
        torch.Generator().manual_seed(int(cfg.RLEnvSeed)))


def rl_train(torch, np, mld, env="arms"):
    """Phases 7 and 16: the port's RL entry point at full width."""
    from var_tpu_torch.rl import main as rl_main
    from var_tpu_torch.train.checkpoint import load_checkpoint

    prof, rl_dir = PROFILES[env], RUN_DIR / env / "rl_model"
    updates, steps = prof["rl_updates"], prof["steps"]
    argv = [
        "--env", env, "--set",
        f'pretextModelLoadDir="{RUN_DIR / env / "model" / "4"}"',
        f'RLModelSaveDir="{rl_dir}"', "RLTrain=True",
        "RLModelFineTune=False", 'vecEnvBackend="dummy"',
        f"RLTotalSteps={updates * 8 * steps}", "RLModelSaveInterval=1",
        "RLLogInterval=1",
    ]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = rl_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mld.mel_log_dct.launches
    LAUNCHES[prof["key"] + "rl train"] = launches
    cfg = trainer.config
    width = _width(cfg)
    print(f"rl train [{env}]: {len(trainer.update_stats)} PPO updates at "
          f"(envs, steps, GRU, GRU input, action hidden, epochs, "
          f"minibatches, image, rep dim) = {width}; mel_log_dct launches "
          f"{launches}; wall {wall:.2f} s", flush=True)
    if width != (8, steps, prof["gru"], 128, 128, 4, 2, (3, 96, 96), 3):
        fail(f"the {env} RL phase did not run at full width")
    if len(trainer.update_stats) != updates or launches != 0:
        fail(f"expected {updates} PPO updates and no mel_log_dct launch "
             f"in RL")
    labels = sorted(p.name for p in rl_dir.iterdir() if p.name.isdigit())
    if labels != [f"{j:05d}" for j in range(updates)]:
        fail(f"expected {updates} checkpoints, found {labels}")
    with open(rl_dir / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows
              for k in ("loss/value_loss", "loss/policy_loss",
                        "loss/policy_entropy")]
    print(f"rl train: progress.csv {len(rows)} rows, losses {losses}",
          flush=True)
    if not rows or not all(math.isfinite(v) for v in losses):
        fail("bad RL losses in progress.csv")
    start = _start_policy(torch, cfg)
    final = load_checkpoint(str(rl_dir / labels[-1]))["params"]
    moved = max((final[k] - v).abs().max().item()
                for k, v in start.state_dict().items())
    print(f"rl train: largest parameter change {moved:.3e}", flush=True)
    if not moved > 0:
        fail("the policy parameters did not change")
    # update 0 holds the first-call set-up (cuDNN plans, allocator growth)
    rates = [n / t for n, t in trainer.update_stats[1:]]
    RATES[env + " rl"] = statistics.median(rates)
    timer = trainer.timer
    P50[env + " rl"] = (timer.p50_ms("fused_step"), timer.p50_ms("env_step"))
    print(f"rl train: env-steps/s over updates 1-{len(rates)}: median "
          f"{statistics.median(rates):.1f} (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); update seconds "
          f"{[round(t, 5) for _, t in trainer.update_stats]}; p50 ms: "
          f"fused_step {timer.p50_ms('fused_step'):.4f}, env_step "
          f"{timer.p50_ms('env_step'):.4f}, ppo_update "
          f"{timer.p50_ms('ppo_update'):.4f}", flush=True)
    return trainer


def rl_eval(torch, trainer, mld, env="arms", tag=""):
    """Phases 8 and 16 (and 31, `tag` 'defaults '): deterministic
    evaluation of the trainer's last checkpoint, 16 episodes: the arm on 8
    envs; the grid on 4 envs, one episode per class each (4 per class)."""
    from var_tpu_torch.train.rl import RLTrainer

    prof = PROFILES[env]
    cfg = copy.deepcopy(trainer.config)
    rl_dir = Path(cfg.RLModelSaveDir)
    cfg.override(RLTrain=False)
    if prof["eval_per_class"]:
        cfg.override(testEpisodesPerClass=prof["eval_per_class"])
    evaluator = RLTrainer(cfg, device="cuda")
    evaluator.load_pretext()
    path = rl_dir / f"{len(trainer.update_stats) - 1:05d}"
    n_envs, n_episodes = prof["eval_envs"], 16
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    rate = evaluator.testRL(num_episodes=n_episodes, policy_path=str(path),
                            num_envs=n_envs)
    wall = time.perf_counter() - t0
    LAUNCHES[prof["key"] + tag + "rl eval"] = mld.mel_log_dct.launches
    with open(rl_dir / f"test_{path.name}.csv") as f:
        rows = list(csv.DictReader(f))
    steps = -(-n_episodes // n_envs) * cfg.RLEnvMaxSteps * n_envs
    print(f"rl eval [{tag}{env}]: {len(rows)} episodes, per class "
          f"{[sum(r['objIdx'] == str(c) for r in rows) for c in range(cfg.taskNum)]}, "
          f"success rate {rate}, "
          f"{steps} env steps in {wall:.3f} s = {steps / wall:.1f} "
          f"env-steps/s (set-up included)", flush=True)
    if len(rows) != n_episodes or not 0.0 <= rate <= 1.0:
        fail("bad RL eval output")


def card_against_cpu_phase(env="arms"):
    """Phases 9 and 18: one fused rollout and one PPO update, card against
    CPU."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.tools.rl_check import card_against_cpu

    cfg = main_config(env=env)
    cfg.override(RLTrain=True, ppoNumSteps=10, RLEnvMaxSteps=5,
                 vecEnvBackend="dummy")
    t0 = time.perf_counter()
    report = card_against_cpu(cfg)
    print(f"card vs cpu [{env}] (8 envs x 10 steps, full width): {report} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    if not report["ok"]:
        fail("the RL step or update differs between the card and the CPU")
    return report


def rl_breakdown(torch, config):
    """Phase 10: where one 100-step rollout and its PPO update spend their
    time (torch.profiler), beside their unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    from var_tpu_torch.train.rl import RLTrainer

    cfg = copy.deepcopy(config)
    cfg.override(RLModelSaveDir=str(RUN_DIR / "rl_profile"))  # arm only
    trainer = RLTrainer(cfg, device="cuda")
    trainer.load_pretext()
    envs, engine, action = trainer.setup_fused()
    T = engine.T
    walls = {"rollout": [], "update": []}
    for _ in range(3):  # the first is warm-up
        t0 = time.perf_counter()
        action = trainer.rollout(envs, engine, action)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.update(engine)
        torch.cuda.synchronize()
        walls["rollout"].append((t1 - t0) * 1e3)
        walls["update"].append((time.perf_counter() - t1) * 1e3)
    gae = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.compute_returns(cfg.ppoUseGAE, cfg.RLGamma, cfg.ppoGAELambda,
                               cfg.RLUseProperTimeLimits)
        torch.cuda.synchronize()
        gae.append((time.perf_counter() - t0) * 1e3)
    print(f"rl breakdown: unprofiled wall ms, rollout of {T} steps "
          f"{[round(w, 3) for w in walls['rollout'][1:]]}, PPO update (GAE "
          f"included) {[round(w, 3) for w in walls['update'][1:]]}; GAE "
          f"alone {statistics.median(gae):.4f} ms", flush=True)

    profiled = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        action = trainer.rollout(envs, engine, action)
        torch.cuda.synchronize()
    profiled["rollout"] = _profiled_kernels(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.update(engine)
        torch.cuda.synchronize()
    profiled["update"] = _profiled_kernels(prof)
    envs.close()
    if not all(profiled.values()):
        fail("torch.profiler recorded no device kernel")
    total_dev = 0.0
    for part, per in (("rollout", T), ("update", 1)):
        ks = profiled[part]
        dev_ms = sum(e.self_device_time_total for e in ks) / 1e3
        total_dev += dev_ms
        wall = statistics.median(walls[part][1:])
        unit = "env step" if part == "rollout" else "PPO update"
        print(f"rl breakdown: {part}: {sum(e.count for e in ks) / per:.1f} "
              f"kernel launches per {unit}; device kernel time "
              f"{dev_ms / per:.4f} ms per {unit}; busy "
              f"{100 * dev_ms / wall:.1f}% of its unprofiled wall", flush=True)
    wall = statistics.median(walls["rollout"][1:]) + statistics.median(
        walls["update"][1:])
    print(f"rl breakdown: rollout + update: device busy "
          f"{100 * total_dev / wall:.1f}% of {wall:.3f} ms wall", flush=True)
    merged = {}
    for ks in profiled.values():
        for e in ks:
            t, n = merged.get(e.key, (0.0, 0))
            merged[e.key] = (t + e.self_device_time_total / 1e3, n + e.count)
    top = sorted(merged.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (ms, n) in top:
        print(f"rl breakdown:   {ms:9.4f} ms {100 * ms / total_dev:5.1f}% "
              f"x{n:<6d} {name[:90]}", flush=True)


# the E2E recipes' RLNumEnvs (E2E_r05.json profiles.arms and
# profiles.ai2thor both run 64)
DS_ENVS = 64
DS_EPISODES = 1024  # the E2E device-eval episode count


def devsim_train(torch, np, mld, env="arms"):
    """Phases 11 and 17: device-sim training through the RL entry point at
    full width with 64 envs."""
    from var_tpu_torch.rl import main as rl_main
    from var_tpu_torch.train.checkpoint import load_checkpoint

    prof, ds_dir = PROFILES[env], RUN_DIR / env / "rl_devsim"
    key = prof["key"] + "device-sim train"
    argv = [
        "--env", env, "--set",
        f'pretextModelLoadDir="{RUN_DIR / env / "model" / "4"}"',
        f'RLModelSaveDir="{ds_dir}"', "RLTrain=True", "RLModelFineTune=False",
        "RLDeviceSimRollout=True", f"RLNumEnvs={DS_ENVS}",
        f"RLTotalSteps={RL_UPDATES * DS_ENVS * prof['steps']}",
        "RLModelSaveInterval=1", "RLLogInterval=1",
    ]
    torch.cuda.reset_peak_memory_stats()
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = rl_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    LAUNCHES[key] = mld.mel_log_dct.launches
    peak = torch.cuda.max_memory_allocated()
    cfg = trainer.config
    width = _width(cfg)
    print(f"device-sim train [{env}]: {len(trainer.update_stats)} PPO "
          f"updates at (envs, steps, GRU, GRU input, action hidden, epochs, "
          f"minibatches, image, rep dim) = {width}; mel_log_dct launches "
          f"{LAUNCHES[key]}; wall {wall:.2f} s; peak device "
          f"memory {peak / 2 ** 30:.3f} GiB ({peak} bytes)", flush=True)
    if width != (DS_ENVS, prof["steps"], prof["gru"], 128, 128, 4, 2,
                 (3, 96, 96), 3):
        fail(f"the {env} device-sim phase did not run at full width")
    if len(trainer.update_stats) != RL_UPDATES or LAUNCHES[key] != 0:
        fail("expected 3 PPO updates and no mel_log_dct launch")
    labels = sorted(p.name for p in ds_dir.iterdir() if p.name.isdigit())
    if labels != [f"{j:05d}" for j in range(RL_UPDATES)]:
        fail(f"expected {RL_UPDATES} checkpoints, found {labels}")
    with open(ds_dir / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows
              for k in ("loss/value_loss", "loss/policy_loss",
                        "loss/policy_entropy")]
    print(f"device-sim train: progress.csv {len(rows)} rows, losses {losses}",
          flush=True)
    if len(rows) != RL_UPDATES or not all(math.isfinite(v) for v in losses):
        fail("bad device-sim losses in progress.csv")
    start = _start_policy(torch, cfg)
    final = load_checkpoint(str(ds_dir / labels[-1]))["params"]
    moved = max((final[k] - v).abs().max().item()
                for k, v in start.state_dict().items())
    print(f"device-sim train: largest parameter change {moved:.3e}",
          flush=True)
    if not moved > 0:
        fail("the policy parameters did not change")
    # update 0 holds the first-call set-up (cuDNN plans, allocator growth)
    rates = [n / t for n, t in trainer.update_stats[1:]]
    timer = trainer.timer
    RATES[env + " devsim"] = statistics.median(rates)
    P50[env + " devsim"] = (timer.p50_ms("collect"),
                            timer.p50_ms("ppo_update"))
    print(f"device-sim train [{env}]: env-steps/s over updates "
          f"1-{len(rates)}: "
          f"median {statistics.median(rates):.1f} (min {min(rates):.1f}, max "
          f"{max(rates):.1f}); update seconds "
          f"{[round(t, 5) for _, t in trainer.update_stats]}; p50 ms: "
          f"collect (dispatch) {timer.p50_ms('collect'):.4f}, ppo_update "
          f"(to the read) {timer.p50_ms('ppo_update'):.4f}", flush=True)
    return trainer


def devsim_eval(torch, trainer, mld, env="arms"):
    """Phases 12 and 17: device-sim evaluation of the last checkpoint."""
    from var_tpu_torch.train.rl import RLTrainer

    ds_dir = RUN_DIR / env / "rl_devsim"
    key = PROFILES[env]["key"] + "device-sim eval"
    cfg = copy.deepcopy(trainer.config)
    cfg.override(RLTrain=False, RLDeviceSimEval=True)
    path = ds_dir / f"{RL_UPDATES - 1:05d}"
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    evaluator = RLTrainer(cfg, device="cuda")
    evaluator.load_pretext()
    rate = evaluator.testRL(num_episodes=DS_EPISODES, policy_path=str(path),
                            num_envs=DS_ENVS)
    wall = time.perf_counter() - t0
    LAUNCHES[key] = mld.mel_log_dct.launches
    with open(ds_dir / f"test_{path.name}_devicesim.csv") as f:
        rows = list(csv.DictReader(f))
    steps = DS_EPISODES * cfg.RLEnvMaxSteps
    print(f"device-sim eval [{env}]: {len(rows)} episodes, success rate "
          f"{rate}, {DS_EPISODES / wall:.1f} episodes/s, {steps / wall:.1f} "
          f"env-steps/s ({wall:.3f} s, set-up included); mel_log_dct "
          f"launches {LAUNCHES[key]}", flush=True)
    if len(rows) != DS_EPISODES or not 0.0 <= rate <= 1.0 \
            or LAUNCHES[key] != 0:
        fail("bad device-sim eval output")


def devsim_card_against_cpu(env="arms"):
    """Phases 13 and 18: the device sim on the card against the CPU."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.tools.rl_check import (device_sim_card_against_cpu,
                                              render_card_against_host)

    cfg = main_config(env=env)
    cfg.override(RLTrain=True, ppoNumSteps=10, RLEnvMaxSteps=10, RLNumEnvs=8)
    t0 = time.perf_counter()
    report = device_sim_card_against_cpu(cfg)
    print(f"device sim [{env}], card vs cpu (8 envs x 10 steps, full "
          f"width): {report} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    render = render_card_against_host(cfg, n=1000)
    print(f"device sim [{env}], render on the card vs the host sim: "
          f"{render} in {time.perf_counter() - t0:.2f} s", flush=True)
    if not (report["ok"] and render["ok"]):
        fail("the device sim differs between the card and the CPU")
    return report


def _gaps(report):
    """A check report's errors (in units of their tolerances) and its
    parameter gap, for phase 18's benchmark line."""
    skip = ("ok", "metrics_card", "metrics_cpu", "param_atol",
            "param_median_bound", "loss_card", "loss_cpu")
    return {k: v for k, v in report.items() if k not in skip}


def benchmark_hold(off):
    """Phase 18, last: the grid's checks at float32, full width, with
    torch.backends.cudnn.benchmark on (tools/e2e_run.py's runs may set
    it), each after a throwaway pass on copies of the card's side so that
    cuDNN has timed and chosen: the fused step and update and the device
    sim (8 envs x 10 steps), and one CRNN pretext step at batch 128
    (sound 1x600x40, through the kernel), the last also with the flag
    off. `off` holds the fused and device-sim reports of this phase with
    the flag off; every gap is printed beside its twin and held to the
    same tolerances."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.tools.rl_check import (card_against_cpu,
                                              device_sim_card_against_cpu,
                                              pretext_card_against_cpu)

    def cfg(**knobs):
        c = main_config(env="ai2thor")
        c.override(**knobs)
        return c

    t0 = time.perf_counter()
    on = {
        "fused": card_against_cpu(cfg(
            RLTrain=True, ppoNumSteps=10, RLEnvMaxSteps=5,
            vecEnvBackend="dummy"), cudnn_benchmark=True),
        "device sim": device_sim_card_against_cpu(cfg(
            RLTrain=True, ppoNumSteps=10, RLEnvMaxSteps=10, RLNumEnvs=8),
            cudnn_benchmark=True)}
    pretext = cfg(audioBackend="pallas")
    off = dict(off, pretext=pretext_card_against_cpu(pretext))
    on["pretext"] = pretext_card_against_cpu(pretext, cudnn_benchmark=True)
    for name in on:
        print(f"cudnn.benchmark [ai2thor {name}], card vs cpu: off "
              f"{_gaps(off[name])}; on {_gaps(on[name])}", flush=True)
    print(f"cudnn.benchmark hold in {time.perf_counter() - t0:.2f} s",
          flush=True)
    bad = [name for name in on if not (on[name]["ok"] and off[name]["ok"])]
    if bad:
        fail(f"with cudnn.benchmark on, the card differs from the CPU: {bad}")


def devsim_breakdown(torch, config):
    """Phases 14 and 19: where one device-sim collect and its PPO update
    spend their time (torch.profiler), beside their unprofiled wall
    times."""
    from torch.profiler import ProfilerActivity, profile

    from var_tpu_torch.rl.device_sim import init_rms
    from var_tpu_torch.train.rl import RLTrainer

    cfg = copy.deepcopy(config)
    trainer = RLTrainer(cfg, device="cuda")
    trainer.load_pretext()
    engine = trainer.setup_device_sim()
    T = engine.T
    rms = init_rms(engine.N, "cuda")

    def update(batch):
        state, metrics = trainer.ppo.update(
            trainer.state, batch, trainer.ppo.draw_perms(batch,
                                                         trainer.generator))
        trainer.state = state
        return torch.stack(list(metrics.values())).tolist()

    walls = {"collect": [], "update": []}
    for _ in range(3):  # the first is warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rms, batch, _ = engine.collect(rms)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        update(batch)
        walls["collect"].append((t1 - t0) * 1e3)
        walls["update"].append((time.perf_counter() - t1) * 1e3)
    print(f"device-sim breakdown: unprofiled wall ms, collect of {T} steps x "
          f"{engine.N} envs (GAE included) "
          f"{[round(w, 3) for w in walls['collect'][1:]]}, PPO update "
          f"{[round(w, 3) for w in walls['update'][1:]]}", flush=True)
    profiled = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rms, batch, _ = engine.collect(rms)
        torch.cuda.synchronize()
    profiled["collect"] = _profiled_kernels(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        update(batch)
    profiled["update"] = _profiled_kernels(prof)
    if not all(profiled.values()):
        fail("torch.profiler recorded no device kernel")
    total_dev = 0.0
    for part, per in (("collect", T), ("update", 1)):
        ks = profiled[part]
        dev_ms = sum(e.self_device_time_total for e in ks) / 1e3
        total_dev += dev_ms
        wall = statistics.median(walls[part][1:])
        unit = "env step" if part == "collect" else "PPO update"
        print(f"device-sim breakdown: {part}: "
              f"{sum(e.count for e in ks) / per:.1f} kernel launches per "
              f"{unit}; device kernel time {dev_ms / per:.4f} ms per {unit}; "
              f"busy {100 * dev_ms / wall:.1f}% of its unprofiled wall",
              flush=True)
    wall = statistics.median(walls["collect"][1:]) + statistics.median(
        walls["update"][1:])
    print(f"device-sim breakdown: collect + update: device busy "
          f"{100 * total_dev / wall:.1f}% of {wall:.3f} ms wall; the update "
          f"is {100 * statistics.median(walls['update'][1:]) / wall:.1f}% of "
          f"the cycle", flush=True)
    merged = {}
    for ks in profiled.values():
        for e in ks:
            t, n = merged.get(e.key, (0.0, 0))
            merged[e.key] = (t + e.self_device_time_total / 1e3, n + e.count)
    for name, (ms, n) in sorted(merged.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"device-sim breakdown:   {ms:9.4f} ms "
              f"{100 * ms / total_dev:5.1f}% x{n:<6d} {name[:90]}", flush=True)


def run_profile(torch, np, mld, env, kernel):
    """Phases 4-14 (arm) or 15-19 (ai2thor), then frees the device memory
    they held."""
    prof = PROFILES[env]
    trainer, launches = run_slice(torch, env)
    LAUNCHES[prof["key"] + "pretext"] = launches[kernel["name"]]
    if env == "arms":
        kernel["launches"] = launches[kernel["name"]]
    breakdown(torch, *backend_agreement(torch, trainer.config,
                                        prof["pretext_rel_tol"]))

    rl_trainer = rl_train(torch, np, mld, env)
    rl_eval(torch, rl_trainer, mld, env)
    fused = card_against_cpu_phase(env)
    if env == "arms":  # the grid's profile is of its device-sim cycle
        rl_breakdown(torch, rl_trainer.config)

    ds_trainer = devsim_train(torch, np, mld, env)
    devsim_eval(torch, ds_trainer, mld, env)
    devsim = devsim_card_against_cpu(env)
    if env == "ai2thor":
        benchmark_hold({"fused": fused, "device sim": devsim})
    devsim_breakdown(torch, ds_trainer.config)
    del trainer, rl_trainer, ds_trainer
    gc.collect()
    torch.cuda.empty_cache()


ARM_VAR = RUN_DIR / "arms" / "model" / "4"  # phase 4's VAR


def legs_phase(torch, mld):
    """Phase 20: a run of 3 device-sim updates in two legs (2 + 1)."""
    from var_tpu_torch.rl.ppo import PPO, PPOConfig
    from var_tpu_torch.tools import e2e_run
    from var_tpu_torch.train.checkpoint import load_checkpoint

    work = RUN_DIR / "legs"
    shutil.copytree(ARM_VAR, work / "var_model" / "4")
    per_update = DS_ENVS * PROFILES["arms"]["steps"]
    steps = []  # (leg, count, lr) of every optimizer step
    starts = {}  # leg -> the state entering its first optimizer step
    apply_adam = PPO._apply_adam

    def spy(self, state, grads):
        leg = len(results) + 1
        if leg not in starts:
            starts[leg] = (
                state.opt_state.count,
                {k: v.detach().cpu().clone() for k, v in
                 state.params.items()},
                {k: v.cpu().clone() for k, v in state.opt_state.mu.items()},
                {k: v.cpu().clone() for k, v in state.opt_state.nu.items()})
        steps.append((leg, state.opt_state.count,
                      self.lr_at(state.opt_state.count)))
        return apply_adam(self, state, grads)

    results = []
    argv = [str(work), "--device-sim", "--num-envs", str(DS_ENVS),
            "--rl-steps", str(3 * per_update), "--var-epochs", "5",
            "--stages", "rl", "--out", str(work / "e2e.json"), "--set",
            "RLModelSaveInterval=1", "RLLrDecay='linear'"]
    PPO._apply_adam = spy
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    try:
        for leg_updates in (2, 1):
            results.append(e2e_run.main(
                argv + ["--leg-steps", str(leg_updates * per_update)]))
    finally:
        PPO._apply_adam = apply_adam
    wall = time.perf_counter() - t0
    LAUNCHES["arms legs"] = mld.mel_log_dct.launches
    rl_dir = work / "rl_model"
    labels = sorted(p.name for p in rl_dir.iterdir() if p.name.isdigit())
    legs = [r["leg"] for r in results]
    print(f"legs: {legs}; labels {labels}; {len(steps)} optimizer steps, "
          f"LR {steps[0][2]:.6g} -> {steps[-1][2]:.6g}; mel_log_dct "
          f"launches {LAUNCHES['arms legs']}; wall {wall:.2f} s", flush=True)
    if [(g["updates_done"], g["done"]) for g in legs] != [(2, False),
                                                          (3, True)] \
            or labels != ["00000", "00001", "00002"] \
            or not (rl_dir / e2e_run.DONE_MARKER).exists() \
            or LAUNCHES["arms legs"] != 0:
        fail("the legs did not continue the run")
    cfg = e2e_run.build_config("arms", str(work), 3 * per_update,
                               num_envs=DS_ENVS, var_epochs=5,
                               device_sim=True, extra_set=argv[-2:])
    whole = PPO(None, PPOConfig.from_config(cfg))
    if [c for _, c, _ in steps] != list(range(len(steps))) \
            or any(lr != whole.lr_at(c) for _, c, lr in steps) \
            or not steps[-1][2] < steps[0][2]:
        fail("the legs' LR is not the unsplit run's")
    end1 = load_checkpoint(str(rl_dir / "00001"))
    count, params, mu, nu = starts[2]
    same = (count == end1["opt_state"]["count"] and all(
        torch.equal(params[k], v) and torch.equal(
            mu[k], end1["opt_state"]["mu"][k]) and torch.equal(
            nu[k], end1["opt_state"]["nu"][k])
        for k, v in end1["params"].items()))
    print(f"legs: leg 2 starts at optimizer step {count} from leg 1's last "
          f"parameters and moments: {same}", flush=True)
    if not same:
        fail("leg 2 did not start from leg 1's last state")
    return work


def sweep_phase(torch, mld, work):
    """Phase 21: the checkpoint sweep and selection over phase 20's run."""
    from var_tpu_torch.tools import e2e_run

    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    sel = e2e_run.select_checkpoint(
        "arms", str(work), 256, 128, 1,
        ["RLModelSaveInterval=1", "RLLrDecay='linear'"], "cuda")
    wall = time.perf_counter() - t0
    LAUNCHES["arms sweep"] = mld.mel_log_dct.launches
    with open(sel["curve_csv"]) as f:
        text = f.read()
    rows = list(csv.DictReader(text.splitlines()))
    print(f"sweep: {len(rows)} checkpoints x {sel['episodes_per_point']} "
          f"episodes in {wall:.2f} s; curve CSV:\n{text.strip()}", flush=True)
    if len(rows) != 3 or sel["episodes_per_point"] != 1024 \
            or list(rows[0]) != ["checkpoint", "update", "env_steps",
                                 "success_rate", "ci95", "class_0",
                                 "class_1", "class_2", "class_3"] \
            or not (work / "rl_model" / "best").is_symlink() \
            or LAUNCHES["arms sweep"] != 0:
        fail("bad sweep output")


def self_improve_phase(torch, mld, work):
    """Phase 22: one scratch self-improvement round at full arm width, the
    VAR retrain through the CUDA kernel, held against its plain version on
    the path's own input."""
    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.train import pretext as tpretext
    from var_tpu_torch.train.checkpoint import latest_checkpoint
    from var_tpu_torch.train.self_improve import self_improve

    run = RUN_DIR / "self_improve"
    shutil.copytree(work / "rl_model", run / "rl_model", symlinks=True)
    cfg = main_config(env="arms")
    cfg.override(
        pretextDataDir=[str(run / "data")],
        pretextModelSaveDir=str(run / "var_model"),
        pretextModelLoadDir=str(ARM_VAR), RLModelSaveDir=str(run / "rl_model"),
        audioBackend="pallas", pretextDataset="VARDataset",
        pretextModelFineTune=False, vecEnvBackend="dummy",
        pretextCollectNum=[64, 64, 64, 64, 128], pretextModelSaveInterval=1,
        RLDeviceSimRollout=True, RLNumEnvs=DS_ENVS, RLModelSaveInterval=1)
    gym_register(cfg, env="arms")
    from var_tpu_torch.ops import audio

    kernel, trainers, seen = mld.mel_log_dct, [], []
    stft, train_rep = (audio._stft_power_gemm,
                       tpretext.PretextTrainer.trainRepresentation)

    def capture(wav, params, *args):
        # the power spectrogram the path hands the kernel first
        power = stft(wav, params, *args)
        if not seen:
            seen.append((power.detach().clone(), params))
        return power

    def keep(self, *args, **kwargs):
        trainers.append(self)
        return train_rep(self, *args, **kwargs)

    audio._stft_power_gemm = capture
    tpretext.PretextTrainer.trainRepresentation = keep
    kernel.launches = 0
    t0 = time.perf_counter()
    try:
        self_improve(cfg, rounds=1, env="arms", pretext_epochs=2,
                     rl_steps=DS_ENVS * PROFILES["arms"]["steps"],
                     var_mode="scratch", device="cuda")
        torch.cuda.synchronize()
    finally:
        audio._stft_power_gemm = stft
        tpretext.PretextTrainer.trainRepresentation = train_rep
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms self-improve"] = kernel.launches
    var_steps = trainers[0].step
    newest = latest_checkpoint(str(run / "rl_model"))
    print(f"self-improve: {var_steps} VAR steps at batch "
          f"{cfg.pretextTrainBatchSize}, mel_log_dct launches {launches}; "
          f"RL load target {cfg.pretextModelLoadDir}; newest policy "
          f"{newest}; wall {wall:.2f} s", flush=True)
    if var_steps < 4 or launches != 2 * var_steps \
            or cfg.pretextModelLoadDir != str(run / "var_model" / "1") \
            or not newest.endswith("00003") \
            or cfg.pretextTrainBatchSize != 128:
        fail("the self-improvement round did not run as expected")
    power, params = seen[0]
    with torch.no_grad():
        got = kernel(power, params)
        want = mld.mel_log_dct_reference(power, params)
    err = (got - want).abs().max().item()
    print(f"self-improve: the kernel on the path's input "
          f"{tuple(power.shape)} (stride {power.stride()}): max abs err "
          f"{err:.3e} against the plain version", flush=True)
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail("the kernel disagrees with its plain version on the "
             "self-improvement path")


def wrapped_phase(torch, mld):
    """Phase 23: the reward-wrapper path, train, eval, card against CPU."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.rl import main as rl_main
    from var_tpu_torch.tools.rl_check import wrapped_card_against_cpu

    rl_dir, steps = RUN_DIR / "wrapped", PROFILES["arms"]["steps"]
    common = [f'pretextModelLoadDir="{ARM_VAR}"', f'RLModelSaveDir="{rl_dir}"',
              'vecEnvBackend="dummy"', "fusedRollout=False",
              "RLModelFineTune=False"]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = rl_main(["--env", "arms", "--set", *common, "RLTrain=True",
                       f"RLTotalSteps={2 * 8 * steps}",
                       "RLModelSaveInterval=1", "RLLogInterval=1"])
    wall = time.perf_counter() - t0
    cfg = trainer.config
    with open(rl_dir / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows
              for k in ("loss/value_loss", "loss/policy_loss",
                        "loss/policy_entropy")]
    rates = [n / t for n, t in trainer.update_stats]
    print(f"wrapped train: {len(trainer.update_stats)} PPO updates at "
          f"{_width(cfg)}; env-steps/s {[round(r, 1) for r in rates]}; "
          f"losses {losses}; p50 ms: policy_act "
          f"{trainer.timer.p50_ms('policy_act'):.4f}, env_step "
          f"{trainer.timer.p50_ms('env_step'):.4f}, ppo_update "
          f"{trainer.timer.p50_ms('ppo_update'):.4f}; wall {wall:.2f} s",
          flush=True)
    if _width(cfg) != (8, steps, 512, 128, 128, 4, 2, (3, 96, 96), 3) \
            or len(trainer.update_stats) != 2 or len(rows) != 2 \
            or not all(math.isfinite(v) for v in losses):
        fail("the wrapped RL phase did not run at full width")
    eval_cfg = copy.deepcopy(cfg)
    eval_cfg.override(RLTrain=False)
    from var_tpu_torch.train.rl import RLTrainer

    evaluator = RLTrainer(eval_cfg, device="cuda")
    evaluator.load_pretext()
    rate = evaluator.testRL(num_episodes=16, policy_path=str(rl_dir / "00001"),
                            num_envs=8)
    LAUNCHES["arms wrapped"] = mld.mel_log_dct.launches
    with open(rl_dir / "test_00001.csv") as f:
        n_eval = len(list(csv.DictReader(f)))
    print(f"wrapped eval: {n_eval} episodes, success rate {rate}; "
          f"mel_log_dct launches {LAUNCHES['arms wrapped']}", flush=True)
    if n_eval != 16 or not 0.0 <= rate <= 1.0 \
            or LAUNCHES["arms wrapped"] != 0:
        fail("bad wrapped eval output")
    check = main_config(env="arms")
    check.override(RLTrain=True, ppoNumSteps=10, RLEnvMaxSteps=5,
                   vecEnvBackend="dummy", fusedRollout=False)
    t0 = time.perf_counter()
    report = wrapped_card_against_cpu(check)
    print(f"wrapped, card vs cpu (8 envs x 10 steps, full width): {report} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    if not report["ok"]:
        fail("the wrapped path differs between the card and the CPU")


def slice6_phases(torch, mld):
    """Phases 20-23."""
    work = legs_phase(torch, mld)
    sweep_phase(torch, mld, work)
    self_improve_phase(torch, mld, work)
    wrapped_phase(torch, mld)
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 24-28: pretext's other paths and the pipelined rollout -------------

ARM_DATA = RUN_DIR / "arms" / "data"  # phase 4's 768 triplets


def _pretext_config(run, **knobs):
    """The arm pretext at full width under `run`, phase 4's knobs."""
    from var_tpu_torch.config import gym_register, main_config

    cfg = main_config(env="arms")
    cfg.override(**{**dict(
        pretextDataDir=[str(run / "data")],
        pretextModelSaveDir=str(run / "model"), audioBackend="pallas",
        pretextModelFineTune=False, pretextDataset="VARDataset",
        vecEnvBackend="dummy", pretextCollectNum=[128, 128, 128, 128, 256],
        pretextEpoch=3, pretextModelSaveInterval=3), **knobs})
    gym_register(cfg, env="arms")
    return cfg


def mix_store(cfg):
    """The 'mix' preset's store without its corpora: the synthetic source
    (bank 0, n_fft 512) and, in the preset's class layout (UrbanSound
    sizes [25, 0, 0, 25]), synthetic UrbanSound clips (bank 1, n_fft 1024),
    as tests/test_hetero_bank.py builds its store."""
    import numpy as np

    from var_tpu_torch.data.audio_store import AudioStore, synth_clip

    audio = AudioStore(cfg)
    audio.loadData()
    rng = np.random.RandomState(7)
    for i, n in enumerate(cfg.soundSource["size"]["UrbanSound"]):
        if n:
            audio.words[i]["UrbanSound"] = [synth_clip(i, rng)
                                            for _ in range(n)]
    return audio


def _capture_stft(audio, into):
    """Wraps the gemm STFT, which precedes every kernel launch of the
    pallas backend: keeps each output's shape and the first output per
    bin count. Returns the undo."""
    stft = audio._stft_power_gemm

    def capture(wav, params, *args):
        power = stft(wav, params, *args)
        into.setdefault("shapes", []).append(tuple(power.shape))
        into.setdefault(power.shape[-1], (power.detach().clone(), params))
        return power

    audio._stft_power_gemm = capture
    return lambda: setattr(audio, "_stft_power_gemm", stft)


def mix_phase(torch, np, mld, kernel, bw, flops):
    """Phase 24: the 'mix' preset through the multi-bank path."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.train.pretext import PretextTrainer

    run = RUN_DIR / "mix"
    cfg = _pretext_config(run, soundSourcePreset="mix")
    store = mix_store(cfg)
    trainer = PretextTrainer(cfg, device="cuda", audio=store)
    seen = {}
    undo = _capture_stft(audio, seen)
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    try:
        trainer.run()
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms mix pretext"] = mld.mel_log_dct.launches
    steps = trainer.step
    by_f = {F: sum(sh[-1] == F for sh in seen["shapes"]) for F in (257, 513)}
    losses = [float(v) for v in
              (run / "model" / "progress.csv").read_text().split()[1:]]
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    print(f"mix: {steps} steps at batch {cfg.pretextTrainBatchSize}, "
          f"STFT param sets {[tuple(p) for p in store.param_sets()]}; "
          f"mel_log_dct launches {launches}, by bins {by_f}, shapes "
          f"{sorted(set(seen['shapes']))}; losses {losses}; triplets/s over "
          f"epochs 1-2 {[round(r, 1) for r in rates]}; wall {wall:.2f} s",
          flush=True)
    if steps != 18 or launches != 4 * steps \
            or by_f != {257: 2 * steps, 513: 2 * steps} \
            or set(seen["shapes"]) != {(128, 101, 257), (128, 101, 513)} \
            or len(losses) != 3 or not all(map(math.isfinite, losses)):
        fail("the mix preset did not run 4 launches a step on two banks")

    power, params = seen[513]
    with torch.no_grad():
        got = mld.mel_log_dct(power, params)
        want = mld.mel_log_dct_reference(power, params)
        err = (got - want).abs().max().item()
        print(f"mix: the kernel on the path's first F=513 input "
              f"{tuple(power.shape)} (stride {power.stride()}): max abs err "
              f"{err:.3e}", flush=True)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail("the kernel disagrees with its plain version at F=513")
        fn = functools.partial(mld.mel_log_dct, params=params)
        ref = functools.partial(mld.mel_log_dct_reference, params=params)
        cold, warm = cold_warm(torch, fn, power)
        pcold, pwarm = cold_warm(torch, ref, power)
    print(f"time mix {tuple(power.shape)} stft view: cold {fmt(cold)}; warm "
          f"{fmt(warm)}; plain cold {fmt(pcold)}, warm {fmt(pwarm)}",
          flush=True)
    bound, bound_by = mld_bound(np, audio, params, list(power.shape), bw,
                                flops, cold[0])
    kernel["by_shape"].append(dict(
        case="mix n_fft 1024", shape=list(power.shape), ms=cold[0],
        warm_ms=warm[0], plain_ms=pcold[0], bound_ms=bound,
        bound_by=bound_by, library_ms=None, launches=by_f[513],
        max_abs_err=err))
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)

    # one step from one state and batch, 'pallas' against 'gemm'
    from var_tpu_torch.data.triplets import load_env_data

    ds = load_env_data(cfg, store)
    bank = trainer._upload_dataset(ds)
    idx = ds.epoch_order(0)[:cfg.pretextTrainBatchSize]
    pos, neg = ds.epoch_clip_ids_multi(bank["entries"], 2, 0)
    batch = [torch.from_numpy(idx.astype("int64")).cuda()] + [
        torch.from_numpy(a[idx].astype("int64") if a.dtype != bool
                         else a[idx]).cuda() for a in (*pos, *neg)]
    trainer.init_model(seed=cfg.pretextEnvSeed)
    init_state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    loss = {}
    for backend in ("pallas", "gemm"):
        cfg.override(audioBackend=backend)
        trainer.model.load_state_dict(init_state)
        trainer.setup_optimizer(steps_per_epoch=1)
        loss[backend] = trainer._train_step_multi(bank, *batch).item()
    print(f"mix: one step's loss pallas {loss['pallas']!r} gemm "
          f"{loss['gemm']!r}", flush=True)
    if not math.isclose(loss["pallas"], loss["gemm"], rel_tol=1e-4):
        fail("the mix step's pallas and gemm losses disagree")


def chunked_phase(torch, mld):
    """Phase 25: the chunked path on phase 4's data."""
    from var_tpu_torch.data.triplets import load_env_data
    from var_tpu_torch.train.pretext import PretextTrainer

    run = RUN_DIR / "chunked"
    cfg = _pretext_config(run, pretextDataDir=[str(ARM_DATA)])

    def trainer_from_var():
        t = PretextTrainer(cfg, device="cuda")
        t.loadPretextModel(str(ARM_VAR))
        return t

    # one chunk of all 768 items against the resident epoch, same weights
    resident = trainer_from_var()
    ds = load_env_data(cfg, resident._ensure_audio())
    want = resident.trainRepresentation(epoch=1, dataset=ds, log_csv=False)
    one = trainer_from_var()
    upload = one._upload_dataset

    def one_chunk(d):
        b = upload(d)
        return {"chunked": True, "wav": b["wav"], "len": b["len"],
                "ranges": b["ranges"], "chunk_bytes": d.images.nbytes}

    one._upload_dataset = one_chunk
    got = one.trainRepresentation(
        epoch=1, dataset=load_env_data(cfg, one._ensure_audio()),
        log_csv=False)
    print(f"chunked: one chunk {got} against resident {want}", flush=True)
    if not all(math.isclose(g, w, rel_tol=1e-5) for g, w in zip(got, want)):
        fail("a one-chunk epoch differs from the resident epoch")

    # a budget that leaves a third of the items a slab (256 at full
    # width: 2 steps), so 3 slabs an epoch
    B = cfg.pretextTrainBatchSize
    bank_bytes = resident.audio.build_clip_bank()[0].nbytes
    item = int(ds.images[0].nbytes)
    cfg.pretextHBMBudgetMB = math.ceil(
        (bank_bytes + 2 * (len(ds) // 3 // B * B) * item) / 2 ** 20)
    trainer = trainer_from_var()
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    losses = trainer.trainRepresentation(epoch=3, log_csv=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms chunked"] = mld.mel_log_dct.launches
    bank = trainer._upload_dataset(ds)
    if not bank.get("chunked"):
        fail(f"a budget of {cfg.pretextHBMBudgetMB} MiB kept the images "
             "resident")
    slab = bank["chunk_bytes"] // item // B * B
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    print(f"chunked: budget {cfg.pretextHBMBudgetMB} MiB, {slab} items a "
          f"slab, {trainer.step} steps, mel_log_dct launches {launches}; "
          f"losses {losses}; triplets/s over epochs 1-2 "
          f"{[round(r, 1) for r in rates]} against phase 4's resident "
          f"median {RATES['arms pretext']:.1f}; wall {wall:.2f} s",
          flush=True)
    if -(-len(ds) // slab) < 3 or launches != 2 * trainer.step \
            or not all(map(math.isfinite, losses)):
        fail("the chunked path did not run 3 chunks at 2 launches a step")


def streaming_phase(torch, mld):
    """Phase 26: the streaming path over shards with features."""
    from var_tpu_torch.pretext import main as pretext_main

    run = RUN_DIR / "streaming"
    calls = []
    from var_tpu_torch.train import pretext as tpretext

    feat = tpretext.PretextTrainer._train_step_feat

    def spy(self, *a):
        calls.append(1)
        return feat(self, *a)

    tpretext.PretextTrainer._train_step_feat = spy
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = pretext_main([
            "--env", "arms", "--set", f'pretextDataDir=["{run / "data"}"]',
            f'pretextModelSaveDir="{run / "model"}"', 'audioBackend="pallas"',
            "pretextModelFineTune=False", 'pretextDataset="VARDataset"',
            'vecEnvBackend="dummy"', "pretextDataHasSound=True",
            "pretextCollectNum=[128,128,128,128,256]", "pretextEpoch=3",
            "pretextModelSaveInterval=3"])
        torch.cuda.synchronize()
    finally:
        tpretext.PretextTrainer._train_step_feat = feat
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms streaming"] = mld.mel_log_dct.launches
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    losses = [float(v) for v in
              (run / "model" / "progress.csv").read_text().split()[1:]]
    print(f"streaming: {len(calls)} feature steps, mel_log_dct launches "
          f"{launches}; losses {losses}; triplets/s over epochs 1-2 "
          f"{[round(r, 1) for r in rates]}; wall {wall:.2f} s (collection "
          f"with host MFCC included)", flush=True)
    if len(calls) != 18 or launches != 0 or trainer.step != 18 \
            or not all(map(math.isfinite, losses)):
        fail("the streaming path did not run its feature steps")


def representation_phase(torch, mld):
    """Phase 27: testRepresentation on phase 4's VAR."""
    import numpy as np

    from var_tpu_torch.data.triplets import load_shard
    from var_tpu_torch.train.pretext import PretextTrainer

    run = RUN_DIR / "representation"
    cfg = _pretext_config(run, pretextDataDir=[str(ARM_DATA)],
                          pretextModelLoadDir=str(ARM_VAR),
                          pretextCollection=False, pretextTrain=False)
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    PretextTrainer(cfg, device="cuda").run()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms test representation"] = \
        mld.mel_log_dct.launches
    pts = np.load(run / "model" / "representation.npz")
    n_items = sum(len(load_shard(str(p)))
                  for p in (ARM_DATA / "train").glob("*.pickle"))
    rows = min(n_items, cfg.plotNumBatch * cfg.pretextTestBatchSize)
    batches = -(-rows // cfg.pretextTestBatchSize)
    print(f"representation: img {pts['img'].shape}, sound "
          f"{pts['sound'].shape}, labels {np.bincount(pts['img'][:, -1].astype(int)).tolist()}; "
          f"mel_log_dct launches {launches} over {batches} batches; wall "
          f"{wall:.2f} s", flush=True)
    if pts["img"].shape != (rows, 4) or pts["sound"].shape != (rows, 4) \
            or launches != batches or not np.isfinite(pts["img"]).all():
        fail("bad representation export")


def pipelined_phase(torch, mld):
    """Phase 28: RLPipelinedRollout, 2 updates at 8 envs x 100 steps."""
    import warnings

    from var_tpu_torch.rl import main as rl_main

    rl_dir, steps = RUN_DIR / "pipelined", PROFILES["arms"]["steps"]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = rl_main([
            "--env", "arms", "--set", f'pretextModelLoadDir="{ARM_VAR}"',
            f'RLModelSaveDir="{rl_dir}"', "RLTrain=True",
            "RLModelFineTune=False", 'vecEnvBackend="dummy"',
            "RLPipelinedRollout=True", f"RLTotalSteps={2 * 8 * steps}",
            "RLModelSaveInterval=1", "RLLogInterval=1"])
    wall = time.perf_counter() - t0
    launches = LAUNCHES["arms pipelined"] = mld.mel_log_dct.launches
    cfg, timer = trainer.config, trainer.timer
    with open(rl_dir / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows
              for k in ("loss/value_loss", "loss/policy_loss",
                        "loss/policy_entropy")]
    rates = [n / t for n, t in trainer.update_stats]
    print(f"pipelined: {len(trainer.update_stats)} PPO updates at "
          f"{_width(cfg)}; env-steps/s {[round(r, 1) for r in rates]} "
          f"against phase 7's exact protocol median "
          f"{RATES['arms rl']:.1f}; p50 ms: fused_step "
          f"{timer.p50_ms('fused_step'):.4f}, env_step "
          f"{timer.p50_ms('env_step'):.4f}, ppo_update "
          f"{timer.p50_ms('ppo_update'):.4f}; losses {losses}; "
          f"mel_log_dct launches {launches}; wall {wall:.2f} s", flush=True)
    if _width(cfg) != (8, steps, 512, 128, 128, 4, 2, (3, 96, 96), 3) \
            or len(trainer.update_stats) != 2 or len(rows) != 2 \
            or not all(map(math.isfinite, losses)) or launches != 0 \
            or not any("one-step action delay" in str(w.message)
                       for w in caught):
        fail("the pipelined RL phase did not run as expected")


def slice7_phases(torch, np, mld, kernel, bw, flops):
    """Phases 24-28."""
    mix_phase(torch, np, mld, kernel, bw, flops)
    chunked_phase(torch, mld)
    streaming_phase(torch, mld)
    representation_phase(torch, mld)
    pipelined_phase(torch, mld)
    gc.collect()
    torch.cuda.empty_cache()

# -- phases 29-32: the host env layer at the JAX package's defaults ----------

NATIVE_STATES = 300
NUMPY_PIXEL_BOUND = 0.005  # tests/test_native.py:40: boundary float ties
BUILDS = {}  # phase 2's build seconds by source, for 29


def cpu_line() -> str:
    model = "model not in /proc/cpuinfo"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{model}; os.cpu_count() {os.cpu_count()}"


def native_phase(np):
    """Phase 29: the native raycast against the numpy one at 300 seeded
    grid states, ms per frame of each, rotate_crop at 0 and 90 degrees."""
    import ctypes

    from scipy import ndimage

    from var_tpu_torch import native
    from var_tpu_torch.config import main_config
    from var_tpu_torch.envs.grid_sim import GridHouseSim

    print(f"native: host CPU {cpu_line()}; built simcore.cpp in "
          f"{BUILDS['simcore']:.2f} s, shmbuf.cpp in {BUILDS['shmbuf']:.2f} s "
          f"(phase 2)", flush=True)
    lib = native.simcore()
    if lib is None:
        fail("VAR_TPU_NO_NATIVE is set: the native render is off")
    host = GridHouseSim(main_config(env="ai2thor"))
    host.seed(0)
    plans = list(host.config.allScene["livingRoom"])
    frames, pixels, worst, biggest = 0, 0, 0.0, 0
    t_native = t_numpy = 0.0
    for _ in range(NATIVE_STATES):
        host.floor_plan = plans[int(host.np_random.randint(len(plans)))]
        host._build_world()
        host._domain_randomization()
        t0 = time.perf_counter()
        nat = host._render_native(lib)
        t1 = time.perf_counter()
        ref = host._render_numpy()
        t_numpy += time.perf_counter() - t1
        t_native += t1 - t0
        differ = np.any(nat != ref, axis=-1)
        frames += bool(differ.any())
        pixels += int(differ.sum())
        worst = max(worst, float(differ.mean()))
        biggest = max(biggest, int(np.abs(nat.astype(np.int16)
                                          - ref.astype(np.int16)).max()))
    print(f"native: {NATIVE_STATES} seeded grid states: {frames} frames and "
          f"{pixels} pixels differ between native and numpy, the worst frame "
          f"{100 * worst:.3f}% of its pixels (bound "
          f"{100 * NUMPY_PIXEL_BOUND}%), largest value difference {biggest}; "
          f"ms per frame: native {1e3 * t_native / NATIVE_STATES:.4f}, numpy "
          f"{1e3 * t_numpy / NATIVE_STATES:.4f}", flush=True)
    if worst >= NUMPY_PIXEL_BOUND:
        fail("the native render is outside its bound of the numpy one")
    rng = np.random.RandomState(0)
    window = ((rng.rand(9, 9) > 0.5) * 255).astype(np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def rotate(angle):
        out = np.empty_like(window)
        lib.rotate_crop(window.ctypes.data_as(u8p), 9, ctypes.c_float(angle),
                        out.ctypes.data_as(u8p))
        return out

    ok = (np.array_equal(rotate(0.0), window) and np.array_equal(
        rotate(90.0), ndimage.rotate(window, 90.0, reshape=False, order=0)))
    print(f"native: rotate_crop at 0 and 90 degrees as scipy: {ok}",
          flush=True)
    if not ok:
        fail("rotate_crop disagrees with scipy")


def _segments():
    from var_tpu_torch.envs.vec.shm_transport import SEGMENT_PREFIX

    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(SEGMENT_PREFIX.lstrip("/")))


def shmem_phase(np):
    """Phase 30: ShmemVecEnv (forkserver) against DummyVecEnv at 8 envs,
    both profiles, both transports, 2 full episodes of seeded actions."""
    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.data.audio_store import AudioStore
    from var_tpu_torch.envs.vec.dummy import DummyVecEnv
    from var_tpu_torch.envs.vec.factory import EnvThunk
    from var_tpu_torch.envs.vec.shmem import ShmemVecEnv

    n = 8
    for env in ("arms", "ai2thor"):
        cfg = main_config(env=env)
        cfg.override(RLTrain=True)
        gym_register(cfg, env=env)
        audio = AudioStore(cfg)
        audio.loadData()
        T = cfg.RLEnvMaxSteps
        rng = np.random.RandomState(0)
        if env == "arms":
            actions = rng.uniform(-1, 1, (2 * T, n, 2)).astype(np.float32)
        else:
            actions = rng.randint(0, len(cfg.allActions), (2 * T, n))
        for transport in ("posix", "array"):
            thunks = [EnvThunk(cfg.RLEnvName, cfg.RLEnvSeed, i)
                      for i in range(n)]
            t0 = time.perf_counter()
            shmem = ShmemVecEnv(thunks, audio=audio, transport=transport)
            dummy = DummyVecEnv(thunks, audio=audio)
            obs = [shmem.reset(), dummy.reset()]
            start = time.perf_counter() - t0
            times, equal, dones = ([], []), True, 0
            for a in actions:
                outs = []
                for k, venv in enumerate((shmem, dummy)):
                    t0 = time.perf_counter()
                    outs.append(venv.step(a))
                    times[k].append(time.perf_counter() - t0)
                (os_, rs, ds, _), (od, rd, dd, _) = outs
                equal &= (all(np.array_equal(os_[k], od[k]) for k in od)
                          and np.array_equal(rs, rd)
                          and np.array_equal(ds, dd)
                          and all(np.array_equal(
                              np.asarray(g[k]).reshape(np.shape(w[k])), w[k])
                              for g, w in zip(shmem.obs_list, dummy.obs_list)
                              for k in w))
                dones += int(dd.sum())
            info = shmem.worker_info()
            shmem.close()
            dummy.close()
            left = _segments()
            p50 = [1e3 * statistics.median(t) for t in times]
            print(f"shmem [{env}, {transport}]: {n} envs x {2 * T} steps "
                  f"(2 episodes, {dones} dones): observations, rewards, "
                  f"dones and obs_list equal to DummyVecEnv's: {equal}; "
                  f"env_step p50 ms: shmem {p50[0]:.4f}, dummy {p50[1]:.4f}; "
                  f"start and reset {start:.2f} s; workers with a CUDA "
                  f"context {sum(w['cuda_initialized'] for w in info)}, "
                  f"threads {sorted({w['threads'] for w in info})}; "
                  f"segments left in /dev/shm {left}", flush=True)
            if not equal or dones < 2 * n or left \
                    or any(w["cuda_initialized"] for w in info):
                fail(f"ShmemVecEnv [{env}, {transport}] is not DummyVecEnv")


class _Backends:
    """Records the vec env each make_vec_envs call of the pretext and RL
    trainers returns (the class and its env count)."""

    def __enter__(self):
        from var_tpu_torch.envs.vec import factory
        from var_tpu_torch.train import rl

        self.made, self._mods = [], (factory, rl)
        make = self._make = factory.make_vec_envs

        def spy(*a, **kw):
            envs = make(*a, **kw)
            self.made.append((type(envs.unwrapped).__name__, envs.num_envs))
            return envs

        for mod in self._mods:
            mod.make_vec_envs = spy
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.make_vec_envs = self._make


def defaults_phase(torch, np, mld, kernel, env):
    """Phase 31: the main path at the JAX package's defaults (no
    vecEnvBackend override): collect at pretextNumEnvs through ShmemVecEnv,
    2 VAR epochs through the kernel, 2 fused PPO updates, a 16-episode
    eval."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.pretext import main as pretext_main
    from var_tpu_torch.rl import main as rl_main

    prof, run = PROFILES[env], RUN_DIR / "defaults" / env
    key = prof["key"] + "defaults "
    seen = {}
    undo = _capture_stft(audio, seen)
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    try:
        with _Backends() as made:
            trainer = pretext_main([
                "--env", env, "--set", f'pretextDataDir=["{run / "data"}"]',
                f'pretextModelSaveDir="{run / "model"}"',
                'audioBackend="pallas"', "pretextModelFineTune=False",
                'pretextDataset="VARDataset"',
                "pretextCollectNum=[128,128,128,128,256]", "pretextEpoch=2",
                "pretextModelSaveInterval=2"])
            torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = LAUNCHES[key + "pretext"] = mld.mel_log_dct.launches
    cfg = trainer.config
    shapes = sorted(set(seen["shapes"]))
    want_shape = (128, prof["sound"][1] + 1, 257)
    print(f"defaults [{env}]: pretext vec envs {made.made} "
          f"(pretextNumEnvs {cfg.pretextNumEnvs}, vecEnvBackend "
          f"{cfg.vecEnvBackend!r}, vecEnvContext {cfg.vecEnvContext!r}); "
          f"{trainer.step} steps, mel_log_dct launches {launches} at "
          f"{shapes}; wall {wall:.2f} s", flush=True)
    if made.made != [("ShmemVecEnv", cfg.pretextNumEnvs)] \
            or cfg.vecEnvBackend != "auto" or trainer.step != 12 \
            or launches != 2 * trainer.step or shapes != [want_shape]:
        fail(f"the {env} pretext at the defaults did not run through "
             f"ShmemVecEnv and the kernel")
    power, params = seen[257]
    with torch.no_grad():
        got = mld.mel_log_dct(power, params)
        want = mld.mel_log_dct_reference(power, params)
    err = (got - want).abs().max().item()
    print(f"defaults [{env}]: the kernel on the path's first input "
          f"{tuple(power.shape)}: max abs err {err:.3e}", flush=True)
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail("the kernel disagrees with its plain version at the defaults")
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)

    steps, rl_dir = prof["steps"], run / "rl_model"
    mld.mel_log_dct.launches = 0
    with _Backends() as made:
        rl_trainer = rl_main([
            "--env", env, "--set",
            f'pretextModelLoadDir="{run / "model" / "1"}"',
            f'RLModelSaveDir="{rl_dir}"', "RLTrain=True",
            "RLModelFineTune=False", f"RLTotalSteps={2 * 8 * steps}",
            "RLModelSaveInterval=1", "RLLogInterval=1"])
        torch.cuda.synchronize()
    launches = LAUNCHES[key + "rl train"] = mld.mel_log_dct.launches
    rcfg, timer = rl_trainer.config, rl_trainer.timer
    rate = rl_trainer.update_stats[1][0] / rl_trainer.update_stats[1][1]
    fused, env_step = timer.p50_ms("fused_step"), timer.p50_ms("env_step")
    d_fused, d_env = P50[env + " rl"]
    print(f"defaults [{env}]: rl vec envs {made.made}; "
          f"{len(rl_trainer.update_stats)} PPO updates at {_width(rcfg)}; "
          f"env-steps/s at update 1 {rate:.1f} against phase "
          f"{7 if env == 'arms' else 16}'s DummyVecEnv median "
          f"{RATES[env + ' rl']:.1f}; p50 ms: fused_step {fused:.4f} "
          f"(dummy {d_fused:.4f}), env_step {env_step:.4f} (dummy "
          f"{d_env:.4f}), ppo_update {timer.p50_ms('ppo_update'):.4f}; "
          f"mel_log_dct launches {launches}", flush=True)
    if made.made != [("ShmemVecEnv", 8)] or launches != 0 \
            or len(rl_trainer.update_stats) != 2 \
            or _width(rcfg)[:2] != (8, steps):
        fail(f"the {env} RL at the defaults did not run through ShmemVecEnv")
    with _Backends() as made:
        rl_eval(torch, rl_trainer, mld, env, tag="defaults ")
    print(f"defaults [{env}]: eval vec envs {made.made}", flush=True)
    if made.made != [("ShmemVecEnv", prof["eval_envs"])]:
        fail(f"the {env} eval at the defaults did not run through "
             f"ShmemVecEnv")


def _descendants():
    """The pids of this process's live descendants (the forkserver, the
    resource tracker and the env workers), from /proc; zombies, which have
    ended and wait only to be reaped, are left out."""
    children = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except (OSError, ValueError):
                continue
            if state != "Z":
                children.setdefault(int(ppid), []).append(int(d))
    out, todo = [], [os.getpid()]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _memory_kib(pid):
    """(resident, private resident) KiB of a process from /proc/<pid>/statm
    (resident less its shared pages), or None once it has gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            resident, shared = map(int, f.read().split()[1:3])
    except (OSError, ValueError):
        return None
    kib = os.sysconf("SC_PAGE_SIZE") // 1024
    return resident * kib, (resident - shared) * kib


def _available_gib():
    with open("/proc/meminfo") as f:
        return next(int(l.split()[1]) for l in f
                    if l.startswith("MemAvailable")) / 2 ** 20


def grid64_phase(torch):
    """Phase 32: the grid fused host path at 64 envs x 50 steps, 2 PPO
    updates; the workers' summed memory and the host's, sampled every
    0.5 s while it runs."""
    import threading

    from var_tpu_torch.rl import main as rl_main

    rl_dir, peak, stop = RUN_DIR / "grid64", {}, threading.Event()
    avail0 = _available_gib()

    def sample():
        while not stop.wait(0.5):
            mems = [m for m in map(_memory_kib, _descendants()) if m]
            for name, v in (("procs", len(mems)),
                            ("rss", sum(m[0] for m in mems)),
                            ("private", sum(m[1] for m in mems))):
                peak[name] = max(peak.get(name, 0), v)
            peak["avail"] = min(peak.get("avail", avail0), _available_gib())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        with _Backends() as made:
            trainer = rl_main([
                "--env", "ai2thor", "--set",
                f'pretextModelLoadDir="{RUN_DIR / "ai2thor" / "model" / "4"}"',
                f'RLModelSaveDir="{rl_dir}"', "RLTrain=True",
                "RLModelFineTune=False", "RLNumEnvs=64",
                f"RLTotalSteps={2 * 64 * 50}", "RLModelSaveInterval=1",
                "RLLogInterval=1"])
            torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    wall = time.perf_counter() - t0
    cfg, timer = trainer.config, trainer.timer
    rates = [n / t for n, t in trainer.update_stats]
    print(f"grid 64 envs: vec envs {made.made}; {len(rates)} PPO updates at "
          f"{_width(cfg)}; env-steps/s {[round(r, 1) for r in rates]} "
          f"(phase 16's 8-env DummyVecEnv median "
          f"{RATES['ai2thor rl']:.1f}); p50 ms: fused_step "
          f"{timer.p50_ms('fused_step'):.4f}, env_step "
          f"{timer.p50_ms('env_step'):.4f}, ppo_update "
          f"{timer.p50_ms('ppo_update'):.4f}; wall {wall:.2f} s; host "
          f"{cpu_line()}", flush=True)
    print(f"grid 64 envs: peak over {peak.get('procs', 0)} child processes: "
          f"summed RSS {peak.get('rss', 0) / 2 ** 20:.2f} GiB, summed "
          f"private RSS {peak.get('private', 0) / 2 ** 20:.2f} GiB; host "
          f"MemAvailable "
          f"{avail0:.1f} GiB before, {peak.get('avail', avail0):.1f} GiB at "
          f"the least", flush=True)
    if made.made != [("ShmemVecEnv", 64)] or len(rates) != 2 \
            or _width(cfg)[:2] != (64, 50) or peak.get("procs", 0) < 64:
        fail("the grid's 64-env host path did not run through 64 workers")


def slice8_phases(torch, np, mld, kernel):
    """Phases 29-32."""
    native_phase(np)
    shmem_phase(np)
    for env in ("arms", "ai2thor"):
        defaults_phase(torch, np, mld, kernel, env)
    grid64_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 33: manual control and episode recording ----------------------------

# scripted command streams: keys on the grid, 'dx dy' lines on the arm; ''
# repeats the last command, an unknown key or bad line is refused
MANUAL_STREAMS = {"ai2thor": ["w", "a", "", "x", "d", "w", "quit", "w"],
                  "arms": ["0.5 0", "0 -0.5", "", "left", "-1 1", "quit"]}


def _read_png(np, path):
    """A PNG the port wrote (8-bit grey or RGB, filter 0), read back with
    zlib after checking its signature and every chunk's CRC."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body) & 0xFFFFFFFF:
            fail(f"{path}: bad CRC in its {kind!r} chunk")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    return rows.reshape(h, 1 + w * c)[:, 1:].reshape(h, w, c)


def manual_phase(torch, np, mld):
    """Phase 33: scripted manual control with render and episode recording
    on, each profile on its phase-4 VAR on the card, then run()'s dispatch
    with a fresh VAR; the frames and the live view read back."""
    import builtins
    import io
    import re
    from contextlib import redirect_stdout

    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.train.rl import RLTrainer

    def trainer_for(env, run, loaded):
        cfg = main_config(env=env)
        cfg.override(RLTrain=False, RLManualControl=True, render=True,
                     RLManualControlLoaded=loaded, episodeImgSaveInterval=1,
                     episodeImgSaveDir=str(run), vecEnvBackend="dummy",
                     pretextModelLoadDir=str(RUN_DIR / env / "model" / "4"))
        gym_register(cfg, env=env)
        return RLTrainer(cfg, env=env, device="cuda")

    for env, stream in MANUAL_STREAMS.items():
        run = RUN_DIR / "manual" / env
        trainer = trainer_for(env, run, True)
        trainer.load_pretext()
        commands = iter(stream)
        out = io.StringIO()
        mld.mel_log_dct.launches = 0
        t0 = time.perf_counter()
        with redirect_stdout(out):
            trainer.manualControl(input_fn=lambda: next(commands))
        wall = time.perf_counter() - t0
        LAUNCHES[f"{PROFILES[env]['key']}manual control"] = \
            mld.mel_log_dct.launches
        rewards = [float(x) for x in
                   re.findall(r"step reward (\S+)", out.getvalue())]
        refused = len(re.findall(r"unknown key|expected 'dx dy'",
                                 out.getvalue()))
        frames = sorted(p for p in run.iterdir() if p.name != "manual_live.png")
        h, w, _ = trainer.config.episodeImgSize
        shapes = {_read_png(np, p).shape for p in frames}
        live = _read_png(np, run / "manual_live.png")
        print(f"manual control [{env}]: {len(rewards)} steps, rewards "
              f"{[round(r, 4) for r in rewards]}, {refused} command refused; "
              f"{len(frames)} episode frames {sorted(shapes)}, live view "
              f"{live.shape}; VAR on "
              f"{next(trainer.pretext_model.parameters()).device}; "
              f"mel_log_dct launches {mld.mel_log_dct.launches}; "
              f"{wall:.2f} s", flush=True)
        valid = len([c for c in stream[:stream.index("quit")]
                     if c not in ("x", "left")])
        if len(rewards) != valid or refused != 1 \
                or not all(math.isfinite(r) for r in rewards) \
                or len(frames) < valid or shapes != {(h, w, 3)} \
                or live.shape != (96, 96, 3) or live.std() == 0 \
                or not next(trainer.pretext_model.parameters()).is_cuda \
                or mld.mel_log_dct.launches != 0:
            fail(f"manual control [{env}] did not run as scripted")

    # run() with no VAR to load: a fresh one, commands from stdin
    run = RUN_DIR / "manual" / "fresh"
    commands = iter(["w", "d", "w"])

    def scripted_input(prompt=""):
        try:
            return next(commands)
        except StopIteration:
            raise EOFError from None

    out, saved = io.StringIO(), builtins.input
    builtins.input = scripted_input
    try:
        with redirect_stdout(out):
            trainer_for("ai2thor", run, False).run()
    finally:
        builtins.input = saved
    rewards = re.findall(r"step reward (\S+)", out.getvalue())
    print(f"manual control [ai2thor, fresh VAR through run()]: "
          f"{len(rewards)} steps", flush=True)
    if len(rewards) != 3 or not (run / "manual_live.png").exists():
        fail("run() did not dispatch manual control with a fresh VAR")


# -- phase 34: computeDtype='bfloat16' on both profiles' paths -----------------

BF16_SET = 'computeDtype="bfloat16"'
BF16_EPOCHS = 3


def bf16_pretext(torch, mld, env):
    """Phase 34's pretext: the profile's pretext entry point at bf16 on
    phase 4's or 15's triplets, 3 epochs of 6 steps at batch 128 through
    the kernel."""
    from var_tpu_torch.pretext import main as pretext_main

    prof, run = PROFILES[env], RUN_DIR / "bf16" / env
    argv = [
        "--env", env, "--set",
        f'pretextDataDir=["{RUN_DIR / env / "data"}"]',
        f'pretextModelSaveDir="{run / "model"}"', "pretextCollection=False",
        'audioBackend="pallas"', "pretextModelFineTune=False",
        'pretextDataset="VARDataset"', 'vecEnvBackend="dummy"',
        f"pretextEpoch={BF16_EPOCHS}",
        f"pretextModelSaveInterval={BF16_EPOCHS}", BF16_SET,
    ]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = pretext_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES[prof["key"] + "bf16 pretext"] = \
        mld.mel_log_dct.launches
    cfg = trainer.config
    if cfg.pretextTrainBatchSize != 128 or \
            tuple(cfg.sound_dim) != prof["sound"] or \
            trainer.model.dtype != torch.bfloat16:
        fail(f"the {env} bf16 pretext did not run at full width in bf16")
    with open(run / "model" / "progress.csv") as f:
        losses = [float(v) for v in f.read().split()[1:]]
    rates = [n / t for n, t in trainer.epoch_stats[1:]]
    print(f"bf16 pretext [{env}]: {trainer.step} steps, mel_log_dct "
          f"launches {launches} ({launches / trainer.step:g} a step), epoch "
          f"losses {losses}; triplets/s over epochs 1-{len(rates)}: "
          f"{[round(r, 1) for r in rates]}, median "
          f"{statistics.median(rates):.1f}, against phase "
          f"{'4' if env == 'arms' else '15'}'s float32 median "
          f"{RATES[env + ' pretext']:.1f}; wall {wall:.2f} s", flush=True)
    if trainer.step < 12 or launches != 2 * trainer.step \
            or len(losses) != BF16_EPOCHS \
            or not all(map(math.isfinite, losses)):
        fail(f"the {env} bf16 pretext: expected 2 launches a step and "
             f"{BF16_EPOCHS} finite epoch losses")


def bf16_devsim(torch, mld, env):
    """Phase 34's device sim: 2 PPO updates at 64 envs on the bf16 VAR."""
    from var_tpu_torch.rl import main as rl_main

    prof, run = PROFILES[env], RUN_DIR / "bf16" / env
    updates = 2
    argv = [
        "--env", env, "--set",
        f'pretextModelLoadDir="{run / "model" / str(BF16_EPOCHS - 1)}"',
        f'RLModelSaveDir="{run / "rl_devsim"}"', "RLTrain=True",
        "RLModelFineTune=False", "RLDeviceSimRollout=True",
        f"RLNumEnvs={DS_ENVS}",
        f"RLTotalSteps={updates * DS_ENVS * prof['steps']}",
        "RLModelSaveInterval=1", "RLLogInterval=1", BF16_SET,
    ]
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    trainer = rl_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES[prof["key"] + "bf16 device-sim train"] = \
        mld.mel_log_dct.launches
    cfg = trainer.config
    if _width(cfg) != (DS_ENVS, prof["steps"], prof["gru"], 128, 128, 4, 2,
                       (3, 96, 96), 3) \
            or trainer.policy.base.dtype != torch.bfloat16 \
            or trainer.pretext_model.dtype != torch.bfloat16:
        fail(f"the {env} bf16 device sim did not run at full width in bf16")
    with open(run / "rl_devsim" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows
              for k in ("loss/value_loss", "loss/policy_loss",
                        "loss/policy_entropy")]
    rate = trainer.update_stats[1][0] / trainer.update_stats[1][1]
    timer = trainer.timer
    collect, update = P50[env + " devsim"]
    print(f"bf16 device-sim train [{env}]: {len(rows)} updates, losses "
          f"{losses}; env-steps/s at update 1 {rate:.1f} against phase "
          f"{'11' if env == 'arms' else '17'}'s float32 median "
          f"{RATES[env + ' devsim']:.1f}; p50 ms collect (dispatch) "
          f"{timer.p50_ms('collect'):.4f} against {collect:.4f}, "
          f"ppo_update {timer.p50_ms('ppo_update'):.4f} against "
          f"{update:.4f}; mel_log_dct launches {launches}; wall "
          f"{wall:.2f} s", flush=True)
    if len(rows) != updates or launches != 0 \
            or not all(map(math.isfinite, losses)):
        fail(f"the {env} bf16 device sim: expected {updates} updates with "
             "finite losses and no mel_log_dct launch")


def bf16_card_against_cpu(env):
    """Phase 34's check: one pretext step (batch 16, the profile's full
    widths) and one fused rollout of 10 steps with its PPO update (8 envs,
    full width), card against CPU at bf16 (tools/rl_check.py's bf16
    tolerances); then the fused check's control, which must fail them."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.tools.rl_check import (card_against_cpu,
                                              pretext_card_against_cpu)

    cfg = main_config(env=env)
    cfg.override(computeDtype="bfloat16", audioBackend="pallas",
                 pretextTrainBatchSize=16)
    t0 = time.perf_counter()
    pretext = pretext_card_against_cpu(cfg)
    print(f"bf16 card vs cpu [{env}], one pretext step at batch 16: "
          f"{pretext} in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = main_config(env=env)
    cfg.override(computeDtype="bfloat16", RLTrain=True, ppoNumSteps=10,
                 RLEnvMaxSteps=5, vecEnvBackend="dummy")
    t0 = time.perf_counter()
    fused = card_against_cpu(cfg)
    print(f"bf16 card vs cpu [{env}], fused rollout and update (8 envs x "
          f"10 steps, full width): {fused} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not (pretext["ok"] and fused["ok"]):
        fail(f"the {env} bf16 paths differ between the card and the CPU")
    t0 = time.perf_counter()
    control = card_against_cpu(cfg, control=True)
    print(f"bf16 card vs cpu [{env}], the control (the card's VAR convs "
          f"summing partial sums in bf16): {control} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if control["ok"]:
        fail(f"the {env} bf16 check passed a route that sums in bf16")


def bf16_phase(torch, mld):
    """Phase 34: both profiles' pretext and device sim at bf16, and the
    card against the CPU at bf16."""
    for env in ("arms", "ai2thor"):
        bf16_pretext(torch, mld, env)
        bf16_devsim(torch, mld, env)
        bf16_card_against_cpu(env)
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 35: meshShape data parallelism ------------------------------------

MESH_DIR = RUN_DIR / "mesh"


def _mesh_argv(kind, env, out):
    """Phase 35's entry-point arguments: each path at phase 4's, 7's, 11's
    or 17's width and seed, one epoch or one PPO update, into `out`."""
    prof = PROFILES[env]
    if kind == "pretext":
        return ["--env", env, "--set",
                f'pretextDataDir=["{RUN_DIR / env / "data"}"]',
                f'pretextModelSaveDir="{out}"', "pretextCollection=False",
                'audioBackend="pallas"', "pretextModelFineTune=False",
                'pretextDataset="VARDataset"', 'vecEnvBackend="dummy"',
                "pretextEpoch=1", "pretextModelSaveInterval=1"]
    envs = DS_ENVS if kind == "devsim" else 8
    argv = ["--env", env, "--set",
            f'pretextModelLoadDir="{RUN_DIR / env / "model" / "4"}"',
            f'RLModelSaveDir="{out}"', "RLTrain=True",
            "RLModelFineTune=False", 'vecEnvBackend="dummy"',
            f"RLNumEnvs={envs}", f"RLTotalSteps={envs * prof['steps']}",
            "RLModelSaveInterval=1", "RLLogInterval=1"]
    if kind == "devsim":
        argv.append("RLDeviceSimRollout=True")
    return argv


def _mesh_rank(kind, env, argv, out, device):
    """One rank of phase 35's dp=2 runs, spawned by parallel/mesh.py::
    launch with the card named (cuda:0) and gloo: the entry point's rank
    function; then the rank's kernel launches, its wall and rates, and the
    kernel held against its plain version on the first input the path gave
    it, into out/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from var_tpu_torch import pretext as pretext_entry
    from var_tpu_torch import rl as rl_entry
    from var_tpu_torch.cli import build_config, parse_args
    from var_tpu_torch.ops import audio
    from var_tpu_torch.ops import mel_log_dct as mld

    args = parse_args(argv)
    seen = {}
    undo = _capture_stft(audio, seen)
    mld.mel_log_dct.launches = 0
    t0 = time.perf_counter()
    try:
        if kind == "pretext":
            trainer = pretext_entry._rank(build_config(args, "pretext"),
                                          device=device)
            stats = trainer.epoch_stats
        else:
            trainer = rl_entry._rank(build_config(args, "RL"), env,
                                     device=device)
            stats = trainer.update_stats
        torch.cuda.synchronize()
    finally:
        undo()
    report = {"launches": mld.mel_log_dct.launches,
              "wall": time.perf_counter() - t0, "stats": stats,
              "shapes": sorted(set(seen.get("shapes", [])))}
    if 257 in seen:
        power, params = seen[257]
        with torch.no_grad():
            got = mld.mel_log_dct(power, params)
            want = mld.mel_log_dct_reference(power, params)
        report["kernel_ok"] = bool(torch.allclose(got, want, rtol=RTOL,
                                                  atol=ATOL))
        report["max_abs_err"] = (got - want).abs().max().item()
    with open(Path(out) / f"rank{dist.get_rank()}.json", "w") as f:
        json.dump(report, f)


def _mesh_compare(torch, what, got_dir, want_dir, label, steps, lr,
                  row_keys):
    """Holds a mesh run's first progress row and checkpoint against
    another run's: the row at rtol = atol = 1e-4, the parameters within
    2 x lr a step + 5e-5 and with a median gap below 1e-6. Adam moves every
    weight by about lr a step whatever its gradient, so the largest gap
    alone would pass a gradient that was never all-reduced; the median
    does not. Returns the largest parameter gap."""
    from var_tpu_torch.train.checkpoint import load_checkpoint

    rows = []
    for d in (got_dir, want_dir):
        with open(Path(d) / "progress.csv") as f:
            rows.append(list(csv.DictReader(f))[0])
    for k in row_keys:
        a, b = float(rows[0][k]), float(rows[1][k])
        if not math.isclose(a, b, rel_tol=RTOL, abs_tol=ATOL):
            fail(f"{what}: {k} {a} against {b}")
    p = [load_checkpoint(str(Path(d) / label))["params"]
         for d in (got_dir, want_dir)]
    gaps = torch.cat([(p[0][k].float() - v.float()).abs().ravel()
                      for k, v in p[1].items()])
    bound = 2 * lr * steps + 5e-5
    print(f"{what}: first row {[rows[0][k] for k in row_keys]} against "
          f"{[rows[1][k] for k in row_keys]}; parameters max gap "
          f"{gaps.max().item():.3e} (bound {bound:.3e}), median "
          f"{gaps.median().item():.3e}", flush=True)
    if gaps.max().item() > bound:
        fail(f"{what}: parameters beyond the Adam-step bound")
    if gaps.median().item() >= PARAM_MEDIAN:
        fail(f"{what}: median parameter gap {gaps.median().item():.3e} "
             f"not below {PARAM_MEDIAN:g}")
    return gaps.max().item()


# The median parameter gap between two runs of one computation (as
# tests/test_torch_parallel.py holds it): a missing or partial all-reduce
# moves most weights by about lr, far above it.
PARAM_MEDIAN = 1e-6

RL_ROW = ("loss/value_loss", "loss/policy_loss", "loss/policy_entropy",
          "eprewmean")


def mesh_phase(torch, mld, line):
    """Phase 35: arm pretext, each profile's device sim and the arm's fused
    host path under meshShape: at dp=1 on NCCL through the entry points,
    held against the unsharded phases 4, 7, 11 and 17 of this call; at dp=2
    on this one card over gloo (two spawned ranks on cuda:0), held against
    dp=1; each rank's kernel on its first input (64, 101, 257) against the
    plain version."""
    from var_tpu_torch.config import main_config
    from var_tpu_torch.parallel.mesh import launch
    from var_tpu_torch.pretext import main as pretext_main
    from var_tpu_torch.rl import main as rl_main

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    runs = (("pretext", "arms"), ("fused", "arms"), ("devsim", "arms"),
            ("devsim", "ai2thor"))
    unsharded = {("pretext", "arms"): RUN_DIR / "arms" / "model",
                 ("fused", "arms"): RUN_DIR / "arms" / "rl_model",
                 ("devsim", "arms"): RUN_DIR / "arms" / "rl_devsim",
                 ("devsim", "ai2thor"): RUN_DIR / "ai2thor" / "rl_devsim"}
    for kind, env in runs:
        tag = f"{env} {kind}"
        cfg = main_config(env=env)
        lr = cfg.pretextLR if kind == "pretext" else cfg.RLLr
        opt_steps = (6 if kind == "pretext"
                     else cfg.ppoEpoch * cfg.ppoNumMiniBatch)
        out = {dp: MESH_DIR / f"{env}_{kind}_dp{dp}" for dp in (1, 2)}
        # dp=1: the entry point, one rank in this process on NCCL
        mld.mel_log_dct.launches = 0
        t0 = time.perf_counter()
        main = pretext_main if kind == "pretext" else rl_main
        trainer = main(_mesh_argv(kind, env, out[1])
                       + ["meshShape={'dp': 1}"])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        LAUNCHES[f"mesh dp=1 {tag}"] = mld.mel_log_dct.launches
        if trainer.mesh is None or trainer.mesh.backend != "nccl":
            fail(f"{tag}: the dp=1 run did not run on an NCCL group")
        stats = (trainer.epoch_stats if kind == "pretext"
                 else trainer.update_stats)
        steps = trainer.step if kind == "pretext" else None
        # the ranks share this card: hand back what this process holds
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        # dp=2: two ranks on this card over gloo
        out[2].mkdir(parents=True)
        t0 = time.perf_counter()
        launch(_mesh_rank, (kind, env, _mesh_argv(kind, env, out[2])
                            + ["meshShape={'dp': 2}"], str(out[2])), 2,
               device="cuda:0", backend="gloo")
        wall2 = time.perf_counter() - t0
        reports = [json.loads((out[2] / f"rank{r}.json").read_text())
                   for r in range(2)]
        LAUNCHES[f"mesh dp=2 {tag}"] = sum(r["launches"] for r in reports)
        if kind == "pretext":
            losses = {}
            for name, d in (("unsharded", unsharded[(kind, env)]),
                            ("dp=1", out[1]), ("dp=2", out[2])):
                with open(Path(d) / "progress.csv") as f:
                    losses[name] = float(f.read().split()[1])
            print(f"mesh [{tag}]: epoch 0 loss {losses}", flush=True)
            for name in ("dp=1", "dp=2"):
                if not math.isclose(losses[name], losses["unsharded"],
                                    rel_tol=RTOL, abs_tol=ATOL):
                    fail(f"{tag}: {name} epoch loss against phase 4's")
            _mesh_compare(torch, f"mesh [{tag}] dp=2 against dp=1", out[2],
                          out[1], "0", opt_steps, lr, ("avg_loss",))
            for r in reports:
                print(f"mesh [{tag}] dp=2 rank: {r['launches']} kernel "
                      f"launches over {steps} steps at {r['shapes']}; the "
                      f"kernel on its first input: max abs err "
                      f"{r['max_abs_err']:.3e}", flush=True)
                if r["launches"] != 2 * steps or not r["kernel_ok"] or \
                        [tuple(s) for s in r["shapes"]] != [(64, 101, 257)]:
                    fail(f"{tag}: a dp=2 rank's kernel launches, shapes or "
                         "agreement")
            if LAUNCHES[f"mesh dp=1 {tag}"] != 2 * steps:
                fail(f"{tag}: dp=1 expected 2 kernel launches a step")
            rate1 = sum(n for n, _ in stats) / wall1
            rate2 = sum(n for n, _ in stats) / wall2
            unit = "triplets/s (wall, set-up included)"
        else:
            _mesh_compare(torch, f"mesh [{tag}] dp=1 against the unsharded "
                          "phase", out[1], unsharded[(kind, env)], "00000",
                          opt_steps, lr, RL_ROW)
            _mesh_compare(torch, f"mesh [{tag}] dp=2 against dp=1", out[2],
                          out[1], "00000", opt_steps, lr, RL_ROW)
            if LAUNCHES[f"mesh dp=1 {tag}"] or LAUNCHES[f"mesh dp=2 {tag}"]:
                fail(f"{tag}: the RL paths launch no mel_log_dct")
            n = stats[0][0]
            rate1, rate2 = n / wall1, n / wall2
            unit = "env-steps/s (wall, set-up included)"
        # the global items over each rank's timed epoch or update (first
        # call included), beside dp=1's own
        ranked = [sum(n for n, _ in r["stats"])
                  / sum(t for _, t in r["stats"]) for r in reports]
        timed1 = sum(n for n, _ in stats) / sum(t for _, t in stats)
        print(f"mesh [{tag}]: dp=1 (NCCL) {wall1:.2f} s, {rate1:.1f} "
              f"{unit}; dp=2 (gloo, one card) {wall2:.2f} s, {rate2:.1f}; "
              f"rank walls {[round(r['wall'], 2) for r in reports]}; over "
              f"the timed epoch or update: dp=1 {timed1:.1f}, dp=2 ranks "
              f"{[round(x, 1) for x in ranked]}; {line}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 36: the last modules ---------------------------------------------

LAST_DIR = RUN_DIR / "last"


def _frame_counter(np):
    """Counts and times RealTimeEmbeddingPlot.save calls (each rewrites
    the frame file) while it is installed; returns (records, restore)."""
    from var_tpu_torch.utils import plotting

    real = plotting.RealTimeEmbeddingPlot.save
    records = []

    def save(plot, path):
        t0 = time.perf_counter()
        out = real(plot, path)
        records.append((path, time.perf_counter() - t0))
        return out

    plotting.RealTimeEmbeddingPlot.save = save
    return records, lambda: setattr(plotting.RealTimeEmbeddingPlot, "save",
                                    real)


def representation_png_phase(torch, np, mld, kv):
    """Phase 36 (a): testRepresentation to representation.png on phase 4's
    arm VAR (D = 3, the sphere), a seeded arm VAR at D = 8 (the t-SNE on
    the card) and phase 15's ai2thor VAR, each through the kernel."""
    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.data.triplets import load_shard
    from var_tpu_torch.train.pretext import PretextTrainer
    from var_tpu_torch.utils.plotting import SIZE, tsne

    grid_data = RUN_DIR / "ai2thor" / "data"
    for tag, env, dim in (("arm D=3", "arms", 3), ("arm D=8", "arms", 8),
                          ("ai2thor D=3", "ai2thor", 3)):
        run = LAST_DIR / tag.replace(" ", "_").replace("=", "")
        data = ARM_DATA if env == "arms" else grid_data
        var = ARM_VAR if env == "arms" else RUN_DIR / "ai2thor" / "model" / "4"
        cfg = main_config(env=env)
        cfg.override(pretextDataDir=[str(data)],
                     pretextModelSaveDir=str(run / "model"),
                     pretextModelLoadDir=str(var), audioBackend="pallas",
                     pretextCollection=False, pretextTrain=False,
                     representationDim=dim, vecEnvBackend="dummy")
        gym_register(cfg, env=env)
        if dim != 3:  # a seeded VAR at this width, saved where it loads
            fresh = PretextTrainer(cfg, device="cuda")
            fresh.init_model(seed=0)
            cfg.override(pretextModelLoadDir=fresh.save_model("seeded"))
        mld.mel_log_dct.launches = 0
        t0 = time.perf_counter()
        png = PretextTrainer(cfg, device="cuda").testRepresentation()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = LAUNCHES[f"{tag} representation png"] = \
            mld.mel_log_dct.launches
        pts = np.load(run / "model" / "representation.npz")
        n_items = sum(len(load_shard(str(p)))
                      for p in (data / "train").glob("*.pickle"))
        rows = min(n_items, cfg.plotNumBatch * cfg.pretextTestBatchSize)
        batches = -(-rows // cfg.pretextTestBatchSize)
        img = _read_png(np, png)
        line = (f"representation png [{tag}]: {img.shape}, {rows} items a "
                f"side; mel_log_dct launches {launches} over {batches} "
                f"batches; wall {wall:.2f} s")
        if dim > 3:  # the t-SNE alone, on the card, on the same points
            both = np.concatenate([pts["img"][:, :-1], pts["sound"][:, :-1]])
            t0 = time.perf_counter()
            _, kl = tsne(both, "cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            line += (f"; t-SNE on the card: N {len(both)}, {secs:.2f} s, "
                     f"KL {kl:.4f}")
            kv.logkv("tsne_seconds", secs)
        kv.logkv(f"png_wall_s/{tag}", wall)
        print(line, flush=True)
        if img.shape != (SIZE, SIZE, 3) or img.std() == 0 \
                or pts["img"].shape != (rows, dim + 1) \
                or launches != batches:
            fail(f"bad representation plot [{tag}]")


def realtime_phase(torch, np, mld, kv):
    """Phase 36 (b, c): realTimeVec on the reward-wrapper path through
    manual control (the arm, phase 4's VAR; RLManualControlLoaded follows
    realTimeVec as in the JAX config) and in scripted manual collection:
    the frame rewritten at each step, its wall per step."""
    import io
    from contextlib import redirect_stdout

    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.train.pretext import PretextTrainer
    from var_tpu_torch.train.rl import RLTrainer

    records, restore = _frame_counter(np)
    try:
        run = LAST_DIR / "realtime_rl"
        cfg = main_config(env="arms")
        cfg.override(realTimeVec=True, RLTrain=False, RLManualControl=True,
                     RLManualControlLoaded=True, vecEnvBackend="dummy",
                     RLModelSaveDir=str(run), episodeImgSaveInterval=-1,
                     pretextModelLoadDir=str(ARM_VAR))
        gym_register(cfg, env="arms")
        trainer = RLTrainer(cfg, env="arms", device="cuda")
        trainer.load_pretext()
        commands = iter(["0.5 0", "0 -0.5", "", "-0.5 0.5", "quit"])
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            trainer.manualControl(input_fn=lambda: next(commands))
        wall = time.perf_counter() - t0
        frame = run / "realtime_vec.png"
        rl_frames = [r for r in records if r[0] == str(frame)]
        ms = [1000 * t for _, t in rl_frames]
        img = _read_png(np, frame)
        print(f"realTimeVec [arm reward wrapper, manual control]: "
              f"{len(rl_frames)} frame rewrites, {img.shape}; ms a frame "
              f"p50 {statistics.median(ms):.2f}, max {max(ms):.2f}; wall "
              f"{wall:.2f} s", flush=True)
        kv.logkv("realtime_frame_ms_p50/reward_wrapper",
                 statistics.median(ms))
        if len(rl_frames) < 4 or img.std() == 0:
            fail("realTimeVec did not rewrite the wrapper's frame each step")

        records.clear()
        run = LAST_DIR / "realtime_collect"
        shutil.copytree(ARM_DATA, run / "data")
        pcfg = _pretext_config(run, pretextDataDir=[str(run / "data")],
                               pretextModelLoadDir=str(ARM_VAR),
                               realTimeVec=True)
        script = iter(["", "r", "", "r", "z", "", "q"])
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            PretextTrainer(pcfg, device="cuda").manuallyCollectPretextData(
                input_fn=lambda: next(script))
        wall = time.perf_counter() - t0
        frame = run / "model" / "realtime_vec.png"
        ms = [1000 * t for p, t in records if p == str(frame)]
        img = _read_png(np, frame)
        print(f"realTimeVec [manual collection]: {len(ms)} frame rewrites "
              f"over 3 steps and the reset, {img.shape}; ms a frame p50 "
              f"{statistics.median(ms):.2f}; wall {wall:.2f} s", flush=True)
        kv.logkv("realtime_frame_ms_p50/manual_collection",
                 statistics.median(ms))
        if len(ms) != 4 or img.std() == 0:
            fail("realTimeVec did not rewrite the collection's frame")
    finally:
        restore()


def last_modules_phase(torch, np, mld):
    """Phase 36: the representation PNGs and realTimeVec's frames, each
    measurement logged through KVLogger into TensorBoard events (one dump
    a part) and read back."""
    from var_tpu_torch.utils.kvlogger import KVLogger
    from var_tpu_torch.utils.tb_writer import read_events

    shutil.rmtree(LAST_DIR, ignore_errors=True)
    kv = KVLogger(str(LAST_DIR / "kv"), formats=["csv", "json",
                                                  "tensorboard"])
    dumped = []
    for part in (representation_png_phase, realtime_phase):
        part(torch, np, mld, kv)
        dumped.append(kv.dumpkvs())
    (events,) = list((LAST_DIR / "kv" / "tb").glob("events.out.tfevents.*"))
    back = read_events(str(events))
    same = all(set(b[2]) == set(d) and all(
        abs(b[2][k] - float(np.float32(v))) <= 1e-6 * max(1.0, abs(v))
        for k, v in d.items()) for b, d in zip(back[1:], dumped))
    print(f"KVLogger: {len(dumped)} dumps, {len(back)} TensorBoard records "
          f"read back ({sum(len(d) for d in dumped)} scalars), equal: "
          f"{same}", flush=True)
    if len(back) != len(dumped) + 1 or not same:
        fail("the KVLogger's TensorBoard events do not read back")


# -- phase 37: meshShape across cards ------------------------------------------


def mesh_cards_phase(torch):
    """Phase 37: tools/mesh_cards.py over every visible card, or one line
    where there is one card. Its kernel launches join the kernels line."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"phase 37: meshShape across cards needs two or more cards; "
              f"{n} visible", flush=True)
        return
    from var_tpu_torch.tools import mesh_cards

    gc.collect()
    torch.cuda.empty_cache()
    rep = mesh_cards.run(str(RUN_DIR / "mesh_cards"), n)
    for k, v in rep["launches"].items():
        LAUNCHES[f"mesh_cards {k}"] = v
    if not rep["ok"]:
        fail("phase 37: a mesh_cards check failed")


# -- phase 38: the simulator adapters under stand-ins -------------------------

# each adapter's simBackend, its labelling stand-in's installer
# (tests/torch_adapter_standins.py) and its collection quotas: 192 triplets,
# so that a batch of 128 fills
ADAPTERS = {
    "arms": dict(backend="pybullet", install="install_labelling_pybullet"),
    "ai2thor": dict(backend="ithor", install="install_labelling_ai2thor"),
}
ADAPTER_QUOTA = [32, 32, 32, 32, 64]


def _adapter_frames(np, env, backend, n=200):
    """The adapter's get_image (the stand-in's frame, the crop and
    resize_linear_u8) per second, over n calls after a reset."""
    from var_tpu_torch.config import gym_register, main_config
    from var_tpu_torch.envs import make_entry_points

    cfg = main_config(env=env)
    cfg.override(simBackend=backend, RLTrain=True)
    gym_register(cfg, env=env)
    sim = make_entry_points(cfg, env)[1](cfg)
    sim.seed(0)
    sim.reset()
    t0 = time.perf_counter()
    frames = [sim.get_image() for _ in range(n)]
    rate = n / (time.perf_counter() - t0)
    sim.close()
    if frames[-1].shape != (96, 96, 3) or frames[-1].dtype != np.uint8:
        fail(f"the {env} adapter's frame is {frames[-1].shape}")
    return rate


def adapter_path(torch, np, mld, kernel, env):
    """Phase 38 for one adapter, its stand-in installed: collection through
    the adapter, 3 VAR epochs at batch 128 through the kernel, 2 fused PPO
    updates, testRL over 8 episodes (the main path, its launches counted
    from 0), then the refusal of RLDeviceSimEval, the kernel on the path's
    first input against its plain version and the fused step and update,
    card against CPU."""
    from var_tpu_torch.ops import audio
    from var_tpu_torch.pretext import main as pretext_main
    from var_tpu_torch.rl import main as rl_main
    from var_tpu_torch.train import pretext as tpretext
    from var_tpu_torch.train.rl import RLTrainer

    prof, run = PROFILES[env], RUN_DIR / "adapters" / env
    backend, steps = ADAPTERS[env]["backend"], prof["steps"]
    frames = _adapter_frames(np, env, backend)

    collect = tpretext.PretextTrainer.collectPretextData
    seconds = []

    def timed_collect(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = collect(self, *args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    seen = {}
    undo = _capture_stft(audio, seen)
    tpretext.PretextTrainer.collectPretextData = timed_collect
    mld.mel_log_dct.launches = 0
    try:
        trainer = pretext_main([
            "--env", env, "--set", f'simBackend="{backend}"',
            f'pretextDataDir=["{run / "data"}"]',
            f'pretextModelSaveDir="{run / "model"}"',
            'audioBackend="pallas"', "pretextModelFineTune=False",
            'pretextDataset="VARDataset"', 'vecEnvBackend="dummy"',
            f"pretextCollectNum={ADAPTER_QUOTA}", "pretextEpoch=3",
            "pretextModelSaveInterval=3"])
        rl_dir = run / "rl_model"
        rl_trainer = rl_main([
            "--env", env, "--set", f'simBackend="{backend}"',
            f'pretextModelLoadDir="{run / "model" / "2"}"',
            f'RLModelSaveDir="{rl_dir}"', "RLTrain=True",
            "RLModelFineTune=False", 'vecEnvBackend="dummy"',
            f"RLTotalSteps={2 * 8 * steps}", "RLModelSaveInterval=1",
            "RLLogInterval=1"])
        cfg = copy.deepcopy(rl_trainer.config)
        cfg.override(RLTrain=False)
        if prof["eval_per_class"]:
            cfg.override(testEpisodesPerClass=2)
        evaluator = RLTrainer(cfg, device="cuda")
        evaluator.load_pretext()
        path = rl_dir / "00001"
        t0 = time.perf_counter()
        rate = evaluator.testRL(num_episodes=8, policy_path=str(path),
                                num_envs=4)
        eval_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        tpretext.PretextTrainer.collectPretextData = collect
        undo()
    launches = LAUNCHES[f"adapters_{env}"] = mld.mel_log_dct.launches

    tcfg, rcfg = trainer.config, rl_trainer.config
    shapes = sorted(set(seen["shapes"]))
    want_shape = (128, prof["sound"][1] + 1, 257)
    triplets = sum(ADAPTER_QUOTA)
    print(f"adapters [{env}]: simBackend {tcfg.simBackend!r} on the "
          f"recording stand-in; frames/s {frames:.1f}; collection "
          f"{triplets} triplets in {seconds[0]:.3f} s = "
          f"{triplets / seconds[0]:.1f} triplets/s; {trainer.step} VAR "
          f"steps at batch {tcfg.pretextTrainBatchSize}, mel_log_dct "
          f"launches {launches} at {shapes}", flush=True)
    if tcfg.simBackend != backend or rcfg.simBackend != backend \
            or tcfg.pretextTrainBatchSize != 128 or trainer.step != 6 \
            or shapes != [want_shape] \
            or launches != 2 * trainer.step:
        fail(f"the {env} adapter's pretext did not run through the adapter "
             f"and the kernel at full width")
    updates = rl_trainer.update_stats
    env_rate = updates[1][0] / updates[1][1]
    print(f"adapters [{env}]: {len(updates)} fused PPO updates at "
          f"{_width(rcfg)}; env-steps/s at update 1 {env_rate:.1f}; "
          f"update seconds {[round(t, 5) for _, t in updates]}", flush=True)
    if len(updates) != 2 or _width(rcfg)[:3] != (8, steps, prof["gru"]):
        fail(f"the {env} adapter's PPO did not run at full width")
    with open(rl_dir / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in (
        "loss/value_loss", "loss/policy_loss", "loss/policy_entropy")]
    if len(rows) != 2 or not all(math.isfinite(v) for v in losses):
        fail(f"bad {env} adapter PPO losses {losses}")
    with open(rl_dir / f"test_{path.name}.csv") as f:
        episodes = list(csv.DictReader(f))
    print(f"adapters [{env}]: testRL {len(episodes)} episodes on 4 envs, "
          f"success rate {rate}, {eval_s:.3f} s (set-up included)",
          flush=True)
    if len(episodes) != 8 or not 0.0 <= rate <= 1.0:
        fail(f"bad {env} adapter eval output")

    cfg.override(RLDeviceSimEval=True)
    try:
        evaluator.testRL(num_episodes=8, policy_path=str(path))
        fail(f"RLDeviceSimEval ran on the {env} adapter's config")
    except ValueError as e:
        print(f"adapters [{env}]: RLDeviceSimEval refused: {e}", flush=True)

    power, params = seen[257]
    with torch.no_grad():
        got = mld.mel_log_dct(power, params)
        want = mld.mel_log_dct_reference(power, params)
    err = (got - want).abs().max().item()
    print(f"adapters [{env}]: the kernel on the path's first input "
          f"{tuple(power.shape)}: max abs err {err:.3e}", flush=True)
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"the kernel disagrees with its plain version on the {env} "
             f"adapter's path")
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)

    from var_tpu_torch.config import main_config
    from var_tpu_torch.tools.rl_check import card_against_cpu

    check = main_config(env=env)
    check.override(simBackend=backend, RLTrain=True, ppoNumSteps=10,
                   RLEnvMaxSteps=5, vecEnvBackend="dummy")
    report = card_against_cpu(check)
    print(f"adapters [{env}]: card vs cpu (8 envs x 10 steps, full "
          f"width): {report}", flush=True)
    if not report["ok"]:
        fail(f"the {env} adapter's fused step or update differs between "
             f"the card and the CPU")
    return dict(frames=frames, triplets=triplets / seconds[0],
                env_steps=env_rate)


def adapters_phase(torch, np, mld, kernel):
    """Phase 38: both adapters, each under its labelling stand-in, which
    is taken out of sys.modules again after its path."""
    import types

    # tests/ of this checkout as the package `tests`, whatever else of that
    # name the machine has installed
    tests = types.ModuleType("tests")
    tests.__path__ = [str(ROOT / "tests")]
    sys.modules["tests"] = tests
    from tests import torch_adapter_standins as standins

    print("phase 38: the simulator adapters run on recording stand-ins "
          "(tests/torch_adapter_standins.py), not on PyBullet or AI2-THOR",
          flush=True)
    shutil.rmtree(RUN_DIR / "adapters", ignore_errors=True)
    for env, spec in ADAPTERS.items():
        patch = standins.SysModules()
        getattr(standins, spec["install"])(patch)
        try:
            adapter_path(torch, np, mld, kernel, env)
        finally:
            patch.undo()
        gc.collect()
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from var_tpu_torch.device import precision_flags, resolve_device
    from var_tpu_torch.ops import mel_log_dct as mld

    resolve_device("cuda")
    line = card_line()
    name = torch.cuda.get_device_name(0)
    flags = precision_flags()
    print(f"card: {name}; precision {flags}", flush=True)
    if any(v is True for v in flags.values()) \
            or flags["float32_matmul_precision"] != "highest":
        fail(f"the precision contract is not pinned: {flags}")

    from concurrent.futures import ThreadPoolExecutor

    from var_tpu_torch import native

    def timed(build, *args):
        t0 = time.perf_counter()
        build(*args, force=True)
        return time.perf_counter() - t0

    # the kernel (nvcc) and the host libraries (g++), all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = {"mel_log_dct": pool.submit(timed, mld.build),
                **{name: pool.submit(timed, native.build, name)
                   for name in ("simcore", "shmbuf")}}
        BUILDS.update({k: j.result() for k, j in jobs.items()})
    print(f"build: mel_log_dct.cu in {BUILDS['mel_log_dct']:.2f} s, "
          f"simcore.cpp in {BUILDS['simcore']:.2f} s, shmbuf.cpp in "
          f"{BUILDS['shmbuf']:.2f} s, {time.perf_counter() - t0:.2f} s in all",
          flush=True)

    bw, flops = peaks(line)
    kernel = check_mel_log_dct(torch, np, bw, flops)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    for env in ("arms", "ai2thor"):
        t_env = time.perf_counter()
        run_profile(torch, np, mld, env, kernel)
        print(f"{env}: all phases in {time.perf_counter() - t_env:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    slice6_phases(torch, mld)
    print(f"phases 20-23 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    slice7_phases(torch, np, mld, kernel, bw, flops)
    print(f"phases 24-28 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    slice8_phases(torch, np, mld, kernel)
    print(f"phases 29-32 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    manual_phase(torch, np, mld)
    print(f"phase 33 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bf16_phase(torch, mld)
    print(f"phase 34 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mesh_phase(torch, mld, line)
    print(f"phase 35 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    last_modules_phase(torch, np, mld)
    print(f"phase 36 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mesh_cards_phase(torch)
    print(f"phase 37 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    adapters_phase(torch, np, mld, kernel)
    print(f"phase 38 in {time.perf_counter() - t0:.1f} s", flush=True)

    stop_children()  # before the result: nothing outlives the script
    kernel["launches_by_path"] = dict(LAUNCHES)
    print(line)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def stop_children():
    """Stop every process the script started, before it exits, pass or
    fail. The paths close the env workers they start; what stays is the
    multiprocessing forkserver and resource tracker, which would outlive the
    script until each saw its end: both are stopped and waited for here.
    Any other live descendant is a worker that was not closed: it is killed,
    and the run fails."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    servers = {forkserver._forkserver._forkserver_pid,
               resource_tracker._resource_tracker._pid}
    leaked = [pid for pid in _descendants() if pid not in servers]
    for pid in leaked:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    forkserver._forkserver._stop()  # closes its pipe, waits for its exit
    for pid in leaked:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:  # the forkserver's child, reaped there
            pass
    resource_tracker._resource_tracker._stop()
    left = _descendants()
    if leaked or left:
        fail(f"processes still running at the end: {leaked} killed, "
             f"{left} left")


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
