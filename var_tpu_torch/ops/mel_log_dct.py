"""mel -> log -> DCT over a power spectrogram: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (csrc/mel_log_dct.cu) replaces the Pallas TPU kernel
var_tpu/ops/audio_pallas.py::_mel_log_dct. It is built with nvcc for
sm_90a into build/var_tpu_torch/ at first use, from the sources in the
checkout, and called through a plain C entry point with ctypes.

The kernel sums each mel filter over its band only: `band_table` packs the
non-zero span of every column of the float32 filterbank, which the plain
version multiplies densely, and `kernel_table` lays the spans out for the
kernel's warps. `dct_half` keeps the half of the DCT that its symmetry
leaves to compute with.

`mel_log_dct` takes a (B, T, F) float32 tensor in one of two layouts: the
contiguous one, and the transposed view that the gemm STFT returns, whose
(B, F, T) storage is contiguous. It sends a CPU tensor to the plain version,
and a CUDA tensor to the kernel or raises: there is no fallback on the card.
Each kernel launch adds one to `mel_log_dct.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .audio import (LOG_EPS, N_MELS, N_MFCC, STFTParams, _frontend_constants,
                    torch_constants)

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mel_log_dct.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "var_tpu_torch"
_LIBRARY = BUILD_DIR / "libmel_log_dct.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
KERNEL_WARPS = 10  # kWarps of csrc/mel_log_dct.cu, which the table follows


def mel_log_dct_reference(power: torch.Tensor,
                          params: STFTParams) -> torch.Tensor:
    """Plain version: log(power @ mel + 1e-6) @ dct. (B, T, F) -> (B, T, 40)."""
    _, mel, dct, _ = torch_constants(params, power.device)
    return torch.log(power @ mel + LOG_EPS) @ dct


def band_table(mel: np.ndarray):
    """Pack each filter (column of `mel`, (F, n_mels)) as the span from its
    first to its last non-zero bin. Returns (lo, length, offset, weights):
    three int32 (n_mels,) arrays and the spans' weights end to end, float32.
    Summing only over [lo, lo + length) gives exactly the dense products
    that can be non-zero. Raises ValueError for an all-zero filter."""
    mel = np.asarray(mel, np.float32)
    lo, length, spans = [], [], []
    for m in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, m])
        if nz.size == 0:
            raise ValueError(f"mel filter {m} is all zero")
        lo.append(nz[0])
        length.append(nz[-1] - nz[0] + 1)
        spans.append(mel[nz[0]: nz[-1] + 1, m])
    length = np.asarray(length, np.int32)
    offset = np.concatenate([[0], np.cumsum(length)[:-1]]).astype(np.int32)
    return (np.asarray(lo, np.int32), length, offset,
            np.concatenate(spans).astype(np.float32))


def kernel_table(mel: np.ndarray, warps: int = KERNEL_WARPS):
    """The band table as the kernel reads it. Each filter's span is padded
    with zero weights to a multiple of 4 bins (at its end, or at its start
    where the end would pass the last bin), so that the kernel reads its
    weights 4 at a time from 16-byte aligned offsets; zero weights add
    nothing to a finite row's sums. Filters are dealt to `warps` warps of
    n_mels / warps slots each, longest first to the least loaded warp.
    Returns (table, weights): int32 rows (m, lo, length, offset), warp by
    warp, followed by the bins that no padded span covers ("holes", which
    the kernel still reads for its finiteness check); and the float32
    weights."""
    lo, length, offset, weights = band_table(mel)
    n_freq, n_mels = mel.shape
    per_warp = n_mels // warps
    if per_warp * warps != n_mels:
        raise ValueError(f"{n_mels} filters do not split over {warps} warps")
    spans = []
    for m in range(n_mels):
        padded = -(-int(length[m]) // 4) * 4
        start = int(lo[m]) if lo[m] + padded <= n_freq else n_freq - padded
        if start < 0:
            raise ValueError(f"filter {m} padded to {padded} bins exceeds F")
        w = np.zeros(padded, np.float32)
        w[lo[m] - start: lo[m] - start + length[m]] = \
            weights[offset[m]: offset[m] + length[m]]
        spans.append((m, start, w))
    load = [0] * warps
    slots = [[] for _ in range(warps)]
    for m, start, w in sorted(spans, key=lambda s: (-len(s[2]), s[0])):
        k = min((k for k in range(warps) if len(slots[k]) < per_warp),
                key=lambda k: (load[k], k))
        slots[k].append((m, start, w))
        load[k] += len(w)
    rows, packed, off = [], [], 0
    for m, start, w in (e for warp in slots for e in warp):
        rows.append((m, start, len(w), off))
        packed.append(w)
        off += len(w)
    covered = np.zeros(n_freq, bool)
    for _, start, w in spans:
        covered[start: start + len(w)] = True
    holes = np.flatnonzero(~covered).astype(np.int32)
    table = np.concatenate([np.asarray(rows, np.int32).ravel(), holes])
    return table, np.concatenate(packed)


def dct_half(dct: np.ndarray, warps: int = KERNEL_WARPS) -> np.ndarray:
    """The DCT rows the kernel needs. The DCT-II basis is even (odd) in the
    mel index for even (odd) k: dct[39 - n, k] = (-1)^k dct[n, k], so the
    kernel sums 20 terms lmel[n] +- lmel[39 - n] per output instead of 40.
    Returns float32 (warps, 20, per_warp): warp w's coefficients dct[n, k]
    for its outputs k = w + warps * j. Raises if `dct` lacks the symmetry."""
    dct = np.asarray(dct, np.float32)
    n_mels, n_mfcc = dct.shape
    sign = np.where(np.arange(n_mfcc) % 2 == 0, 1.0, -1.0).astype(np.float32)
    if n_mels % 2 or np.abs(dct[::-1] - dct * sign).max() > 1e-6:
        raise ValueError("dct is not a DCT-II basis (even/odd in the mel index)")
    per_warp = n_mfcc // warps
    k = np.arange(warps)[:, None] + warps * np.arange(per_warp)[None, :]
    return np.ascontiguousarray(dct[: n_mels // 2][:, k].transpose(1, 0, 2))


@functools.lru_cache(maxsize=16)
def kernel_constants(params: STFTParams, device: torch.device):
    """kernel_table and dct_half of the float32 filterbank and DCT that
    torch_constants uses, on `device`: (table, weights, dct_half)."""
    _, _, mel, dct, _, _ = _frontend_constants(params, "float32")
    table, weights = kernel_table(mel)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (table, weights, dct_half(dct)))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc") or (
        candidate if os.path.exists(candidate) else None)
    if found is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin); the "
                           "mel_log_dct kernel cannot be built")
    return found


def build(force: bool = False) -> Path:
    """Compile csrc/mel_log_dct.cu into the shared library unless an
    up-to-date one exists. Returns the library's path; raises with nvcc's
    output if the build fails."""
    if (not force and _LIBRARY.exists()
            and _LIBRARY.stat().st_mtime >= _SOURCE.stat().st_mtime):
        return _LIBRARY
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _LIBRARY)  # atomic: a concurrent loader never sees half
    return _LIBRARY


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    # F, n_weights, n_holes, freq_major, warps, max_blocks (out)
    lib.mel_log_dct_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    # power, table, n_holes, weights, n_weights, dct_half, out, B, T, F,
    # freq_major, max_blocks, stream
    lib.mel_log_dct_launch.argtypes = [p, p, i, p, i, p, p, i, i, i, i, i, p]
    for fn in (lib.mel_log_dct_plan, lib.mel_log_dct_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=16)
def _grid_limit(params: STFTParams, device: torch.device,
                freq_major: bool) -> int:
    """Blocks of the kernel's persistent grid, as many as fit on the card at
    once, worked out once per (params, device, layout) so that a launch
    makes no query of the card."""
    table, weights, _ = kernel_constants(params, device)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().mel_log_dct_plan(
            params.n_fft // 2 + 1, weights.numel(), table.numel() - 4 * N_MELS,
            int(freq_major), KERNEL_WARPS, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mel_log_dct kernel plan failed: cudaError {err}")
    return blocks.value


def _freq_major(power: torch.Tensor) -> bool:
    """True for the gemm STFT's view, whose (B, F, T) storage is contiguous;
    False for a contiguous (B, T, F) tensor; raises for any other layout."""
    if power.is_contiguous():
        return False
    if power.transpose(1, 2).is_contiguous():
        return True
    raise ValueError(
        f"mel_log_dct takes a contiguous (B, T, F) tensor or the transposed "
        f"view of a contiguous (B, F, T) one; got strides {power.stride()}")


def _check(power: torch.Tensor, params: STFTParams) -> bool:
    if power.dtype != torch.float32:
        raise TypeError(f"mel_log_dct takes float32, got {power.dtype}")
    if power.dim() != 3:
        raise ValueError(f"mel_log_dct takes (B, T, F), got {tuple(power.shape)}")
    if power.shape[-1] != params.n_fft // 2 + 1:
        raise ValueError(
            f"F = {power.shape[-1]} but n_fft {params.n_fft} gives "
            f"{params.n_fft // 2 + 1} bins")
    freq_major = _freq_major(power)
    if power.requires_grad:
        raise RuntimeError("mel_log_dct has no backward (the MFCC frontend "
                           "takes no gradient); detach the input")
    if power.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mel_log_dct runs on cpu or cuda, not {power.device}")
    return freq_major


def mel_log_dct(power: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """(B, T, F) float32 power -> (B, T, 40) MFCC."""
    freq_major = _check(power, params)
    if power.device.type == "cpu":
        return mel_log_dct_reference(power, params)
    B, T, F = power.shape
    if B * T * F >= 2 ** 31:
        raise ValueError("power has more elements than the kernel's int range")
    table, weights, dct = kernel_constants(params, power.device)
    max_blocks = _grid_limit(params, power.device, freq_major)
    out = torch.empty((B, T, N_MFCC), dtype=torch.float32, device=power.device)
    with torch.cuda.device(power.device):
        stream = torch.cuda.current_stream(power.device).cuda_stream
        err = _library().mel_log_dct_launch(
            power.data_ptr(), table.data_ptr(), table.numel() - 4 * N_MELS,
            weights.data_ptr(), weights.numel(), dct.data_ptr(),
            out.data_ptr(), B, T, F, int(freq_major), max_blocks, stream)
    if err != 0:
        raise RuntimeError(f"mel_log_dct kernel launch failed: cudaError {err}")
    mel_log_dct.launches += 1
    return out


mel_log_dct.launches = 0
