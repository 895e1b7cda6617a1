"""mel -> log -> DCT over a power spectrogram: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (csrc/mel_log_dct.cu) replaces the Pallas TPU kernel
var_tpu/ops/audio_pallas.py::_mel_log_dct. It is built with nvcc for
sm_90a into build/var_tpu_torch/ at first use, from the sources in the
checkout, and called through a plain C entry point with ctypes.

`mel_log_dct` sends a CPU tensor to the plain version, and a CUDA tensor to
the kernel or raises: there is no fallback on the card. Each kernel launch
adds one to `mel_log_dct.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .audio import LOG_EPS, N_MFCC, STFTParams, torch_constants

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mel_log_dct.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "var_tpu_torch"
_LIBRARY = BUILD_DIR / "libmel_log_dct.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def mel_log_dct_reference(power: torch.Tensor,
                          params: STFTParams) -> torch.Tensor:
    """Plain version: log(power @ mel + 1e-6) @ dct. (B, T, F) -> (B, T, 40)."""
    _, mel, dct, _ = torch_constants(params, power.device)
    return torch.log(power @ mel + LOG_EPS) @ dct


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
    up-to-date one exists. Raises with nvcc's output if the build fails."""
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
    fn = lib.mel_log_dct_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(power: torch.Tensor, params: STFTParams):
    if power.dtype != torch.float32:
        raise TypeError(f"mel_log_dct takes float32, got {power.dtype}")
    if power.dim() != 3:
        raise ValueError(f"mel_log_dct takes (B, T, F), got {tuple(power.shape)}")
    if power.shape[-1] != params.n_fft // 2 + 1:
        raise ValueError(
            f"F = {power.shape[-1]} but n_fft {params.n_fft} gives "
            f"{params.n_fft // 2 + 1} bins")
    if not power.is_contiguous():
        raise ValueError("mel_log_dct takes a contiguous tensor")
    if power.requires_grad:
        raise RuntimeError("mel_log_dct has no backward (the MFCC frontend "
                           "takes no gradient); detach the input")
    if power.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mel_log_dct runs on cpu or cuda, not {power.device}")


def mel_log_dct(power: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """(B, T, F) float32 power -> (B, T, 40) MFCC."""
    _check(power, params)
    if power.device.type == "cpu":
        return mel_log_dct_reference(power, params)
    B, T, F = power.shape
    _, mel, dct, _ = torch_constants(params, power.device)
    out = torch.empty((B, T, N_MFCC), dtype=torch.float32, device=power.device)
    n_rows = B * T
    if n_rows >= 2 ** 31:
        raise ValueError("row count exceeds the kernel's int range")
    lib = _library()
    with torch.cuda.device(power.device):
        stream = torch.cuda.current_stream(power.device).cuda_stream
        err = lib.mel_log_dct_launch(
            power.data_ptr(), mel.data_ptr(), dct.data_ptr(), out.data_ptr(),
            n_rows, F, stream)
    if err != 0:
        raise RuntimeError(f"mel_log_dct kernel launch failed: cudaError {err}")
    mel_log_dct.launches += 1
    return out


mel_log_dct.launches = 0
