"""Device selection and the float32 precision contract.

The port is held against the JAX package at 1e-4 in float32. On Hopper two
PyTorch defaults would silently break that: cuDNN convolutions run in TF32
unless `torch.backends.cudnn.allow_tf32` is False (this covers the gemm
STFT's `conv1d` and every encoder conv), and a float32 matmul may use TF32
when the matmul precision is lowered. TF32 keeps about three decimal
digits, so `configure_precision` pins both to IEEE float32.

At computeDtype='bfloat16' a third default matters: cuBLAS may reduce a
bf16 product's partial sums in bf16
(`allow_bf16_reduced_precision_reduction`, True by default). The JAX
package's bf16 Dense sums in float32 and rounds once, so that is pinned
off too.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def configure_precision():
    """IEEE float32 for convolutions and matmuls (no TF32 anywhere); bf16
    matmuls sum in float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def precision_flags() -> dict:
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cuda.matmul.allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises; the port never
    carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    configure_precision()
    return dev
