"""JAX-package parameters -> the port's state_dict (arm VAR).

Takes `variables["params"]` of var_tpu's VARPretextNet as a nested dict of
numpy arrays (numpy only: loading an Orbax checkpoint needs orbax, which
the GPU machine does not have) and returns a state_dict for
var_tpu_torch.models.encoders.VARPretextNet:

- conv kernels HWIO -> OIHW;
- dense kernels (in, out) -> (out, in);
- the first dense layer of each head reads a flattened conv output. JAX
  flattens NHWC, the port flattens CHW, so its input rows are permuted by
  flatten_perm(3, 3, 64) (image) and flatten_perm(5, 1, 32) (sound).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def flatten_perm(h: int, w: int, c: int) -> np.ndarray:
    """perm[i_chw] = i_hwc: the HWC-flatten index of each CHW-flatten index."""
    idx = np.arange(h * w * c).reshape(h, w, c)
    return np.transpose(idx, (2, 0, 1)).reshape(-1)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(sd: dict, name: str, p: Mapping):
    sd[f"{name}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]),
                                                (3, 2, 0, 1)))
    sd[f"{name}.bias"] = _tensor(p["bias"])


def _dense(sd: dict, name: str, p: Mapping, perm: Optional[np.ndarray] = None):
    k = np.asarray(p["kernel"])
    if perm is not None:
        k = k[perm]
    sd[f"{name}.weight"] = _tensor(k.T)
    sd[f"{name}.bias"] = _tensor(p["bias"])


def arm_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """var_tpu arm VARPretextNet params -> VARPretextNet.state_dict()."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        _conv(sd, f"img_branch.convs.{i}", params["img_branch"][f"Conv_{i}"])
    for i in range(4):
        _conv(sd, f"sound_branch.convs.{i}",
              params["sound_branch"][f"Conv_{i}"])
    for head, perm in (("img_triplet", flatten_perm(3, 3, 64)),
                       ("sound_triplet", flatten_perm(5, 1, 32))):
        _dense(sd, f"{head}.layers.0", params[head]["Dense_0"], perm)
        _dense(sd, f"{head}.layers.1", params[head]["Dense_1"])
    return sd
