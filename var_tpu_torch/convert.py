"""JAX-package parameters -> the port's state_dicts (arm VAR, arm policy).

Takes `variables["params"]` of var_tpu's VARPretextNet or Policy as a
nested dict of numpy arrays (numpy only: loading an Orbax checkpoint needs
orbax, which the GPU machine does not have) and returns a state_dict for
var_tpu_torch's VARPretextNet or Policy:

- conv kernels HWIO -> OIHW;
- dense kernels (in, out) -> (out, in);
- the first dense layer after a conv stack reads a flattened conv output.
  JAX flattens NHWC, the port flattens CHW, so its input rows are permuted
  by flatten_perm: (3, 3, 64) for the VAR image head, (5, 1, 32) for the
  sound head, (3, 3, 128) for the policy's cnnMlp at 96x96;
- the policy GRU's w_ih / w_hh / b_ih / b_hh are already in torch layout.
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


def arm_policy_state_dict(params: Mapping, img_dim=(3, 96, 96)
                          ) -> Dict[str, torch.Tensor]:
    """var_tpu arm Policy params -> var_tpu_torch Policy.state_dict()."""
    from var_tpu_torch.models.policy import conv_grid

    base = params["base"]
    sd: Dict[str, torch.Tensor] = {}
    n_convs = sum(1 for k in base if k.startswith("Conv_"))
    for i in range(n_convs):
        _conv(sd, f"base.convs.{i}", base[f"Conv_{i}"])
    c, h, w = conv_grid(img_dim)
    for name in base:
        if name.startswith("Conv_") or name == "gru":
            continue
        prefix, _, idx = name.rpartition("_")
        if name == "critic_linear":
            key = "base.critic_linear"
        else:
            key = f"base.{prefix}.{idx}"
        perm = flatten_perm(h, w, c) if name == "cnnMlp_0" else None
        _dense(sd, key, base[name], perm)
    if "gru" in base:
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            sd[f"base.gru.{k}"] = _tensor(base["gru"][k])
    head = params["dist_head"]
    _dense(sd, "dist_head.linear", head["Dense_0"])
    if "logstd" in head:
        sd["dist_head.logstd"] = _tensor(head["logstd"])
    return sd
