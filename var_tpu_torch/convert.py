"""JAX-package parameters -> the port's state_dicts (the arm and ai2thor
VARs and policies).

Takes `variables["params"]` of var_tpu's VARPretextNet or Policy as a
nested dict of numpy arrays (numpy only: loading an Orbax checkpoint needs
orbax, which the GPU machine does not have) and returns a state_dict for
var_tpu_torch's VARPretextNet or Policy:

- conv kernels HWIO -> OIHW;
- dense kernels (in, out) -> (out, in);
- the first dense layer after a conv stack reads a flattened conv output.
  JAX flattens NHWC, the port flattens CHW, so its input rows are permuted
  by flatten_perm: (3, 3, 64) for the arm VAR's image head, (5, 1, 32)
  for its sound head, (3, 3, 128) for the ai2thor VAR's image head and for
  both policies' cnnMlp at 96x96, (3, 3, 32) for the ai2thor policy's
  occMlp;
- the GRUs' w_ih / w_hh / b_ih / b_hh (the policy's, the CRNN's forward
  and backward) are already in torch layout; the CRNN's sequence is built
  in the JAX package's (W, C) order (models/encoders.py), so its w_ih
  needs no permutation.
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


def ai2thor_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """var_tpu ai2thor VARPretextNet params -> VARPretextNet('ai2thor')
    .state_dict()."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(6):
        _conv(sd, f"img_branch.convs.{i}", params["img_branch"][f"Conv_{i}"])
    snd = params["sound_branch"]
    for i in range(3):
        _conv(sd, f"sound_branch.convs.{i}", snd[f"Conv_{i}"])
    for d in ("fwd", "bwd"):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            name = f"gru_{d}_{k}"
            sd[f"sound_branch.{name}"] = _tensor(snd[name])
    _dense(sd, "img_triplet.layers.0", params["img_triplet"]["Dense_0"],
           flatten_perm(3, 3, 128))
    _dense(sd, "img_triplet.layers.1", params["img_triplet"]["Dense_1"])
    for i in range(3):
        _dense(sd, f"sound_triplet.layers.{i}",
               params["sound_triplet"][f"Dense_{i}"])
    return sd


def arm_policy_state_dict(params: Mapping, img_dim=(3, 96, 96)
                          ) -> Dict[str, torch.Tensor]:
    """var_tpu arm Policy params -> var_tpu_torch Policy.state_dict()."""
    from var_tpu_torch.models.policy import conv_grid

    c, h, w = conv_grid(img_dim)
    return _policy_state_dict(params, {}, {"cnnMlp_0": flatten_perm(h, w, c)})


def ai2thor_policy_state_dict(params: Mapping, img_dim=(3, 96, 96),
                              occupancy_grid: int = 9
                              ) -> Dict[str, torch.Tensor]:
    """var_tpu ai2thor Policy params -> var_tpu_torch Policy.state_dict().
    The JAX base's Conv_0-5 are the image stack, Conv_6-7 the occupancy
    stack."""
    from var_tpu_torch.models.policy import (
        AI2THOR_CONVS,
        OCCUPANCY_CONVS,
        conv_grid,
    )

    c, h, w = conv_grid(img_dim, AI2THOR_CONVS)
    oc, oh, ow = conv_grid((1, occupancy_grid, occupancy_grid),
                           OCCUPANCY_CONVS)
    return _policy_state_dict(
        params, {6: "occ_convs.0", 7: "occ_convs.1"},
        {"cnnMlp_0": flatten_perm(h, w, c),
         "occMlp_0": flatten_perm(oh, ow, oc)})


def _policy_state_dict(params: Mapping, conv_names: Mapping[int, str],
                       perms: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """Conv_i -> base.convs.i unless `conv_names` maps i elsewhere; every
    dense `<name>_<i>` -> base.<name>.<i>, its input rows permuted by
    `perms[name_i]` where given."""
    base = params["base"]
    sd: Dict[str, torch.Tensor] = {}
    n_convs = sum(1 for k in base if k.startswith("Conv_"))
    for i in range(n_convs):
        _conv(sd, "base." + conv_names.get(i, f"convs.{i}"),
              base[f"Conv_{i}"])
    for name in base:
        if name.startswith("Conv_") or name == "gru":
            continue
        prefix, _, idx = name.rpartition("_")
        if name == "critic_linear":
            key = "base.critic_linear"
        else:
            key = f"base.{prefix}.{idx}"
        _dense(sd, key, base[name], perms.get(name))
    if "gru" in base:
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            sd[f"base.gru.{k}"] = _tensor(base["gru"][k])
    head = params["dist_head"]
    _dense(sd, "dist_head.linear", head["Dense_0"])
    if "logstd" in head:
        sd["dist_head.logstd"] = _tensor(head["logstd"])
    return sd
