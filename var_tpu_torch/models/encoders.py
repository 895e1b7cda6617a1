"""VAR pretext encoders (port of var_tpu/models/encoders.py).

An image CNN and a sound CNN (arm) or CRNN (ai2thor), each followed by an
MLP head, both projected onto the unit sphere. NCHW throughout, which is
also the JAX package's public layout, so inputs compare like with like.
The flattened conv features are in torch's CHW order; convert.py permutes
the first dense layer of each head when it loads the JAX package's
parameters. The CRNN's conv output is permuted to (B, T, W, C) before it
becomes the GRU's (B, T, W*C) sequence, which is the JAX package's NHWC
order, so the GRU's weights need no permutation.

Parameters start the way flax initialises them (truncated-normal
lecun kernels, zero biases) so that a port run trains from the same kind
of start; the draws come from a torch.Generator and differ from JAX's.

computeDtype='bfloat16' follows flax's `promote_dtype` for a Conv or Dense
with `dtype=bfloat16`: the layer's input, kernel and bias are cast to
bf16, the product is rounded to bf16 before the bias is added, and ReLU
and max-pool run on bf16. Explicit casts, not torch.autocast, which picks
its own dtype per op. The parameters stay float32 and their gradients
come back float32 through the casts. Each head's output is cast to
float32 before the L2 norm; the CRNN's GRU runs in float32 between its
bf16 convs and its bf16 head.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.ops.gru import GRUParams, bigru_final
from var_tpu_torch.ops.losses import l2_normalize


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config) -> torch.dtype:
    """The config's computeDtype as a torch dtype."""
    name = getattr(config, "computeDtype", "float32")
    if name not in COMPUTE_DTYPES:
        raise ValueError(
            f"computeDtype={name!r}; have {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def conv(layer: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`layer(x)`; at another dtype, flax's Conv at that dtype: input,
    kernel and bias cast, the product rounded before the bias is added."""
    if dtype == torch.float32:
        return layer(x)
    y = F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride,
                 layer.padding)
    return y + layer.bias.to(dtype)[:, None, None]


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`layer(x)`; at another dtype, flax's Dense at that dtype."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


@torch.no_grad()
def flax_default_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None):
    """flax's defaults on every Conv2d and Linear of `module`: lecun_normal
    kernels (truncated normal, variance 1/fan_in), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # flax's truncated_normal rescales so the variance is exactly
            # 1/fan_in after truncation at two std
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
    return module


class ArmImageBranch(nn.Module):
    """5x (3x3 stride-2 conv + ReLU): (3,96,96) -> (64,3,3) -> flatten."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = (3, 32, 32, 64, 64, 64)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
            for i in range(5))

    def forward(self, x):
        for layer in self.convs:
            x = F.relu(conv(layer, x, self.dtype))
        return x.flatten(1)  # (B, 64*3*3)


class ArmSoundBranch(nn.Module):
    """Conv stack over (1,100,40) MFCC collapsing the feature axis:
    (1,100,40) -> (32,48,1) -> ... -> (32,5,1) -> flatten."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            [nn.Conv2d(1, 32, (5, 40), stride=(2, 1))]
            + [nn.Conv2d(32, 32, (3, 1), stride=(2, 1)) for _ in range(3)])

    def forward(self, x):
        for layer in self.convs:
            x = F.relu(conv(layer, x, self.dtype))
        return x.flatten(1)  # (B, 32*5*1)


class AI2ThorImageBranch(nn.Module):
    """VGG-ish 6-conv/4-maxpool stack: (3,96,96) -> (128,3,3) -> flatten."""

    # (out_channels, stride) of each 3x3 conv; a 2x2 max-pool follows
    # convs 1-4
    LAYERS = ((32, 1), (32, 1), (64, 1), (64, 1), (128, 1), (128, 2))

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = (3,) + tuple(c for c, _ in self.LAYERS)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=s, padding=1)
            for i, (_, s) in enumerate(self.LAYERS))

    def forward(self, x):
        for i, layer in enumerate(self.convs):
            x = F.relu(conv(layer, x, self.dtype))
            if 1 <= i <= 4:
                x = F.max_pool2d(x, 2)  # 48, 24, 12, 6
        return x.flatten(1)  # (B, 128*3*3)


class AI2ThorSoundBranch(nn.Module):
    """CRNN: 3 convs over (1,600,40) -> (64, 73, 7) -> the (73, 7*64)
    sequence in (W, C) order -> BiGRU(448 -> 512), the concat of the final
    forward and backward states -> (B, 1024)."""

    HIDDEN = 512

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([
            nn.Conv2d(1, 64, (11, 11), stride=2, padding=(5, 5)),
            nn.Conv2d(64, 64, (11, 5), stride=2, padding=(5, 5)),
            nn.Conv2d(64, 64, (7, 3), stride=2, padding=(1, 1)),
        ])
        h, d = self.HIDDEN, 7 * 64
        for name in ("fwd", "bwd"):
            for k, shape in (("w_ih", (3 * h, d)), ("w_hh", (3 * h, h)),
                             ("b_ih", (3 * h,)), ("b_hh", (3 * h,))):
                setattr(self, f"gru_{name}_{k}",
                        nn.Parameter(torch.empty(shape)))

    def _gru(self, name: str) -> GRUParams:
        return GRUParams(*(getattr(self, f"gru_{name}_{k}")
                           for k in ("w_ih", "w_hh", "b_ih", "b_hh")))

    @torch.no_grad()
    def reset_gru(self, generator: Optional[torch.Generator] = None):
        """U(-1/sqrt(H), 1/sqrt(H)), as the JAX package and nn.GRU."""
        s = 1.0 / math.sqrt(self.HIDDEN)
        for name in ("fwd", "bwd"):
            for p in self._gru(name):
                p.uniform_(-s, s, generator=generator)

    def forward(self, x):
        for layer in self.convs:
            x = F.relu(conv(layer, x, self.dtype))  # (B, 64, 73, 7) last
        seq = x.permute(0, 2, 3, 1).flatten(2)  # (B, 73, 7*64), (W, C) order
        return bigru_final(self._gru("fwd"), self._gru("bwd"),
                           seq.float()).to(self.dtype)


class TripletHead(nn.Module):
    """MLP projection head ending at representationDim, before the L2 norm.
    layers[i] holds the JAX package's Dense_i."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = (in_dim, *hidden, out_dim)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(dense(layer, x, self.dtype))
        return dense(self.layers[-1], x, self.dtype)


class VARPretextNet(nn.Module):
    """Shared VAR contract: encode_image / encode_sound both project onto
    the L2-normalised representation sphere. `variant` selects the arm
    conv/conv or the ai2thor conv/CRNN architecture."""

    def __init__(self, representation_dim: int = 3, variant: str = "arm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        if variant == "arm":
            self.img_branch = ArmImageBranch(dtype)
            self.sound_branch = ArmSoundBranch(dtype)
            self.img_triplet = TripletHead(64 * 3 * 3, (128,),
                                           representation_dim, dtype)
            self.sound_triplet = TripletHead(32 * 5, (128,),
                                             representation_dim, dtype)
        elif variant == "ai2thor":
            self.img_branch = AI2ThorImageBranch(dtype)
            self.sound_branch = AI2ThorSoundBranch(dtype)
            self.img_triplet = TripletHead(128 * 3 * 3, (128,),
                                           representation_dim, dtype)
            self.sound_triplet = TripletHead(
                2 * AI2ThorSoundBranch.HIDDEN, (128, 64), representation_dim,
                dtype)
        else:
            raise ValueError(variant)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax defaults: lecun_normal kernels, zero biases; the CRNN's GRU
        uniform as nn.GRU's."""
        flax_default_init_(self, generator)
        if self.variant == "ai2thor":
            self.sound_branch.reset_gru(generator)
        return self

    def encode_image(self, image):
        """image (B,3,96,96) in [0,1] -> (raw_feat, sphere_feat)."""
        raw = self.img_branch(image[:, :3])
        return raw, l2_normalize(self.img_triplet(raw).float())

    def encode_sound(self, sound):
        """sound (B,1,T,40) MFCC -> (raw_feat, sphere_feat)."""
        raw = self.sound_branch(sound)
        return raw, l2_normalize(self.sound_triplet(raw).float())

    def forward(self, image, sound_positive,
                sound_negative=None) -> Dict[str, torch.Tensor]:
        """Training forward over a triplet batch; the JAX package's output
        keys."""
        image_feat_raw, image_feat = self.encode_image(image)
        pos_raw, pos_feat = self.encode_sound(sound_positive)
        out = dict(image_feat=image_feat, image_feat_raw=image_feat_raw,
                   sound_feat_positive=pos_feat, pos_sound_raw=pos_raw)
        if sound_negative is not None:
            out["sound_feat_negative"] = self.encode_sound(sound_negative)[1]
        return out


def _builder(variant: str):
    def build(config) -> VARPretextNet:
        return VARPretextNet(config.representationDim, variant,
                             compute_dtype(config))

    return build


_MODEL_REGISTRY = {
    "arm_VARPretextNet": _builder("arm"),
    "ai2thor_VARPretextNet": _builder("ai2thor"),
}


def build_pretext_model(config) -> VARPretextNet:
    key = config.pretextModel
    if key not in _MODEL_REGISTRY:
        raise KeyError(
            f"Unknown pretext model {key!r}; have {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[key](config)
