"""Action distributions (port of var_tpu/models/distributions.py).

FixedCategorical / FixedNormal (DiagGaussian) / FixedBernoulli as plain
functions over a DistParams tuple, with the JAX package's shape
conventions:
- sample() returns (B, 1) for categorical, (B, A) for gaussian/bernoulli;
- log_probs() always returns (B, 1) (summed over action dims);
- entropy() returns (B,);
- mode() = argmax / mean / probs > 0.5.

sample() draws from a torch.Generator, or takes the draw itself as
`noise`: standard-normal eps (gaussian), Gumbel noise added to the logits
(categorical, as jax.random.categorical does) or uniform u (bernoulli).
The tests pass JAX's draws through `noise`, since the two frameworks'
random streams differ.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LOG_2PI = float(np.log(2.0 * np.pi))


class DistParams(NamedTuple):
    """Distribution activation for one batch: either logits or mean+logstd."""

    kind: str  # 'categorical' | 'gaussian' | 'bernoulli'
    logits: Optional[torch.Tensor] = None  # (B, A) categorical/bernoulli
    mean: Optional[torch.Tensor] = None  # (B, A) gaussian
    logstd: Optional[torch.Tensor] = None  # (A,) or (B, A)


def _draw_shape(dist: DistParams):
    ref = dist.mean if dist.kind == "gaussian" else dist.logits
    return ref.shape, ref.dtype, ref.device


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)), the categorical's `noise`."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def draw_noise(dist: DistParams, generator: Optional[torch.Generator] = None,
               rows: Optional[int] = None) -> torch.Tensor:
    """The `noise` a sample of `dist` takes, drawn from `generator`; `rows`
    rows in place of the batch's (a sharded batch draws every rank's rows
    and keeps its block)."""
    shape, dtype, device = _draw_shape(dist)
    if rows is not None:
        shape = (rows,) + tuple(shape[1:])
    if dist.kind == "gaussian":
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    if dist.kind == "categorical":
        return gumbel_noise(shape, generator, dtype, device)
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def sample(dist: DistParams, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw from `dist`, from `generator` (on the tensors' device) or
    from the given `noise` (see the module docstring)."""
    if noise is None:
        noise = draw_noise(dist, generator)
    if dist.kind == "categorical":
        a = torch.argmax(dist.logits + noise, dim=-1)
        return a[:, None].to(torch.int32)
    if dist.kind == "gaussian":
        return dist.mean + torch.exp(dist.logstd) * noise
    if dist.kind == "bernoulli":
        return (noise < torch.sigmoid(dist.logits)).to(torch.float32)
    raise ValueError(dist.kind)


def mode(dist: DistParams) -> torch.Tensor:
    if dist.kind == "categorical":
        return torch.argmax(dist.logits, dim=-1)[:, None].to(torch.int32)
    if dist.kind == "gaussian":
        return dist.mean
    if dist.kind == "bernoulli":
        return (torch.sigmoid(dist.logits) > 0.5).to(torch.float32)
    raise ValueError(dist.kind)


def log_probs(dist: DistParams, actions: torch.Tensor) -> torch.Tensor:
    """(B, 1) summed log probability."""
    if dist.kind == "categorical":
        logp = F.log_softmax(dist.logits, dim=-1)
        a = actions.reshape(actions.shape[0]).long()
        return torch.gather(logp, -1, a[:, None])
    if dist.kind == "gaussian":
        var = torch.exp(2.0 * dist.logstd)
        lp = (-((actions - dist.mean) ** 2) / (2.0 * var) - dist.logstd
              - 0.5 * LOG_2PI)
        return torch.sum(lp, dim=-1, keepdim=True)
    if dist.kind == "bernoulli":
        lp = (actions * F.logsigmoid(dist.logits)
              + (1.0 - actions) * F.logsigmoid(-dist.logits))
        return torch.sum(lp.reshape(actions.shape[0], -1), dim=-1,
                         keepdim=True)
    raise ValueError(dist.kind)


def entropy(dist: DistParams) -> torch.Tensor:
    """(B,) entropy (summed over action dims for gaussian/bernoulli)."""
    if dist.kind == "categorical":
        logp = F.log_softmax(dist.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)
    if dist.kind == "gaussian":
        ent = 0.5 + 0.5 * LOG_2PI + dist.logstd
        return torch.sum(ent.expand_as(dist.mean), dim=-1)
    if dist.kind == "bernoulli":
        p = torch.sigmoid(dist.logits)
        ent = -(p * F.logsigmoid(dist.logits)
                + (1 - p) * F.logsigmoid(-dist.logits))
        return torch.sum(ent, dim=-1)
    raise ValueError(dist.kind)


def orthogonal_linear(in_features: int, out_features: int, gain: float
                      ) -> nn.Linear:
    """Linear layer that `init_orthogonal` starts with orthogonal weights
    and a zero bias (the reference's init() helper)."""
    layer = nn.Linear(in_features, out_features)
    layer.orthogonal_gain = gain
    return layer


@torch.no_grad()
def init_orthogonal(module: nn.Module,
                    generator: Optional[torch.Generator] = None):
    """Orthogonal weights with each layer's gain, zero biases, for every
    layer made by orthogonal_linear inside `module`."""
    for m in module.modules():
        gain = getattr(m, "orthogonal_gain", None)
        if gain is not None:
            nn.init.orthogonal_(m.weight, gain, generator=generator)
            nn.init.zeros_(m.bias)


class CategoricalHead(nn.Module):
    """Linear(num_inputs -> n) with gain 0.01."""

    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.linear = orthogonal_linear(num_inputs, num_outputs, 0.01)

    def forward(self, x) -> DistParams:
        return DistParams(kind="categorical", logits=self.linear(x))


class DiagGaussianHead(nn.Module):
    """fc_mean (gain 1.0) + a learned, state-independent logstd vector."""

    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.linear = orthogonal_linear(num_inputs, num_outputs, 1.0)
        self.logstd = nn.Parameter(torch.zeros(num_outputs))

    def forward(self, x) -> DistParams:
        return DistParams(kind="gaussian", mean=self.linear(x),
                          logstd=self.logstd)


class BernoulliHead(nn.Module):
    def __init__(self, num_inputs: int, num_outputs: int):
        super().__init__()
        self.linear = orthogonal_linear(num_inputs, num_outputs, 1.0)

    def forward(self, x) -> DistParams:
        return DistParams(kind="bernoulli", logits=self.linear(x))


def make_head(action_space, num_inputs: int) -> nn.Module:
    """Head by action-space class, as the reference Policy does."""
    from var_tpu_torch.envs.spaces import Box, Discrete, MultiBinary

    if isinstance(action_space, Discrete):
        return CategoricalHead(num_inputs, action_space.n)
    if isinstance(action_space, Box):
        return DiagGaussianHead(num_inputs,
                                int(math.prod(action_space.shape)))
    if isinstance(action_space, MultiBinary):
        return BernoulliHead(num_inputs, action_space.n)
    raise NotImplementedError(type(action_space))
