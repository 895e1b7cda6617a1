"""Loss functions (port of var_tpu/ops/losses.py)."""
from __future__ import annotations

import torch


def pairwise_distance(x1: torch.Tensor, x2: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """||x1 - x2 + eps||_2 rowwise (eps added to the difference, as in
    torch.nn.functional.pairwise_distance)."""
    return torch.linalg.vector_norm(x1 - x2 + eps, ord=2, dim=-1)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor,
                        margin: float = 1.0) -> torch.Tensor:
    """TripletMarginLoss(margin, p=2) with mean reduction."""
    d_pos = pairwise_distance(anchor, positive)
    d_neg = pairwise_distance(anchor, negative)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean()


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(sum(x^2) + eps^2), not F.normalize: the same value within
    float32 for non-degenerate rows, and a finite gradient at x == 0. An
    exactly-zero embedding does occur (the zero 'empty intent' sound
    through zero-initialised biases)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(sq + eps * eps)
