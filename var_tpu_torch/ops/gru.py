"""GRU recurrence for the recurrent policy (port of var_tpu/ops/gru.py).

torch.nn.GRU cannot reset its hidden state inside a sequence, so the scan
is a Python loop over gru_cell that multiplies the carried state by the
done-mask before every step (1.0 keeps it, 0.0 resets at an episode
start). The input projection of all T steps is one matrix product before
the loop.

Gate math (torch convention, gates ordered r, z, n):
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh   (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h

The bidirectional `bigru_final` waits for the ai2thor CRNN (ROADMAP
"Modules left to port", item 7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GRUParams(NamedTuple):
    """Weights in torch layout: w_ih (3H, D), w_hh (3H, H), b_ih/b_hh (3H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[1]


def _cell(params: GRUParams, gi: torch.Tensor, h: torch.Tensor
          ) -> torch.Tensor:
    """One step from the input projection gi = x W_ih^T + b_ih."""
    H = params.hidden_size
    gh = torch.addmm(params.b_hh, h, params.w_hh.t())
    i_r, i_z, i_n = gi.split(H, dim=1)
    h_r, h_z, h_n = gh.split(H, dim=1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell(params: GRUParams, x: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
    """One step. x: (B, D), h: (B, H) -> h': (B, H)."""
    return _cell(params, torch.addmm(params.b_ih, x, params.w_ih.t()), h)


def gru_scan(params: GRUParams, xs: torch.Tensor, h0: torch.Tensor,
             masks: Optional[torch.Tensor] = None, reverse: bool = False):
    """Scan over time. xs: (T, B, D), h0: (B, H), masks: (T, B) or None.

    masks[t] multiplies the carried hidden state before step t. Returns
    (outputs (T, B, H), h_final (B, H))."""
    T, B = xs.shape[0], xs.shape[1]
    gi = torch.addmm(params.b_ih, xs.reshape(T * B, -1),
                     params.w_ih.t()).reshape(T, B, -1)
    h = h0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if masks is not None:
            h = h * masks[t][:, None]
        h = _cell(params, gi[t], h)
        ys[t] = h
    return torch.stack(ys), h
