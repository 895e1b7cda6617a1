"""GRU recurrences (port of var_tpu/ops/gru.py).

- The recurrent policy: torch.nn.GRU cannot reset its hidden state inside a
  sequence, so the scan is a Python loop over gru_cell that multiplies the
  carried state by the done-mask before every step (1.0 keeps it, 0.0
  resets at an episode start). The input projection of all T steps is one
  matrix product before the loop.
- The ai2thor sound encoder's bidirectional GRU (`bigru_final`): no mask,
  so it is one call of torch's own GRU (`torch._VF.gru`, what nn.GRU
  calls), which runs cuDNN's RNN on the card. A Python loop would launch
  about ten kernels per step and direction, 73 steps x 2 directions x 2
  sounds forward and again backward in every pretext step. The
  JAX package computes this GRU in lax.scan, outside any Pallas kernel.
  cuDNN honours torch.backends.cudnn.allow_tf32, which
  var_tpu_torch.device sets to False, so it runs in IEEE float32.

Gate math (torch convention, gates ordered r, z, n):
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh   (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
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


def bigru_final(fwd: GRUParams, bwd: GRUParams, xs_btd: torch.Tensor
                ) -> torch.Tensor:
    """Bidirectional GRU returning concat(final_fwd, final_bwd): the
    forward state after t = T-1 and the backward state after t = 0.
    xs_btd: (B, T, D) batch-first input. Returns (B, 2H)."""
    B, H = xs_btd.shape[0], fwd.hidden_size
    h0 = xs_btd.new_zeros(2, B, H)
    flat = [fwd.w_ih, fwd.w_hh, fwd.b_ih, fwd.b_hh,
            bwd.w_ih, bwd.w_hh, bwd.b_ih, bwd.b_hh]
    # args: has_biases, num_layers, dropout, train, bidirectional,
    # batch_first; `train` keeps cuDNN's workspace for the backward pass
    _, h_n = torch._VF.gru(xs_btd, h0, flat, True, 1, 0.0,
                           torch.is_grad_enabled(), True, True)
    return torch.cat([h_n[0], h_n[1]], dim=1)
