"""Return / advantage computation (port of var_tpu/ops/gae.py).

All four variants of the reference's RolloutStorage.compute_returns
(reference: models/ppo/storage.py:89-128): {GAE, discounted} x
{proper time limits via bad_masks, plain}, as a reverse Python loop over T
on (T, N) tensors.
"""
from __future__ import annotations

import torch


def compute_returns(
    rewards: torch.Tensor,      # (T, N)
    value_preds: torch.Tensor,  # (T+1, N); [T] is replaced by next_value
    masks: torch.Tensor,        # (T+1, N) 1.0 = not done at that boundary
    bad_masks: torch.Tensor,    # (T+1, N) 0.0 = time-limit truncation
    next_value: torch.Tensor,   # (N,)
    gamma: float,
    gae_lambda: float,
    use_gae: bool = True,
    use_proper_time_limits: bool = False,
):
    """Returns (returns (T, N), value_preds (T+1, N) with [T]=next_value)."""
    T = rewards.shape[0]
    value_preds = torch.cat([value_preds[:T], next_value[None]], dim=0)
    returns = [None] * T
    if use_gae:
        gae = torch.zeros_like(next_value)
        for t in range(T - 1, -1, -1):
            delta = (rewards[t] + gamma * value_preds[t + 1] * masks[t + 1]
                     - value_preds[t])
            gae = delta + gamma * gae_lambda * masks[t + 1] * gae
            if use_proper_time_limits:
                gae = gae * bad_masks[t + 1]
            returns[t] = gae + value_preds[t]
    else:
        ret = next_value
        for t in range(T - 1, -1, -1):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            if use_proper_time_limits:
                ret = (ret * bad_masks[t + 1]
                       + (1.0 - bad_masks[t + 1]) * value_preds[t])
            returns[t] = ret
    return torch.stack(returns), value_preds
