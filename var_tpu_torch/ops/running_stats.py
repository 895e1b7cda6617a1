"""Running mean/variance as explicit functional state (copy of
var_tpu/ops/running_stats.py, numpy on the host).

The parallel-moments (Chan et al.) update of the reference's
RunningMeanStd (reference: Envs/vec_env/running_mean_std.py:4-36), used for
the discounted-return normalisation of the VAR reward wrapper
(rl/reward.py; reference: Envs/vec_env/vec_pretext_normalize.py:55-59).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class RunningMeanStd(NamedTuple):
    mean: np.ndarray
    var: np.ndarray
    count: float

    @classmethod
    def create(cls, shape=(), epsilon: float = 1e-4):
        return cls(np.zeros(shape, np.float64), np.ones(shape, np.float64), epsilon)


def rms_update(state: RunningMeanStd, batch: np.ndarray) -> RunningMeanStd:
    batch = np.asarray(batch, dtype=np.float64)
    batch_mean = batch.mean(axis=0)
    batch_var = batch.var(axis=0)
    batch_count = batch.shape[0]

    delta = batch_mean - state.mean
    tot_count = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot_count
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * state.count * batch_count / tot_count
    new_var = m2 / tot_count
    return RunningMeanStd(new_mean, new_var, tot_count)


class ReturnNormalizer(NamedTuple):
    """State for baselines-style reward normalization: running discounted
    return RMS; reward /= sqrt(var + eps), clipped."""

    rms: RunningMeanStd
    ret: np.ndarray  # (N,) running discounted return
    gamma: float
    cliprew: float
    epsilon: float

    @classmethod
    def create(cls, num_envs: int, gamma: float = 0.99, cliprew: float = 10.0,
               epsilon: float = 1e-8):
        return cls(RunningMeanStd.create(()), np.zeros(num_envs), gamma,
                   cliprew, epsilon)


def normalize_rewards(
    state: ReturnNormalizer, rews: np.ndarray, news: np.ndarray
) -> Tuple[ReturnNormalizer, np.ndarray]:
    """One step of VecPretextNormalize.step_wait reward handling
    (reference: vec_pretext_normalize.py:55-61): update return RMS with the
    *pre-normalization* running return, scale rewards, zero returns where
    the episode ended."""
    ret = state.ret * state.gamma + rews
    rms = rms_update(state.rms, ret)
    out = np.clip(
        rews / np.sqrt(rms.var + state.epsilon), -state.cliprew, state.cliprew
    )
    ret = np.where(news, 0.0, ret)
    return state._replace(rms=rms, ret=ret), out
