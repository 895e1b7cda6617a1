"""PPO learner (port of var_tpu/rl/ppo.py).

The reference PPO.update (reference: models/ppo/algo/ppo.py:38-104) with
the recurrent minibatch generator (models/ppo/storage.py:175-245):

- advantages = returns - values, normalised once before the epochs by the
  unbiased std (torch's default, as the reference);
- per epoch an env permutation; per minibatch whole-sequence columns of
  N/num_mini_batch envs, gathered along the env axis and flattened
  time-major, (T, n) -> (T*n), then re-evaluated through the policy with
  the mask-segmented GRU scan;
- clipped surrogate, clipped value loss, entropy bonus;
- the JAX package's optax chain written out: global-norm clipping as optax
  computes it (g / |g| * max_norm when |g| >= max_norm, with no epsilon),
  Adam with eps outside the square root of the bias-corrected second
  moment, then the learning rate (constant, or joined linear/cosine decay
  counted in optimizer steps).

Under a mesh (meshShape, parallel/mesh.py) each rank holds its block of
the rollout's envs. The update gathers the whole rollout onto every rank
once, normalises the advantages over it, and takes each minibatch's
global envs (or transitions) from the same permutation as dp=1; each rank
takes an equal block of them and computes its block's loss sum over the
whole minibatch's size, and the gradients (and the metrics) are summed
over the ranks before the global-norm clip. Every rank then clips and
steps identically, so the parameters stay bit-equal across ranks.

The update runs eagerly and does not synchronise: the parameters, the Adam
moments and the metrics stay on the device. It updates the policy's own
parameters in place, so every holder of the module (the rollout engine)
acts with the new values at once. The epoch permutations are an argument
(`perms`); draw_perms makes them from a torch.Generator.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from var_tpu_torch.models.policy import Policy, evaluate_actions
from var_tpu_torch.parallel.mesh import Mesh, all_gather_env, all_reduce_sum_


class PPOConfig(NamedTuple):
    clip_param: float
    ppo_epoch: int
    num_mini_batch: int
    value_loss_coef: float
    entropy_coef: float
    lr: float
    eps: float
    max_grad_norm: float
    use_clipped_value_loss: bool = True
    # None = constant LR (reference parity: RL.py:115). 'linear'/'cosine'
    # hold lr until lr_decay_start * total_opt_steps optimizer steps, then
    # decay to lr * lr_final_factor by total_opt_steps.
    lr_decay: Optional[str] = None
    lr_decay_start: float = 0.33
    lr_final_factor: float = 0.1
    total_opt_steps: int = 0

    @classmethod
    def from_config(cls, config):
        # the schedule's horizon in OPTIMIZER steps: one per minibatch,
        # epochs x minibatches per PPO update
        num_updates = int(getattr(config, "RLTotalSteps", 0)) // max(
            1, int(getattr(config, "ppoNumSteps", 1))
            * int(getattr(config, "RLNumEnvs", 1)))
        return cls(
            clip_param=config.ppoClipParam,
            ppo_epoch=config.ppoEpoch,
            num_mini_batch=config.ppoNumMiniBatch,
            value_loss_coef=config.ppoValueLossCoef,
            entropy_coef=config.ppoEntropyCoef,
            lr=config.RLLr,
            eps=config.RLEps,
            max_grad_norm=config.RLMaxGradNorm,
            lr_decay=getattr(config, "RLLrDecay", None),
            lr_decay_start=getattr(config, "RLLrDecayStart", 0.33),
            lr_final_factor=getattr(config, "RLLrFinalFactor", 0.1),
            total_opt_steps=max(
                1, num_updates * config.ppoEpoch * config.ppoNumMiniBatch),
        )


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: `count` optimizer steps taken (a host
    int: the bias corrections and the LR are host floats, so a step never
    reads the device), first and second moments by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class PPOState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the policy's own parameters
    opt_state: AdamState
    step: int


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g / |g| * max_norm unless
    |g| < max_norm. Returns |g| (a device scalar)."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, g_norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return g_norm


class PPO:
    """Owns the optimizer math and the update (reference: algo/ppo.py:6-36)."""

    B1, B2 = 0.9, 0.999

    def __init__(self, model: Policy, cfg: PPOConfig,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.schedule = self._lr_schedule()

    def _lr_schedule(self) -> Union[float, Callable[[int], float]]:
        """Constant LR by default; optional decay over the training
        horizon, counted in optimizer steps (one per minibatch), as
        optax.join_schedules([constant, linear|cosine], [start])."""
        cfg = self.cfg
        if not cfg.lr_decay:
            return cfg.lr
        total = max(1, int(cfg.total_opt_steps))
        start = min(total - 1, int(total * cfg.lr_decay_start))
        decay_len = max(1, total - start)
        floor = cfg.lr * cfg.lr_final_factor
        if cfg.lr_decay == "linear":
            def tail(count):
                frac = 1 - min(max(count, 0), decay_len) / decay_len
                return (cfg.lr - floor) * frac + floor
        elif cfg.lr_decay == "cosine":
            alpha = cfg.lr_final_factor

            def tail(count):
                count = min(count, decay_len)
                cosine = 0.5 * (1 + math.cos(math.pi * count / decay_len))
                return cfg.lr * ((1 - alpha) * cosine + alpha)
        else:
            raise ValueError(
                f"unknown lr_decay {cfg.lr_decay!r} (None|'linear'|'cosine')")

        def schedule(count):
            return cfg.lr if count < start else tail(count - start)

        return schedule

    def lr_at(self, count: int) -> float:
        sched = self.schedule
        return sched(count) if callable(sched) else float(sched)

    def current_lr(self, state: PPOState) -> float:
        """LR at the state's optimizer count (for progress logging)."""
        return self.lr_at(state.opt_state.count)

    def init_state(self) -> PPOState:
        params = dict(self.model.named_parameters())
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return PPOState(params, AdamState(
            0, zeros, {k: torch.zeros_like(v) for k, v in params.items()}), 0)

    def draw_perms(self, batch, generator: torch.Generator) -> torch.Tensor:
        """The update's epoch permutations, (ppo_epoch, N) over envs
        (recurrent) or (ppo_epoch, T*N) over transitions; N counts every
        rank's envs (a rank's batch holds its block)."""
        T, N = batch["returns"].shape
        if self.mesh is not None:
            N = N * self.mesh.dp
        n = N if self.model.recurrent else T * N
        device = batch["returns"].device
        return torch.stack([
            torch.randperm(n, generator=generator, device=device)
            for _ in range(self.cfg.ppo_epoch)])

    def _apply_adam(self, state: PPOState, grads) -> PPOState:
        """One optax chain step on state.params, in place."""
        cfg = self.cfg
        names = list(state.params)
        params = [state.params[k] for k in names]
        mu = [state.opt_state.mu[k] for k in names]
        nu = [state.opt_state.nu[k] for k in names]
        b1, b2 = self.B1, self.B2
        lr = self.lr_at(state.opt_state.count)
        count = state.opt_state.count + 1
        with torch.no_grad():
            clip_by_global_norm_(grads, cfg.max_grad_norm)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
            denom = torch._foreach_div(nu, 1 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.eps)
            torch._foreach_div_(mu_hat, denom)
            torch._foreach_mul_(mu_hat, -lr)
            torch._foreach_add_(params, mu_hat)
        return state._replace(opt_state=state.opt_state._replace(count=count))

    def _minibatch_loss(self, obs, rnn_hx, masks, actions, value_preds,
                        returns, old_log_probs, adv, seq_len):
        cfg = self.cfg
        values, action_log_probs, dist_entropy = evaluate_actions(
            self.model, obs, rnn_hx, masks[:, None], actions, seq_len)
        values = values[:, 0]
        action_log_probs = action_log_probs[:, 0]

        ratio = torch.exp(action_log_probs - old_log_probs)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * adv
        action_loss = -torch.mean(torch.minimum(surr1, surr2))
        if cfg.use_clipped_value_loss:
            value_pred_clipped = value_preds + torch.clamp(
                values - value_preds, -cfg.clip_param, cfg.clip_param)
            value_losses = (values - returns) ** 2
            value_losses_clipped = (value_pred_clipped - returns) ** 2
            value_loss = 0.5 * torch.mean(
                torch.maximum(value_losses, value_losses_clipped))
        else:
            value_loss = 0.5 * torch.mean((returns - values) ** 2)
        total = (value_loss * cfg.value_loss_coef + action_loss
                 - dist_entropy * cfg.entropy_coef)
        return total, torch.stack([value_loss, action_loss, dist_entropy])

    def _step(self, state: PPOState, *mb, share: float = 1.0):
        """One minibatch. Under a mesh the minibatch is this rank's block,
        `share` of the whole: the losses are scaled to it, and the
        gradients and the metrics summed over the ranks."""
        total, stats = self._minibatch_loss(*mb)
        if self.mesh is not None:
            total, stats = total * share, stats * share
        grads = list(torch.autograd.grad(total, list(state.params.values())))
        stats = stats.detach()
        if self.mesh is not None:
            all_reduce_sum_(grads + [stats], self.mesh)
        return self._apply_adam(state, grads), stats

    def _gather(self, batch):
        """The whole rollout on every rank: each (T, N_rank, ...) tensor
        joined along its env axis, rnn_hx0 along axis 0."""
        if self.mesh is None:
            return batch
        out = {k: all_gather_env(v, self.mesh, 1) for k, v in batch.items()
               if k not in ("obs", "rnn_hx0")}
        out["obs"] = {k: all_gather_env(v, self.mesh, 1)
                      for k, v in batch["obs"].items()}
        out["rnn_hx0"] = all_gather_env(batch["rnn_hx0"], self.mesh, 0)
        return out

    def _block(self, idx: torch.Tensor):
        """(this rank's block of a minibatch's indices, its share)."""
        if self.mesh is None:
            return idx, 1.0
        return (self.mesh.shard(idx, 0, "the minibatch"),
                1.0 / self.mesh.dp)

    def update(self, state: PPOState, batch, perms: torch.Tensor):
        """batch: DeviceRolloutEngine.device_batch(); perms: see
        draw_perms. Returns (state, metrics as device scalars)."""
        cfg = self.cfg
        batch = self._gather(batch)
        T, N = batch["returns"].shape
        if self.model.recurrent and N % cfg.num_mini_batch != 0:
            raise ValueError(
                f"PPO requires the number of envs ({N}) to be a multiple of "
                f"the number of minibatches ({cfg.num_mini_batch}) for "
                "recurrent updates (reference: storage.py:recurrent_generator)")
        advantages = batch["returns"] - batch["value_preds"]
        advantages = (advantages - advantages.mean()) / (
            advantages.std() + 1e-5)
        if not self.model.recurrent:
            return self._update_feed_forward(state, batch, perms, advantages)

        n = N // cfg.num_mini_batch
        stats = []
        for env_idx in perms.reshape(cfg.ppo_epoch * cfg.num_mini_batch, n):
            env_idx, share = self._block(env_idx)
            m = env_idx.shape[0]

            def take(x):
                x = x.index_select(1, env_idx)
                return x.reshape((T * m,) + x.shape[2:])

            state, s = self._step(
                state, {k: take(v) for k, v in batch["obs"].items()},
                batch["rnn_hx0"].index_select(0, env_idx),
                take(batch["masks"]), take(batch["actions"]),
                take(batch["value_preds"]), take(batch["returns"]),
                take(batch["old_log_probs"]), take(advantages), T,
                share=share)
            stats.append(s)
        return self._finish(state, stats)

    def _update_feed_forward(self, state: PPOState, batch, perms, advantages):
        """Non-recurrent path: random minibatches of transitions over the
        flattened (T*N) rollout (reference: storage.py
        feed_forward_generator)."""
        cfg = self.cfg
        T, N = batch["returns"].shape
        total = T * N
        mb_size = total // cfg.num_mini_batch

        def flat(x):
            return x.reshape((total,) + x.shape[2:])

        obs = {k: flat(v) for k, v in batch["obs"].items()}
        cols = [flat(batch[k]) for k in ("masks", "actions", "value_preds",
                                         "returns", "old_log_probs")]
        adv = flat(advantages)
        stats = []
        for perm in perms:
            for mb in range(cfg.num_mini_batch):
                idx, share = self._block(
                    perm[mb * mb_size:(mb + 1) * mb_size])
                hx = torch.zeros((idx.shape[0], 1), device=adv.device)
                state, s = self._step(
                    state, {k: v.index_select(0, idx) for k, v in obs.items()},
                    hx, *(c.index_select(0, idx) for c in cols),
                    adv.index_select(0, idx), 1, share=share)
                stats.append(s)
        return self._finish(state, stats)

    def _finish(self, state: PPOState, stats):
        mean = torch.stack(stats).mean(0)
        metrics = {"value_loss": mean[0], "action_loss": mean[1],
                   "dist_entropy": mean[2]}
        return state._replace(step=state.step + 1), metrics
