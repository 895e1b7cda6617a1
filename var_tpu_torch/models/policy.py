"""Actor-critic policy networks (port of var_tpu/models/policy.py).

- Policy: a base net by name and a distribution head by action space
  (reference: models/ppo/model.py:15-82);
- the GRU core with done-mask resets: one masked scan (ops/gru.py) covers
  both the one-step and the (T, N)-sequence case;
- ArmPolicyBase, armNet_VAR (reference: models/RL/arm_RL_model.py:41-134),
  and AI2ThorPolicyBase, ai2thorNet_VAR (models/RL/ai2thor_RL_model.py:
  7-115): image CNN + VAR-embedding motor branch (+ an egocentric
  occupancy branch for ai2thor) fused by residual additions around the
  GRU, a goal-sound-embedding branch added after, separate actor and
  critic heads.

NCHW throughout, as the JAX package's public layout. The flattened conv
features are in CHW order; convert.py permutes the first layer after each
conv stack (cnnMlp_0, occMlp_0) of the JAX package's NHWC-flattened
parameters. Every MLP Linear starts orthogonal with the reference's gain
(sqrt(2)) and a zero bias, the GRU orthogonal with zero biases, the convs
and the occupancy branch's two Linears at flax's defaults (as the JAX
package's plain nn.Dense); the draws come from a torch.Generator and
differ from JAX's.

computeDtype='bfloat16' runs the conv stacks and their max-pools in bf16,
as flax's Conv at that dtype (models/encoders.py::conv), on uint8 pixels
scaled in bf16 in the JAX package's order; the flattened features are
cast to float32, and the MLPs, the GRU, the heads and the distributions
stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.models.distributions import (
    entropy,
    init_orthogonal,
    log_probs,
    make_head,
    mode,
    orthogonal_linear,
    sample,
)
from var_tpu_torch.models.encoders import (compute_dtype, conv,
                                           flax_default_init_)
from var_tpu_torch.ops.gru import GRUParams, gru_scan

SQRT2 = 1.4142135623730951

# conv stacks as (out_channels, kernel, stride, padding) or "pool" (2x2 max)
ARM96_CONVS = ((32, 3, 1, 1), (32, 3, 1, 1), "pool",
               (64, 3, 1, 1), (64, 3, 1, 1), "pool",
               (128, 3, 1, 1), (128, 3, 1, 1), "pool",
               (256, 3, 2, 0), (128, 3, 1, 0))  # 96 -> 48 -> 24 -> 12 -> 5 -> 3
# raw-camera path for img_width != 96 (reference arm_RL_model.py:8-19)
ARM_CAMERA_CONVS = ((64, 7, 2, 1), (64, 3, 1, 1), "pool",
                    (128, 3, 1, 1), "pool", (256, 3, 1, 1), "pool",
                    (512, 3, 1, 1), "pool")


# ai2thorNet_VAR's image stack: 96 -> 48 -> 24 -> 12 -> 6 -> 3
AI2THOR_CONVS = ((32, 3, 1, 1), (32, 3, 1, 1), "pool",
                 (64, 3, 1, 1), "pool", (64, 3, 1, 1), "pool",
                 (128, 3, 1, 1), "pool", (128, 3, 2, 1))
# its occupancy stack over the (1, 9, 9) crop: 9 -> 5 -> 3
OCCUPANCY_CONVS = ((64, 3, 2, 1), (32, 3, 2, 1))


def conv_plan(img_dim: Sequence[int]):
    return ARM96_CONVS if img_dim[-1] == 96 else ARM_CAMERA_CONVS


def conv_grid(img_dim: Sequence[int], plan=None) -> Tuple[int, int, int]:
    """(channels, height, width) of a conv stack's output (the arm's stack
    for `img_dim` unless `plan` names another)."""
    c, h, w = img_dim
    for layer in (conv_plan(img_dim) if plan is None else plan):
        if layer == "pool":
            h, w = h // 2, w // 2
        else:
            c, k, s, p = layer
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return c, h, w


def _convs(plan, in_channels: int) -> nn.ModuleList:
    convs, c = [], in_channels
    for layer in plan:
        if layer != "pool":
            out, k, s, p = layer
            convs.append(nn.Conv2d(c, out, k, stride=s, padding=p))
            c = out
    return nn.ModuleList(convs)


def _run_convs(plan, convs: nn.ModuleList, x: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The stack at `dtype` with ReLU after each conv and 2x2 max-pools;
    flattened and cast to float32."""
    it = iter(convs)
    for layer in plan:
        if layer == "pool":
            x = F.max_pool2d(x, 2)
        else:
            x = F.relu(conv(next(it), x, dtype))
    return x.flatten(1).float()


def _mlp(in_features: int, sizes: Sequence[int]) -> nn.ModuleList:
    """ReLU MLP; layer i holds the JAX package's `<name>_i`."""
    dims = (in_features, *sizes)
    return nn.ModuleList(orthogonal_linear(dims[i], dims[i + 1], SQRT2)
                         for i in range(len(sizes)))


def _run(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = F.relu(layer(x))
    return x


def _norm_img(x: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 pixels are scaled here (storage and transfers stay 4x
    smaller); float input is already in [0, 1]. At bf16 the pixels are
    cast first and multiplied by 1/255 rounded to bf16, as jnp does with
    a Python scalar."""
    if x.dtype == torch.uint8:
        if dtype == torch.float32:
            return x.to(torch.float32) * (1.0 / 255.0)
        return x.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype,
                                          device=x.device)
    return x.to(dtype)


class PolicyGRU(nn.Module):
    """Recurrent core: orthogonal weights, zero biases (model.py:96-101)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.w_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden_size))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden_size))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.orthogonal_(self.w_ih, generator=generator)
        nn.init.orthogonal_(self.w_hh, generator=generator)
        nn.init.zeros_(self.b_ih)
        nn.init.zeros_(self.b_hh)

    def forward(self, xs_flat, rnn_hx, masks_flat, seq_len: int):
        """xs_flat: (T*N, D) time-major; rnn_hx: (N, H); masks_flat:
        (T*N, 1). Returns (outputs (T*N, H), new_hx (N, H))."""
        N, T = rnn_hx.shape[0], seq_len
        params = GRUParams(self.w_ih, self.w_hh, self.b_ih, self.b_hh)
        ys, h_final = gru_scan(params, xs_flat.reshape(T, N, -1), rnn_hx,
                               masks=masks_flat.reshape(T, N))
        return ys.reshape(T * N, -1), h_final


class ArmPolicyBase(nn.Module):
    """armNet_VAR (reference: models/RL/arm_RL_model.py:41-134)."""

    def __init__(self, representation_dim: int = 3, robot_state_dim: int = 2,
                 recurrent: bool = True, recurrent_input_size: int = 128,
                 recurrent_size: int = 512, action_hidden_size: int = 128,
                 img_dim: Sequence[int] = (3, 96, 96),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.recurrent = recurrent
        self.dtype = dtype
        self.plan = conv_plan(img_dim)
        self.convs = _convs(self.plan, img_dim[0])
        flat = math.prod(conv_grid(img_dim))

        self.cnnMlp = _mlp(flat, (512, 256))
        self.motorMlp = _mlp(representation_dim + robot_state_dim,
                             (256, 512, 256))
        self.imgMotorMlp = _mlp(256, (256, recurrent_input_size))
        if recurrent:
            self.gru = PolicyGRU(recurrent_input_size, recurrent_size)
        self.imgMotorMlp2 = _mlp(
            recurrent_size if recurrent else recurrent_input_size, (256,))
        self.soundMlp = _mlp(representation_dim, (128, 256, 256))
        self.fusionMlp = _mlp(256, (512, 256))
        self.mlp_all = _mlp(256, (256, 128))
        self.actor = _mlp(128, (128, action_hidden_size))
        self.critic = _mlp(128, (128, 128))
        self.critic_linear = orthogonal_linear(128, 1, SQRT2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_default_init_(self.convs, generator)
        init_orthogonal(self, generator)
        if self.recurrent:
            self.gru.reset_parameters(generator)

    def forward(self, obs: Dict[str, torch.Tensor], rnn_hx, masks,
                seq_len: int = 1):
        x = _run_convs(self.plan, self.convs,
                       _norm_img(obs["image"], self.dtype), self.dtype)
        image_flatten = _run(self.cnnMlp, x)
        motor = _run(self.motorMlp,
                     torch.cat([obs["image_feat"], obs["robot_pose"]], dim=1))
        image_motor = _run(self.imgMotorMlp, image_flatten + motor)
        if self.recurrent:
            image_motor, rnn_hx = self.gru(image_motor, rnn_hx, masks,
                                           seq_len)
        image_motor_rnn = _run(self.imgMotorMlp2, image_motor)
        sound = _run(self.soundMlp, obs["goal_sound_feat"])
        fusion = _run(self.fusionMlp, sound + image_flatten)
        h = _run(self.mlp_all, fusion + image_motor_rnn)
        hidden_actor = _run(self.actor, h)
        value = self.critic_linear(_run(self.critic, h))
        return value, hidden_actor, rnn_hx


class AI2ThorPolicyBase(nn.Module):
    """ai2thorNet_VAR (reference: models/RL/ai2thor_RL_model.py:7-115)."""

    def __init__(self, representation_dim: int = 3, recurrent: bool = True,
                 recurrent_input_size: int = 128, recurrent_size: int = 1024,
                 action_hidden_size: int = 128,
                 img_dim: Sequence[int] = (3, 96, 96), occupancy_grid: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.recurrent = recurrent
        self.dtype = dtype
        self.convs = _convs(AI2THOR_CONVS, img_dim[0])
        self.occ_convs = _convs(OCCUPANCY_CONVS, 1)
        occ_flat = math.prod(conv_grid((1, occupancy_grid, occupancy_grid),
                                       OCCUPANCY_CONVS))
        self.occMlp = nn.ModuleList([nn.Linear(occ_flat, 128),
                                     nn.Linear(128, 256)])
        self.cnnMlp = _mlp(math.prod(conv_grid(img_dim, AI2THOR_CONVS)),
                           (512, 256))
        self.motorMlp = _mlp(representation_dim, (64, 256))
        self.imgMotorMlp = _mlp(256, (64, recurrent_input_size))
        if recurrent:
            self.gru = PolicyGRU(recurrent_input_size, recurrent_size)
        self.imgMotorMlp2 = _mlp(
            recurrent_size if recurrent else recurrent_input_size, (256,))
        self.soundMlp = _mlp(representation_dim, (128, 256, 256))
        self.fusionMlp = _mlp(256, (512, 256))
        self.mlp_all = _mlp(256, (256, 128))
        self.actor = _mlp(128, (128, action_hidden_size))
        self.critic = _mlp(128, (128, 128))
        self.critic_linear = orthogonal_linear(128, 1, SQRT2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        flax_default_init_(self.convs, generator)
        flax_default_init_(self.occ_convs, generator)
        flax_default_init_(self.occMlp, generator)
        init_orthogonal(self, generator)
        if self.recurrent:
            self.gru.reset_parameters(generator)

    def forward(self, obs: Dict[str, torch.Tensor], rnn_hx, masks,
                seq_len: int = 1):
        x = _run_convs(AI2THOR_CONVS, self.convs,
                       _norm_img(obs["image"], self.dtype), self.dtype)
        o = _run_convs(OCCUPANCY_CONVS, self.occ_convs,
                       _norm_img(obs["occupancy"], self.dtype), self.dtype)
        occupancy_feat = _run(self.occMlp, o)
        image_flatten = _run(self.cnnMlp, x)
        motor = _run(self.motorMlp, obs["image_feat"])
        image_motor = _run(self.imgMotorMlp,
                           image_flatten + motor + occupancy_feat)
        if self.recurrent:
            image_motor, rnn_hx = self.gru(image_motor, rnn_hx, masks,
                                           seq_len)
        image_motor_rnn = _run(self.imgMotorMlp2, image_motor)
        sound = _run(self.soundMlp, obs["goal_sound_feat"])
        fusion = _run(self.fusionMlp, sound + image_flatten)
        h = _run(self.mlp_all, fusion + image_motor_rnn)
        hidden_actor = _run(self.actor, h)
        value = self.critic_linear(_run(self.critic, h))
        return value, hidden_actor, rnn_hx


_BASE_REGISTRY = {
    "arm_VAR": ArmPolicyBase,
    "ai2thor_VAR": AI2ThorPolicyBase,
}


class Policy(nn.Module):
    """Actor-critic wrapper (reference: models/ppo/model.py:15-82)."""

    def __init__(self, base_name: str, action_space,
                 representation_dim: int = 3, robot_state_dim: int = 2,
                 recurrent: bool = True, recurrent_input_size: int = 128,
                 recurrent_size: int = 512, action_hidden_size: int = 128,
                 img_dim: Sequence[int] = (3, 96, 96), occupancy_grid: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.recurrent = recurrent
        self.recurrent_size = recurrent_size
        cls = _BASE_REGISTRY[base_name]
        kwargs = dict(representation_dim=representation_dim,
                      recurrent=recurrent,
                      recurrent_input_size=recurrent_input_size,
                      recurrent_size=recurrent_size,
                      action_hidden_size=action_hidden_size, img_dim=img_dim,
                      dtype=dtype)
        if cls is ArmPolicyBase:
            kwargs["robot_state_dim"] = robot_state_dim
        else:
            kwargs["occupancy_grid"] = occupancy_grid
        self.base = cls(**kwargs)
        self.dist_head = make_head(action_space, action_hidden_size)

    @property
    def recurrent_hidden_state_size(self) -> int:
        return self.recurrent_size if self.recurrent else 1

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.base.reset_parameters(generator)
        init_orthogonal(self.dist_head, generator)
        return self

    def forward(self, obs, rnn_hx, masks, seq_len: int = 1):
        value, actor_features, rnn_hx = self.base(obs, rnn_hx, masks, seq_len)
        return value, self.dist_head(actor_features), rnn_hx


class PolicyStep(NamedTuple):
    value: torch.Tensor  # (B, 1)
    action: torch.Tensor
    action_log_prob: torch.Tensor  # (B, 1)
    rnn_hx: torch.Tensor  # (N, H)


@torch.no_grad()
def act(model: Policy, obs, rnn_hx, masks,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        deterministic: bool = False) -> PolicyStep:
    """One rollout step (reference: model.py:57-68): the mode when
    `deterministic`, else a sample (see distributions.sample)."""
    value, dist, new_hx = model(obs, rnn_hx, masks, 1)
    action = mode(dist) if deterministic else sample(dist, generator, noise)
    return PolicyStep(value, action, log_probs(dist, action), new_hx)


@torch.no_grad()
def get_value(model: Policy, obs, rnn_hx, masks) -> torch.Tensor:
    return model(obs, rnn_hx, masks, 1)[0]


def evaluate_actions(model: Policy, obs, rnn_hx, masks, actions,
                     seq_len: int):
    """(values (TB, 1), action_log_probs (TB, 1), mean entropy) over a
    flattened, time-major (T*N) minibatch (reference: model.py:75-82)."""
    value, dist, _ = model(obs, rnn_hx, masks, seq_len)
    return value, log_probs(dist, actions), torch.mean(entropy(dist))


def build_policy(config, action_space) -> Policy:
    """Construct from config knobs (reference: RL.py:99-110), with its
    parameters left for reset_parameters or a load."""
    return Policy(
        base_name=config.RLPolicyBase,
        action_space=action_space,
        representation_dim=config.representationDim,
        robot_state_dim=getattr(config, "robotStateDim", 2),
        recurrent=config.RLRecurrentPolicy,
        recurrent_input_size=config.RLRecurrentInputSize,
        recurrent_size=config.RLRecurrentSize,
        action_hidden_size=config.RLActionHiddenSize,
        img_dim=tuple(getattr(config, "img_dim", (3, 96, 96))),
        occupancy_grid=getattr(config, "RLVisibleGrid", 9),
        dtype=compute_dtype(config),
    )
