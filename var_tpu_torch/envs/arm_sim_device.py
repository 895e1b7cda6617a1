"""Device-resident batched fourInARow simulator (port of
var_tpu/envs/arm_sim_device.py).

The host sim (envs/arm_sim.py) is deterministic geometry: clipped XY
kinematics, axis-aligned box objects, a rasterised top-down camera and a
point-in-box ray test. Here the whole environment is batched tensor code,
so a PPO rollout runs on the card with no host round trip per step
(rl/device_sim.py).

Parity contract (tests/test_torch_device_sim.py):
- `render` is pixel-identical to the JAX package's `render` and to
  FourInARowSim.get_image at the same (objPose, ee) state. It keeps the
  JAX order of operations and the Python-float constants, so torch
  rounds in float32 exactly as XLA does;
- `ray_test` and `apply_action` equal the JAX package's;
- `randomize` is split in two: `draw_reset` draws from a torch.Generator
  (the JAX and torch random streams differ), and `reset_from_draws` is the
  pure function of those draws, which the tests feed with JAX's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# object footprint: keep in sync with arm_sim.OBJ_HALF_X/Y
OBJ_HALF_X = 0.035
OBJ_HALF_Y = 0.03
H = W = 96
# table gray, golden keys, the arm's shadow, the red gripper disc
PALETTE = ((70, 70, 70), (200, 170, 40), (90, 40, 40), (220, 40, 40))


class SimConsts(NamedTuple):
    """Workspace constants as Python floats (the reference kuka
    env_config ranges, surfaced through config/arm.py)."""

    x_min: float
    x_max: float
    y_min: float
    y_max: float
    obj_interval: float
    n_obj: int
    # uniform ranges, already folded with the workspace bounds
    rand_x_lo: float
    rand_x_hi: float
    rand_y_lo: float
    rand_y_hi: float
    objs_x_lo: float
    objs_x_hi: float
    objs_y_lo: float
    objs_y_hi: float
    ee_x_lo: float
    ee_x_hi: float
    ee_y_lo: float
    ee_y_hi: float


def consts_from_config(c) -> SimConsts:
    return SimConsts(
        x_min=float(c.xMin), x_max=float(c.xMax),
        y_min=float(c.yMin), y_max=float(c.yMax),
        obj_interval=float(c.objInterval), n_obj=len(c.objList),
        rand_x_lo=float(c.xMin + c.objXRand[0]),
        rand_x_hi=float(c.xMax + c.objXRand[1]),
        rand_y_lo=float(c.yMin + c.objYRand[0]),
        rand_y_hi=float(c.yMax + c.objYRand[1]),
        objs_x_lo=float(c.objsXRand[0]), objs_x_hi=float(c.objsXRand[1]),
        objs_y_lo=float(c.objsYRand[0]), objs_y_hi=float(c.objsYRand[1]),
        ee_x_lo=float(c.xMin + c.eeXInitRand[0]),
        ee_x_hi=float(c.xMax + c.eeXInitRand[1]),
        ee_y_lo=float(c.yMin + c.eeYInitRand[0]),
        ee_y_hi=float(c.yMax + c.eeYInitRand[1]),
    )


class ResetDraws(NamedTuple):
    """The random draws of one batched reset, already in their ranges."""

    rand_x: torch.Tensor  # (n, 1) f32 row offset in x
    rand_y: torch.Tensor  # (n, 1) f32 row offset in y
    perm: torch.Tensor    # (n, n_obj) int: one permutation per env
    jit_x: torch.Tensor   # (n, n_obj) f32 per-object jitter (zeros if none)
    jit_y: torch.Tensor   # (n, n_obj) f32
    ee: torch.Tensor      # (n, 2) f32 gripper start


def _uniform(shape, lo: float, hi: float, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def draw_reset(generator: Optional[torch.Generator], n: int, k: SimConsts,
               device="cpu") -> ResetDraws:
    """The draws of `randomize` from `generator` (on `device`): two
    uniforms, a permutation per env, the jitter, the gripper uniforms."""
    jit = []
    for lo, hi in ((k.objs_x_lo, k.objs_x_hi), (k.objs_y_lo, k.objs_y_hi)):
        jit.append(_uniform((n, k.n_obj), lo, hi, generator, device)
                   if hi > lo else torch.zeros((n, k.n_obj), device=device))
    perm = torch.argsort(torch.rand((n, k.n_obj), generator=generator,
                                    device=device), dim=1)
    return ResetDraws(
        _uniform((n, 1), k.rand_x_lo, k.rand_x_hi, generator, device),
        _uniform((n, 1), k.rand_y_lo, k.rand_y_hi, generator, device),
        perm, *jit,
        torch.stack([
            _uniform((n,), k.ee_x_lo, k.ee_x_hi, generator, device),
            _uniform((n,), k.ee_y_lo, k.ee_y_hi, generator, device)], -1))


def reset_from_draws(draws: ResetDraws, k: SimConsts):
    """Object shuffle and pose/ee randomisation (host twin:
    arm_sim._randomize, reference fourInARow.py:141-170). Returns
    (obj_pose (n, n_obj, 2) f32, obj_order (n, n_obj) i32, ee (n, 2) f32);
    obj_order[e, i] is the row-order class of object i, the host sim's
    objOrder mapping."""
    obj_order = draws.perm.to(torch.int32)
    x = draws.rand_x + draws.jit_x
    y = draws.rand_y + obj_order.to(torch.float32) * k.obj_interval \
        + draws.jit_y
    obj_pose = torch.stack([x, y], dim=-1).to(torch.float32)
    return obj_pose, obj_order, draws.ee.to(torch.float32)


def randomize(generator: Optional[torch.Generator], n: int, k: SimConsts,
              device="cpu"):
    return reset_from_draws(draw_reset(generator, n, k, device), k)


def apply_action(ee, action, k: SimConsts):
    """2-D action -> clipped +/-0.02 m deltas, workspace-clipped (host twin:
    arm_sim._apply_action_rl, robot_manipulators.py:127-153)."""
    a = torch.clamp(action[..., :2], -1.0, 1.0)
    ee = ee + torch.clamp(a * 0.02, -0.02, 0.02)
    return torch.stack([
        torch.clamp(ee[..., 0], k.x_min, k.x_max),
        torch.clamp(ee[..., 1], k.y_min, k.y_max),
    ], dim=-1)


def ray_test(obj_pose, ee):
    """(n,) i32: the nearest object under the gripper, or -1 (host twin:
    arm_sim.ray_test). Ties go to the first index, as jnp.argmin does."""
    d = torch.abs(obj_pose - ee[:, None, :])  # (n, n_obj, 2)
    hit = (d[..., 0] <= OBJ_HALF_X) & (d[..., 1] <= OBJ_HALF_Y)
    dist = torch.where(hit, torch.linalg.vector_norm(d, dim=-1),
                       torch.full_like(d[..., 0], float("inf")))
    idx = torch.argmin(dist, dim=-1).to(torch.int32)
    return torch.where(hit.any(dim=-1), idx, torch.full_like(idx, -1))


def _render_consts(k: SimConsts):
    x0, x1 = k.x_min - 0.08, k.x_max + 0.08
    y0, y1 = k.y_min - 0.12, k.y_max + 0.12
    hx = int(OBJ_HALF_X / (x1 - x0) * H) + 2
    hy = int(OBJ_HALF_Y / (y1 - y0) * W) + 2
    return x0, x1, y0, y1, hx, hy


def _labels(obj_pose, ee, k: SimConsts):
    """(n, H, W) int64 palette index of every pixel: the later layer wins
    (keys, then the arm's shadow, then the disc), as get_image paints."""
    x0, x1, y0, y1, hx, hy = _render_consts(k)

    def to_px(x, y):
        # float32 with Python-float constants, in the JAX order
        r = torch.clamp(torch.floor((x - x0) / (x1 - x0) * (H - 1)), 0, H - 1)
        c = torch.clamp(torch.floor((y - y0) / (y1 - y0) * (W - 1)), 0, W - 1)
        return r.to(torch.int32), c.to(torch.int32)

    dev = ee.device
    rr = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None]
    cc = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]

    ro, co = to_px(obj_pose[..., 0], obj_pose[..., 1])  # (n, n_obj)
    row_in = ((rr[..., None] >= (ro[:, None, None, :] - hx))
              & (rr[..., None] < (ro[:, None, None, :] + hx)))  # (n,H,1,o)
    col_in = ((cc[..., None] >= (co[:, None, None, :] - hy))
              & (cc[..., None] < (co[:, None, None, :] + hy)))  # (n,1,W,o)
    obj_mask = (row_in & col_in).any(dim=-1)  # (n, H, W)

    rg, cg = to_px(ee[:, 0], ee[:, 1])
    rg = rg[:, None, None]
    cg = cg[:, None, None]
    arm_mask = (cc <= cg) & (torch.abs(rr - rg) <= 2)
    disc_mask = (rr - rg) ** 2 + (cc - cg) ** 2 <= 16

    label = obj_mask.to(torch.int64)
    label = torch.where(arm_mask, 2, label)
    return torch.where(disc_mask, 3, label)


def render(obj_pose, ee, k: SimConsts):
    """(n, 96, 96, 3) u8 top-down view, pixel-identical to
    FourInARowSim.get_image."""
    palette = torch.tensor(PALETTE, dtype=torch.uint8, device=ee.device)
    return palette[_labels(obj_pose, ee, k)]


def render_chw(obj_pose, ee, k: SimConsts):
    """(n, 3, 96, 96) u8, the obs-dict layout, written channels-first."""
    palette = torch.tensor(PALETTE, dtype=torch.uint8, device=ee.device)
    return palette.t()[:, _labels(obj_pose, ee, k)].transpose(0, 1) \
        .contiguous()
