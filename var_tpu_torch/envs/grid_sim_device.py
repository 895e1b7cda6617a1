"""Device-resident batched grid (iTHOR-profile) simulator (port of
var_tpu/envs/grid_sim_device.py).

The host grid sim (envs/grid_sim.py) is integer-grid geometry:
discrete moves and 45-degree rotations, a fixed-step raycast render,
LUT-based egocentric occupancy rotation, FoV + line-of-sight visibility
and toggle actions. Here the whole environment is batched tensor code, so
a PPO rollout runs on the card with no host round trip per step
(rl/device_sim.py::GridDeviceSimEngine).

Parity contract (tests/test_torch_grid_sim.py): for the same env state,
`render` is pixel-identical to GridHouseSim.get_image, `visible_mask`
equals visible_objects, `local_occupancy` equals get_local_occupancy_map,
and `exe_action` equals _exe_action. The host works in float64; so do the
two places here where a float decides a cell:
- the render's ray samples are origin + offset in float64, where the
  (8 headings, 96 columns, 80 samples) offsets are computed on the host
  exactly as the host sim computes them (headings are multiples of 45
  degrees), then truncated as the host's int() truncates;
- line of sight samples pos + d * t in float64 with the host's linspace
  points t, rounded half to even as the host's round() is.
The column height and shade depend only on which sample hit, so they are
host-computed tables too. The JAX package computes both in float32 and
agrees with the host wherever its tests look; the port holds itself to the
host.

Per-floor-plan constants, the render tables and the action tables are
built once on the host by `build_plan_bank` and live on the device. The
resets are split as the arm sim's are: `draw_reset` draws from a
torch.Generator, `reset_from_draws` is the pure function of the draws,
which the tests feed with the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from var_tpu_torch.envs.grid_sim import (
    CEIL_COLOR,
    FLOOR_COLOR,
    OBJ_COLORS,
    WALL_COLOR,
    _gen_room,
)

OBJ_NAMES = ("FloorLamp", "Television")  # the host sim's dict order
H = W = 96
MAX_RANGE = 12.0
RAY_STEP = 0.15
MOVE_DEG = {"MoveAhead": 0.0, "MoveBack": 180.0,
            "MoveLeft": -90.0, "MoveRight": 90.0}


class PlanBank(NamedTuple):
    """Device constants: per floor plan (stacked over the K training
    scenes), the render and line-of-sight tables, the action tables."""

    grids: torch.Tensor        # (K, G, G) u8, 1 = wall/occupied
    occ_padded: torch.Tensor   # (K, G+2p, G+2p) u8 (255 = occupied)
    obj_cells: torch.Tensor    # (K, 2, 2) i64
    free_cells: torch.Tensor   # (K, F, 2) i64 (padded with repeats)
    free_count: torch.Tensor   # (K,) i64
    grid_size: torch.Tensor    # (K,) f64 metres per cell
    rot_lut: torch.Tensor      # (8, g, g) i64 flat source index per heading
    rot_valid: torch.Tensor    # (8, g, g) bool (False = outside -> 0)
    ray_offsets: torch.Tensor  # (8, W, S, 2) f64 direction * sample distance
    band_height: torch.Tensor  # (S+1,) i64 column height by first event
    band_color: torch.Tensor   # (5, S+1, 3) u8: wall, lamp off/on, TV off/on
    background: torch.Tensor   # (3, H, 1) u8 ceiling above, floor below
    los_t: torch.Tensor        # (2G+2, 2G) f64 linspace(0,1,n)[1:-1] by n
    heading: torch.Tensor      # (8, 2) i64 integer heading u
    fov_c: torch.Tensor        # (8,) i64 2 on axis headings, 1 on diagonals
    step_tab: torch.Tensor     # (A, 8, 2) i64 move per action and heading
    is_move: torch.Tensor      # (A,) bool
    drot: torch.Tensor         # (A,) i64 heading change
    tog_val: torch.Tensor      # (A,) i64 1 on, 0 off, -1 not a toggle


def _plan_tables(config):
    """Per floor plan: the host's _build_world (grid_sim.py) for every
    training scene."""
    c = config
    plans = list(c.allScene[next(iter(c.allTasks))])
    p = c.RLVisibleGrid + 3
    grids, occs, objs, frees, gsizes = [], [], [], [], []
    for fp in plans:
        grid = _gen_room(fp)
        occ = np.full((grid.shape[0] + 2 * p, grid.shape[1] + 2 * p), 255,
                      np.uint8)
        occ[p:p + grid.shape[0], p:p + grid.shape[1]] = grid * 255
        rng = np.random.RandomState(fp + 7777)
        free = np.argwhere(grid == 0)
        order = rng.permutation(len(free))
        cells = {}
        for name in OBJ_NAMES:
            for k in order:
                cell = free[k]
                if any((v == cell).all() for v in cells.values()):
                    continue
                cells[name] = cell.copy()
                break
            order = rng.permutation(len(free))
        grids.append(grid)
        occs.append(occ)
        objs.append(np.stack([cells[n] for n in OBJ_NAMES]))
        frees.append(np.array([f for f in free if not any(
            (f == v).all() for v in cells.values())]))
        gsizes.append(c.gridSize.get(fp, 0.25))
    fmax = max(len(f) for f in frees)
    counts = [len(f) for f in frees]
    frees = [np.concatenate([f] * (-(-fmax // len(f))))[:fmax] for f in frees]
    return (np.stack(grids), np.stack(occs), np.stack(objs), np.stack(frees),
            np.asarray(counts), np.asarray(gsizes, np.float64))


def _rotation_luts(g: int):
    """ndimage.rotate(order=0) by 180 - 45k degrees is a fixed
    permutation with holes per heading (get_local_occupancy_map)."""
    from scipy import ndimage

    luts, valids = [], []
    idx = np.arange(1, g * g + 1, dtype=np.int64).reshape(g, g)
    for k in range(8):
        rot = ndimage.rotate(idx, 180.0 - 45.0 * k, reshape=False, order=0)
        luts.append(np.where(rot > 0, rot - 1, 0))
        valids.append(rot > 0)
    return np.stack(luts), np.stack(valids)


def _render_tables(config):
    """(ray offsets, band height, band colour), each computed as
    GridHouseSim._render_numpy computes it, in float64."""
    fov = np.deg2rad(config.fieldOfView)
    col = np.rad2deg(np.arctan(np.linspace(-np.tan(fov / 2), np.tan(fov / 2),
                                           W)))
    ts = np.arange(RAY_STEP, MAX_RANGE, RAY_STEP)
    offsets = np.empty((8, W, len(ts), 2), np.float64)
    for k in range(8):
        for w in range(W):
            th = np.deg2rad(45.0 * k + col[w])
            d = np.array([np.cos(th), np.sin(th)])
            for i, t in enumerate(ts):
                offsets[k, w, i] = d * t
    dists = list(ts) + [MAX_RANGE]  # the last: no event along the ray
    height = np.array([int(np.clip(H / (dist + 0.3), 4, H)) for dist in dists])
    bases = [WALL_COLOR] + [c for n in OBJ_NAMES for c in OBJ_COLORS[n]]
    color = np.empty((len(bases), len(dists), 3), np.uint8)
    for b, base in enumerate(bases):
        for i, dist in enumerate(dists):
            shade = np.clip(1.5 / (0.4 + 0.25 * dist), 0.15, 1.0)
            color[b, i] = np.clip(base * shade, 0, 255).astype(np.uint8)
    return offsets, height, color


def _los_table(G: int):
    """los_t[n, k] = np.linspace(0, 1, n)[1:-1][k], the host's
    _line_blocked sample points, for every n it can meet."""
    out = np.zeros((2 * G + 2, 2 * G), np.float64)
    for n in range(3, 2 * G + 2):
        pts = np.linspace(0.0, 1.0, n)[1:-1]
        out[n, :len(pts)] = pts
    return out


def _action_tables(config):
    """Per action of allActions: the move per heading (host: round of the
    heading's cos/sin), the heading change, the toggle value."""
    acts = list(config.allActions)
    step_tab = np.zeros((len(acts), 8, 2), np.int64)
    is_move = np.zeros(len(acts), bool)
    drot = np.zeros(len(acts), np.int64)
    tog_val = -np.ones(len(acts), np.int64)
    rot_step = int(config.rotateStepDegrees // 45)
    for i, a in enumerate(acts):
        if a in MOVE_DEG:
            is_move[i] = True
            for k in range(8):
                th = np.deg2rad(45.0 * k + MOVE_DEG[a])
                step_tab[i, k] = np.round([np.cos(th), np.sin(th)]).astype(
                    np.int64)
        elif a == "RotateLeft":
            drot[i] = -rot_step
        elif a == "RotateRight":
            drot[i] = rot_step
        elif a in ("ToggleObjectOn", "ToggleObjectOff"):
            tog_val[i] = int(a == "ToggleObjectOn")
        else:
            raise NotImplementedError(a)
    return step_tab, is_move, drot, tog_val


def build_plan_bank(config, device="cpu") -> PlanBank:
    """All device constants of the grid sim, built once on the host."""
    if int(config.rotateStepDegrees) % 45:
        raise ValueError("the device grid sim needs rotateStepDegrees to be "
                         "a multiple of 45 (8 headings)")
    grids, occs, objs, frees, counts, gsizes = _plan_tables(config)
    lut, valid = _rotation_luts(config.RLVisibleGrid)
    offsets, height, color = _render_tables(config)
    heading = np.round(np.stack([np.cos(np.deg2rad(45.0 * np.arange(8))),
                                 np.sin(np.deg2rad(45.0 * np.arange(8)))],
                                axis=1)).astype(np.int64)
    fov_c = np.where(np.abs(heading).sum(1) == 1, 2, 1).astype(np.int64)

    def put(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PlanBank(
        put(grids, torch.uint8), put(occs, torch.uint8),
        put(objs, torch.int64), put(frees, torch.int64),
        put(counts, torch.int64), put(gsizes, torch.float64),
        put(lut, torch.int64), put(valid, torch.bool),
        put(offsets, torch.float64), put(height, torch.int64),
        put(color, torch.uint8),
        put(np.where(np.arange(H)[:, None] < H // 2, CEIL_COLOR,
                     FLOOR_COLOR).T[:, :, None], torch.uint8),
        put(_los_table(grids.shape[1]), torch.float64),
        put(heading), put(fov_c),
        *(put(a) for a in _action_tables(config)))


def visible_mask(bank: PlanBank, plan, pos, rot_idx, vis_dist: float):
    """(N, 2) bool: per object, GridHouseSim.visible_objects — within
    `vis_dist` metres, inside the 90-degree FoV, line of sight clear."""
    di = bank.obj_cells[plan] - pos[:, None, :]  # (N, 2obj, 2)
    n2 = di[..., 0] ** 2 + di[..., 1] ** 2
    # host: norm(d) * gridSize > visibleDist -> not visible, in float64
    dist = torch.sqrt(n2.to(torch.float64)) * bank.grid_size[plan][:, None]
    ok_dist = ~(dist > vis_dist)

    # FoV, integer-exact: the host's cosang = (d.h)/(|d| + 1e-9) >=
    # cos(45 deg) is, for headings u in {0,+-1}^2, s = d.u > 0 and
    # c * s^2 > |d|^2 (c = 2 on axis headings, 1 on diagonals); the 1e-9
    # makes exact-45-degree diagonals invisible, as the strict > does
    u = bank.heading[rot_idx]
    cfac = bank.fov_c[rot_idx]
    s = di[..., 0] * u[:, None, 0] + di[..., 1] * u[:, None, 1]
    ok_fov = (n2 == 0) | ((s > 0) & (cfac[:, None] * s * s > n2))

    # line of sight at the host's points a + (b - a) * t, float64, rounded
    # half to even
    n = 2 * di.abs().amax(-1) + 1  # (N, 2obj)
    t = bank.los_t[n]  # (N, 2obj, K)
    K = t.shape[-1]
    active = (torch.arange(K, device=pos.device) + 1) <= (n[..., None] - 2)
    pt = (pos.to(torch.float64)[:, None, None, :]
          + di.to(torch.float64)[:, :, None, :] * t[..., None])
    G = bank.grids.shape[1]
    rc = torch.round(pt).to(torch.int64).clamp(0, G - 1)
    wall = bank.grids[plan[:, None, None], rc[..., 0], rc[..., 1]] > 0
    blocked = (wall & active).any(-1)
    return ok_dist & ok_fov & ~blocked


def render_chw(bank: PlanBank, plan, pos, rot_idx, toggled):
    """(N, 3, 96, 96) u8 first-person view, the obs-dict layout:
    pixel-identical to GridHouseSim.get_image."""
    N, G = pos.shape[0], bank.grids.shape[1]
    origin = pos.to(torch.float64) + 0.5
    pts = origin[:, None, None, :] + bank.ray_offsets[rot_idx]  # (N,W,S,2)
    rc = torch.trunc(pts).to(torch.int64)  # the host's int()
    oob = ((rc < 0) | (rc >= G)).any(-1)
    rcc = rc.clamp(0, G - 1)
    wall = (bank.grids[plan[:, None, None], rcc[..., 0], rcc[..., 1]] > 0) \
        & ~oob
    cells = bank.obj_cells[plan]  # (N, 2obj, 2)
    obj_hit = ((rcc[..., None, 0] == cells[:, None, None, :, 0])
               & (rcc[..., None, 1] == cells[:, None, None, :, 1])
               & ~oob[..., None])  # (N, W, S, 2obj)
    any_obj = obj_hit.any(-1)
    event = oob | wall | any_obj
    S = event.shape[-1]
    # the first event along the ray (the host's break); S if none
    has = event.any(-1)
    first = torch.where(has, torch.argmax(event.to(torch.uint8), -1),
                        torch.full_like(has, S, dtype=torch.int64))
    at = first.clamp(max=S - 1)[..., None]
    hit_is_obj = torch.gather(any_obj, -1, at)[..., 0] & has
    # the host's object order at that sample
    hit = torch.gather(obj_hit, -2, at[..., None].expand(N, W, 1, 2))[:, :, 0]
    which = torch.argmax(hit.to(torch.uint8), -1)  # (N, W)
    tog = torch.gather(toggled.to(torch.int64), 1, which)
    cidx = torch.where(hit_is_obj, 1 + 2 * which + tog,
                       torch.zeros_like(which))
    band = bank.band_color[cidx, first]  # (N, W, 3)
    hgt = bank.band_height[first]  # (N, W)
    top = (H - hgt) // 2
    rows = torch.arange(H, device=pos.device)[None, :, None]
    in_band = (rows >= top[:, None, :]) & (rows < (top + hgt)[:, None, :])
    img = torch.where(in_band[:, None], band.permute(0, 2, 1)[:, :, None, :],
                      bank.background[None])
    return img.contiguous()


def local_occupancy(bank: PlanBank, plan, pos, rot_idx, g: int):
    """(N, 1, g, g) u8 egocentric rotated crop (get_local_occupancy_map),
    via the per-heading LUTs; the centre cell is 128."""
    p, radius = g + 3, g // 2
    ar = torch.arange(g, device=pos.device)
    rr = (pos[:, 0] + p - radius)[:, None, None] + ar[None, :, None]
    cc = (pos[:, 1] + p - radius)[:, None, None] + ar[None, None, :]
    flat = bank.occ_padded[plan[:, None, None], rr, cc].reshape(len(pos), -1)
    lut = bank.rot_lut[rot_idx].reshape(len(pos), -1)
    valid = bank.rot_valid[rot_idx].reshape(len(pos), -1)
    rot = torch.where(valid, torch.gather(flat, 1, lut),
                      torch.zeros_like(flat)).reshape(len(pos), g, g)
    rot[:, radius, radius] = 128
    return rot[:, None]


def free_at(bank: PlanBank, plan, cell):
    """(N,) bool, GridHouseSim._free: in bounds, not a wall, no object."""
    G = bank.grids.shape[1]
    inb = ((cell >= 0) & (cell < G)).all(-1)
    cc = cell.clamp(0, G - 1)
    not_wall = bank.grids[plan, cc[:, 0], cc[:, 1]] == 0
    on_obj = (bank.obj_cells[plan] == cell[:, None, :]).all(-1).any(1)
    return inb & not_wall & ~on_obj


def exe_action(bank: PlanBank, plan, pos, rot_idx, toggled, action,
               vis_dist: float):
    """Batched GridHouseSim._exe_action over allActions; a toggle acts on
    the first visible object at the current pose. Returns (pos, rot_idx,
    toggled)."""
    a = action.reshape(-1).long()
    target = pos + bank.step_tab[a, rot_idx]
    can = free_at(bank, plan, target) & bank.is_move[a]
    new_pos = torch.where(can[:, None], target, pos)
    new_rot = (rot_idx + bank.drot[a]) % 8
    vis = visible_mask(bank, plan, pos, rot_idx, vis_dist)
    first_vis = torch.argmax(vis.to(torch.uint8), 1)
    tv = bank.tog_val[a]
    do_tog = (tv >= 0) & vis.any(1)
    sel = (torch.nn.functional.one_hot(first_vis, 2).bool()
           & do_tog[:, None])
    new_tog = torch.where(sel, (tv > 0)[:, None], toggled)
    return new_pos, new_rot, new_tog


class ResetDraws(NamedTuple):
    """The random draws of one batched reset (the task is drawn apart)."""

    plan: torch.Tensor     # (n,) i64 floor plan index
    free_u: torch.Tensor   # (n,) f32 uniform in [0, 1): the start cell
    rot: torch.Tensor      # (n,) i64 heading index 0-7
    toggled: torch.Tensor  # (n, 2) bool object states before forcing


def draw_reset(generator: Optional[torch.Generator], bank: PlanBank, n: int,
               device="cpu") -> ResetDraws:
    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=device)

    return ResetDraws(
        randint(bank.grids.shape[0], (n,)),
        torch.rand((n,), generator=generator, device=device),
        randint(8, (n,)),
        torch.rand((n, 2), generator=generator, device=device) < 0.5)


def reset_from_draws(bank: PlanBank, draws: ResetDraws, task_id, task_obj,
                     task_on):
    """Episode reset (GridHouseSim.reset + _setup_task): a free start
    cell of the floor plan, the heading, random object states, then the
    commanded object forced opposite to the commanded act. Returns (plan,
    pos, rot_idx, toggled)."""
    plan = draws.plan.long()
    # float32, as the JAX package: uniform * count, truncated
    fidx = (draws.free_u.to(torch.float32)
            * bank.free_count[plan].to(torch.float32)).to(torch.int64)
    pos = bank.free_cells[plan, fidx]
    obj = task_obj[task_id]
    sel = torch.nn.functional.one_hot(obj, 2).bool()
    toggled = torch.where(sel, ~task_on[task_id][:, None], draws.toggled)
    return plan, pos, draws.rot.long(), toggled
