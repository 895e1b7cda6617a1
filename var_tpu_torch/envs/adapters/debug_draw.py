"""PyBullet GUI debug-draw helpers.

Rebuild of the reference BaseEnv's interactive debugging visuals
(reference: Envs/pybullet/arms/env_bases.py:135-212): a green workspace
rectangle, a blue 2-D grid, and a 12-edge AABB wireframe with axis-colored
edges at the min corner. They only have an effect under a GUI connection;
pybullet ignores user debug items in DIRECT mode. The twin of
var_tpu/envs/adapters/debug_draw.py.
"""
from __future__ import annotations

import numpy as np

_GREEN = (0, 1, 0)
_BLUE = (0, 0, 1)
_WHITE = (1, 1, 1)


def draw_rectangle(client, debug_lines: list, x_min, x_max, y_min, y_max, z):
    """Axis-aligned rectangle on the z plane, green width-5 lines; item ids
    are appended to debug_lines so callers can remove them later
    (reference: env_bases.py:135-148 drawRectangleDebug)."""
    edges = [
        ((x_min, y_min), (x_max, y_min)),
        ((x_min, y_max), (x_max, y_max)),
        ((x_max, y_min), (x_max, y_max)),
        ((x_min, y_min), (x_min, y_max)),
    ]
    for (sx, sy), (ex, ey) in edges:
        debug_lines.append(client.addUserDebugLine(
            [sx, sy, z], [ex, ey, z], _GREEN, lineWidth=5))
    return debug_lines


def draw_grid(client, grid_lines: list, grid_size, x_min, x_max, y_min,
              y_max, z):
    """2-D grid over [x_min,x_max]x[y_min,y_max], blue width-3 lines;
    interior lines only, spanning to the last grid point like the
    reference (env_bases.py:150-161 drawGrid)."""
    x = np.arange(x_min, x_max, grid_size)
    y = np.arange(y_min, y_max, grid_size)
    for xi in x[1:]:
        grid_lines.append(client.addUserDebugLine(
            [xi, y_min, z], [xi, y[-1], z], _BLUE, lineWidth=3))
    for yi in y[1:]:
        grid_lines.append(client.addUserDebugLine(
            [x_min, yi, z], [x[-1], yi, z], _BLUE, lineWidth=3))
    return grid_lines


# AABB wireframe edge list: corners as (x,y,z) min/max selectors, with the
# reference's color scheme — RGB axis colors on the three min-corner edges,
# a salmon top-far edge, white elsewhere (env_bases.py:162-212 drawAABB).
_AABB_EDGES = [
    ((0, 0, 0), (1, 0, 0), (1, 0, 0)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 0)),
    ((0, 0, 0), (0, 0, 1), (0, 0, 1)),
    ((0, 0, 1), (0, 1, 1), _WHITE),
    ((0, 0, 1), (1, 0, 1), _WHITE),
    ((1, 0, 0), (1, 0, 1), _WHITE),
    ((1, 0, 0), (1, 1, 0), _WHITE),
    ((1, 1, 0), (0, 1, 0), _WHITE),
    ((0, 1, 0), (0, 1, 1), _WHITE),
    ((1, 1, 1), (0, 1, 1), (1.0, 0.5, 0.5)),
    ((1, 1, 1), (1, 0, 1), _WHITE),
    ((1, 1, 1), (1, 1, 0), _WHITE),
]


def draw_aabb(client, aabb):
    """Wireframe of an axis-aligned bounding box given as (min, max)
    corner triples — all 12 edges (reference: env_bases.py:162-212)."""
    lo, hi = aabb[0], aabb[1]

    def corner(sel):
        return [hi[i] if sel[i] else lo[i] for i in range(3)]

    for a, b, color in _AABB_EDGES:
        client.addUserDebugLine(corner(a), corner(b), list(color))
