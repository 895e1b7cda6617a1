"""Stand-ins for PyBullet and AI2-THOR that label, for whole collections.

tests/fake_backends.py records every call the simulator adapters make, but
its answers never change: its ray test hits nothing and its iTHOR scene
shows the lamp and hides the TV whatever the agent does, so a pretext
collection through an adapter never fills its class quotas. The two
subclasses here answer from the state the adapter pushed into them:

- `LabellingBulletClient.rayTest` hits the object whose footprint holds
  the ray's xy, with the rule of the built-in arm sim
  (var_tpu_torch/envs/arm_sim.py: |dx| <= 0.035, |dy| <= 0.03 of the pose
  the adapter set by resetBasePositionAndOrientation, the nearest of
  several), and the camera image shows the gripper and the objects.
- `LabellingThorController` places both objects at reachable cells,
  moves and turns the agent on the move and rotate actions, and sets each
  object's `visible` from the agent's cell, its facing, the field of view
  and the visibility distance it was built with; its frames depend on the
  agent's pose and the objects' states.

Both are used through `install_labelling_pybullet` and
`install_labelling_ai2thor`, which put the recording modules of
tests/fake_backends.py into sys.modules with these classes in them. The
stand-ins live in one process: a ShmemVecEnv worker never sees them, so
runs under them use vecEnvBackend='dummy'. Imports only numpy and
tests.fake_backends (chip_smoke.py imports it too).
"""
from __future__ import annotations

import sys

import numpy as np

from tests.fake_backends import (
    FakeBulletClient,
    FakeThorController,
    install_fake_ai2thor,
    install_fake_pybullet,
)

# the built-in arm sim's ray-test footprint (var_tpu_torch/envs/arm_sim.py
# OBJ_HALF_X, OBJ_HALF_Y)
OBJ_HALF_X = 0.035
OBJ_HALF_Y = 0.03


class SysModules:
    """monkeypatch.setitem's one use in the installers, for a caller with
    no pytest (chip_smoke.py): sets the item and keeps the old one, so
    `undo` restores sys.modules."""

    def __init__(self):
        self._saved = []

    def setitem(self, mapping, name, value):
        self._saved.append((mapping, name, mapping.get(name)))
        mapping[name] = value

    def undo(self):
        for mapping, name, old in reversed(self._saved):
            if old is None:
                mapping.pop(name, None)
            else:
                mapping[name] = old
        self._saved.clear()


# ---------------------------------------------------------------------------
# PyBullet


class LabellingBulletClient(FakeBulletClient):
    """The recording client, with a ray test and a camera that answer from
    the objects' poses."""

    def __init__(self, connection_mode=None):
        super().__init__(connection_mode)
        self.object_uids = []
        self.poses = {}

    def loadURDF(self, path, *a, **k):
        uid = super().loadURDF(path, *a, **k)
        if "objects" in str(path):
            self.object_uids.append(uid)
        return uid

    def resetBasePositionAndOrientation(self, uid, pos, orn):
        super().resetBasePositionAndOrientation(uid, pos, orn)
        self.poses[uid] = np.asarray(pos[:2], np.float64)

    def _hit(self, src):
        """The uid under the ray's xy, or -1."""
        best, best_d = -1, np.inf
        xy = np.asarray(src[:2], np.float64)
        for uid in self.object_uids:
            if uid not in self.poses:
                continue
            d = np.abs(self.poses[uid] - xy)
            if d[0] <= OBJ_HALF_X and d[1] <= OBJ_HALF_Y:
                n = float(np.hypot(d[0], d[1]))
                if n < best_d:
                    best, best_d = uid, n
        return best

    def rayTest(self, src, dst):
        self.ray_hit_uid = self._hit(src)
        return super().rayTest(src, dst)

    def getCameraImage(self, w, h, view, proj, renderer=None):
        """The stand-in's ramp with a square per object (its shade its
        index) and a white one at the gripper, placed by x and y on the
        table."""
        self._rec("getCameraImage", w, h, renderer=renderer)
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., 0] = np.arange(w, dtype=np.uint32)[None, :] % 256
        rgba[..., 1] = np.arange(h, dtype=np.uint32)[:, None] % 256
        rgba[..., 2] = 7
        rgba[..., 3] = 255

        def square(xy, value):
            # x in [0.3, 0.9] runs down the rows, y in [-0.4, 0.4] across
            r = int(np.clip((xy[0] - 0.3) / 0.6 * h, 0, h - 1))
            c = int(np.clip((xy[1] + 0.4) / 0.8 * w, 0, w - 1))
            rgba[max(r - 4, 0):r + 5, max(c - 4, 0):c + 5, :3] = value

        for i, uid in enumerate(self.object_uids):
            if uid in self.poses:
                square(self.poses[uid], 40 + 50 * i)
        square(self.link_pos, 255)
        self.camera_image = rgba
        return (w, h, rgba.ravel(), None, None)


def install_labelling_pybullet(monkeypatch):
    """tests/fake_backends.py's pybullet modules, with the labelling
    client as bullet_client.BulletClient."""
    pb = install_fake_pybullet(monkeypatch)
    sys.modules["pybullet_utils.bullet_client"].BulletClient = \
        LabellingBulletClient
    return pb


# ---------------------------------------------------------------------------
# AI2-THOR

# (dx, dz) of one move in units of the agent's facing (sin y, cos y) and
# its right (cos y, -sin y)
_MOVES = {"MoveAhead": (1, 0), "MoveBack": (-1, 0),
          "MoveRight": (0, 1), "MoveLeft": (0, -1)}


class LabellingThorController(FakeThorController):
    """A 5 x 4 block of reachable cells with the lamp and the TV at two of
    them; visibility from the agent's pose; frames from the scene's
    state."""

    COLS, ROWS = 5, 4

    def __init__(self, reachable=None, grid=0.25, **kwargs):
        cells = [{"x": 1.0 + i * grid, "y": 0.9, "z": 2.0 + j * grid}
                 for i in range(self.COLS) for j in range(self.ROWS)]
        self.places = {"FloorLamp": (1.0, 2.0 + (self.ROWS - 1) * grid),
                       "Television": (1.0 + (self.COLS - 1) * grid, 2.0)}
        self.frames = {}
        super().__init__(reachable=cells if reachable is None else reachable,
                         grid=grid, **kwargs)

    def _visible(self, name):
        a = self.agent
        ox, oz = self.places[name]
        dx, dz = ox - a["position"]["x"], oz - a["position"]["z"]
        dist = float(np.hypot(dx, dz))
        if dist > float(self.init_kwargs.get("visibilityDistance", 1.5)):
            return False
        if dist < 1e-9:
            return True
        y = np.deg2rad(a["rotation"]["y"])
        cos = (dx * np.sin(y) + dz * np.cos(y)) / dist
        half = np.deg2rad(float(self.init_kwargs.get("fieldOfView", 90)) / 2)
        return bool(cos >= np.cos(half) - 1e-9)

    def _frame(self):
        """A seeded (300, 300, 3) frame per pose and object state."""
        a = self.agent
        key = (int(round(a["position"]["x"] / self.grid)),
               int(round(a["position"]["z"] / self.grid)),
               int(round(a["rotation"]["y"])) % 360,
               *(int(bool(o["isToggled"])) for o in self.objects.values()),
               *(int(bool(o["visible"])) for o in self.objects.values()))
        if key not in self.frames:
            rng = np.random.RandomState(np.mod(key, 2 ** 32).astype(np.uint32))
            self.frames[key] = rng.randint(0, 256, (300, 300, 3)).astype(
                np.uint8)
        return self.frames[key]

    def _event(self, success, action_return=None):
        for name, o in self.objects.items():
            o["visible"] = self._visible(name)
        event = super()._event(success, action_return)
        event.frame = self._frame()
        return event

    def step(self, action=None, **kwargs):
        a = self.agent
        if action in _MOVES:
            ahead, right = _MOVES[action]
            y = np.deg2rad(a["rotation"]["y"])
            x = a["position"]["x"] + self.grid * (
                ahead * np.sin(y) + right * np.cos(y))
            z = a["position"]["z"] + self.grid * (
                ahead * np.cos(y) - right * np.sin(y))
            if any(abs(p["x"] - x) < 1e-6 and abs(p["z"] - z) < 1e-6
                   for p in self.reachable):
                a["position"] = {"x": round(x, 6), "y": a["position"]["y"],
                                 "z": round(z, 6)}
        elif action in ("RotateLeft", "RotateRight"):
            turn = float(self.init_kwargs.get("rotateStepDegrees", 90))
            sign = -1.0 if action == "RotateLeft" else 1.0
            a["rotation"] = dict(a["rotation"],
                                 y=(a["rotation"]["y"] + sign * turn) % 360)
        return super().step(action, **kwargs)


def install_labelling_ai2thor(monkeypatch):
    """tests/fake_backends.py's ai2thor modules with the labelling
    controller as Controller."""
    return install_fake_ai2thor(monkeypatch,
                                controller_cls=LabellingThorController)
