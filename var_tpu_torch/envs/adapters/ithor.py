"""AI2-THOR iTHOR adapter (gated on the ai2thor package + Unity runtime).

Real-simulator counterpart of the built-in GridHouseSim: same task logic,
sound protocol (inf sentinel), labeling rules and obs schema (inherited),
with navigation/visibility/rendering served by the iTHOR Controller
(reference: Envs/ai2thor/RL_env_VAR.py:275-648).

Select with config.simBackend = 'ithor'.

The twin of var_tpu/envs/adapters/ithor.py: the same controller calls in
the same order with the same arguments, the same numpy draws, and the
frame resized by `resize_linear_u8` (cv2's INTER_LINEAR, exact) in place
of cv2.
"""
from __future__ import annotations

import numpy as np

from var_tpu_torch.envs.grid_sim import GridHousePretextSim, GridHouseSim
from var_tpu_torch.envs.recording import resize_linear_u8


def _require_ai2thor():
    try:
        from ai2thor.controller import Controller
        from ai2thor.platform import CloudRendering
    except ImportError as e:
        raise ImportError(
            "simBackend='ithor' requires the ai2thor package and its Unity "
            "runtime; use simBackend='builtin' for the dependency-free "
            "gridworld simulator"
        ) from e
    return Controller, CloudRendering


class ITHOREnv(GridHouseSim):
    """RL env against the real iTHOR scenes."""

    def __init__(self, config, audio=None):
        super().__init__(config, audio)
        self.controller = None
        self.reachable = {}
        self.robotY = {}
        self.min_xz = {}
        self.occ_grids = {}
        self.objMeta = {}

    # -- controller lifecycle (reference: RL_env_VAR.py:281-302) ------------

    def _ensure_controller(self):
        if self.controller is not None:
            return
        Controller, CloudRendering = _require_ai2thor()
        c = self.config
        platform = None if c.renderUnity else CloudRendering
        self.controller = Controller(
            agentMode="default", visibilityDistance=self.visibleDist,
            platform=platform, scene=f"FloorPlan{self.floor_plan}",
            gridSize=c.gridSize[self.floor_plan], snapToGrid=c.snapToGrid,
            rotateStepDegrees=c.rotateStepDegrees, renderDepthImage=False,
            renderInstanceSegmentation=False, width=c.img_dim[2],
            height=c.img_dim[1], fieldOfView=c.fieldOfView)

    def _build_world(self):
        """Fetch reachable positions + build the padded occupancy grid
        (reference: RL_env_VAR.py:169-191,307-318)."""
        self._ensure_controller()
        c = self.config
        ctrl = self.controller
        ctrl.reset(scene=f"FloorPlan{self.floor_plan}",
                   gridSize=c.gridSize[self.floor_plan])
        if self.floor_plan not in self.reachable:
            pos = ctrl.step(action="GetReachablePositions").metadata[
                "actionReturn"]
            self.reachable[self.floor_plan] = [(p["x"], p["z"]) for p in pos]
            self.robotY[self.floor_plan] = pos[0]["y"]
            arr = np.asarray(self.reachable[self.floor_plan])
            g = c.gridSize[self.floor_plan]
            pad = c.RLVisibleGrid + 3
            min_xz = arr.min(axis=0) - pad * g
            max_xz = arr.max(axis=0) + pad * g
            self.min_xz[self.floor_plan] = min_xz
            xs = np.arange(min_xz[0], max_xz[0] + g, g)
            zs = np.arange(min_xz[1], max_xz[1] + g, g)
            occ = np.full((len(zs), len(xs)), 255, dtype=np.uint8)
            rset = set(self.reachable[self.floor_plan])
            for i, z in enumerate(zs):
                for j, x in enumerate(xs):
                    if (round(float(x), 3), round(float(z), 3)) in {
                        (round(a, 3), round(b, 3)) for a, b in rset
                    }:
                        occ[len(zs) - i - 1, j] = 0
            self.occ_grids[self.floor_plan] = occ
        self.occupancy_grid = self.occ_grids[self.floor_plan]
        self._update_obj_meta()

    def _update_obj_meta(self):
        for o in self.controller.last_event.metadata["objects"]:
            if o["objectType"] in ("FloorLamp", "Television"):
                self.objMeta[o["objectType"]] = o

    # -- overrides of the sim geometry/state hooks --------------------------

    def _random_teleport(self):
        c = self.config
        while True:
            idx = self.np_random.randint(len(self.reachable[self.floor_plan]))
            x, z = self.reachable[self.floor_plan][idx]
            rots = np.arange(0, 360, c.rotateStepDegrees)
            event = self.controller.step(
                action="Teleport",
                position=dict(x=x, y=self.robotY[self.floor_plan], z=z),
                rotation=dict(x=0, y=float(self.np_random.choice(rots)), z=0),
                horizon=0, standing=True)
            if event.metadata["lastActionSuccess"]:
                return

    def _domain_randomization(self):
        if "randomInitialPose" in self.config.domainRandomization:
            self._random_teleport()
        self._update_obj_meta()
        if "randomObjState" in self.config.domainRandomization:
            for obj, meta in self.objMeta.items():
                act = self.np_random.choice(
                    ["ToggleObjectOff", "ToggleObjectOn"])
                self.controller.step(action=act, objectId=meta["objectId"],
                                     forceAction=True)
        self._update_obj_meta()

    def _setup_task(self):
        self._domain_randomization()
        meta = self.objMeta[self.task.obj]
        if self.task.act == "ToggleObjectOn":
            self.controller.step(action="ToggleObjectOff",
                                 objectId=meta["objectId"], forceAction=True)
        elif self.task.act == "ToggleObjectOff":
            self.controller.step(action="ToggleObjectOn",
                                 objectId=meta["objectId"], forceAction=True)
        self._update_obj_meta()

    def visible_objects(self):
        self._update_obj_meta()
        return [k for k, o in self.objMeta.items() if o["visible"]]

    def check_task_done(self) -> bool:
        self._update_obj_meta()
        toggled = self.objMeta[self.task.obj]["isToggled"]
        return toggled if self.task.act == "ToggleObjectOn" else not toggled

    @property
    def objects(self):
        """Map iTHOR metadata onto the sim's objects dict shape."""
        return {
            k: {"cell": np.zeros(2), "isToggled": o.get("isToggled", False)}
            for k, o in self.objMeta.items()
        }

    @objects.setter
    def objects(self, _value):
        pass  # state lives in the simulator

    def get_image(self) -> np.ndarray:
        frame = np.asarray(self.controller.last_event.frame)
        return resize_linear_u8(frame, 96, 96)

    def get_local_occupancy_map(self):
        from scipy import ndimage

        c = self.config
        agent = self.controller.last_event.metadata["agent"]
        x, z = agent["position"]["x"], agent["position"]["z"]
        y = agent["rotation"]["y"]
        g = c.gridSize[self.floor_plan]
        min_xz = self.min_xz[self.floor_plan]
        rows, cols = self.occupancy_grid.shape
        r = int(rows - (z - min_xz[1]) / g - 1)
        col = int((x - min_xz[0]) / g)
        radius = c.RLVisibleGrid // 2
        visible = self.occupancy_grid[r - radius : r + radius + 1,
                                      col - radius : col + radius + 1]
        rotated = ndimage.rotate(visible, y, reshape=False, order=0).copy()
        rotated[radius, radius] = 128
        return rotated

    def _exe_action(self, action_str: str):
        if action_str not in ("ToggleObjectOn", "ToggleObjectOff"):
            event = self.controller.step(action=action_str)
            if not event.metadata["lastActionSuccess"]:
                pass  # blocked moves are legal no-ops
        else:
            visible = self.visible_objects()
            if visible:
                self.controller.step(
                    action=action_str,
                    objectId=self.objMeta[visible[0]]["objectId"])
        self.controller.step("Pass")  # refresh frame (RL_env_VAR.py:598)

    def close(self):
        if self.controller is not None:
            self.controller.stop()
            self.controller = None


class ITHORPretextEnv(ITHOREnv, GridHousePretextSim):
    """Pretext collection against real iTHOR scenes."""

    def __init__(self, config, audio=None):
        ITHOREnv.__init__(self, config, audio)
        # pretext obs space / maxSteps / visibility from the pretext sim
        tmp = GridHousePretextSim(config, audio)
        self.observation_space = tmp.observation_space
        self.maxSteps = config.pretextEnvMaxSteps
        self.visibleDist = config.pretextVisibilityDistance

    is_pretext = True
    _pos_act = GridHousePretextSim._pos_act
    gen_obs = GridHousePretextSim.gen_obs

    def step(self, action):
        self._random_teleport()
        if "randomObjState" in self.config.domainRandomization:
            for obj, meta in self.objMeta.items():
                act = self.np_random.choice(
                    ["ToggleObjectOff", "ToggleObjectOn"])
                self.controller.step(action=act, objectId=meta["objectId"],
                                     forceAction=True)
        self.envStepCounter += 1
        obs = self.gen_obs()
        self.done = self.envStepCounter >= self.maxSteps
        return obs, 0.0, self.done, {}
