"""Built-in gridworld living-room simulator (pure NumPy).

Behavioral rebuild of the reference's AI2-THOR iTHOR navigation task
(reference: Envs/ai2thor/RL_env_VAR.py, pretext_env_VAR.py) without the
Unity server: procedurally generated living rooms with a FloorLamp and a
Television, an agent on a grid with 45-degree rotations, toggle actions,
and spoken FSC-style commands. Preserves:

- the obs dict schema {image (3,96,96) u8, occupancy (1,9,9) u8,
  goal_sound (1,600,40), current_sound, goal_sound_label,
  goal_sound_feat, image_feat} (RL_env_VAR.py:42-60);
- discrete 8-action space Move x4 / Rotate x2 / ToggleOn/Off
  (env_config.py:11-17);
- occupancy grid built from reachable positions, with the rotated 9x9
  egocentric crop whose center cell is marked 128
  (RL_env_VAR.py:169-209);
- domain randomization: random teleport start pose + random toggled
  states (RL_env_VAR.py:212-248); setupTask forcing the target object
  opposite to the commanded act (RL_env_VAR.py:251-266);
- the goal-sound inf-sentinel protocol: real sound at step 0 only,
  then inf so the frozen VAR reuses its cached goal embedding
  (RL_env_VAR.py:498-510);
- env reward 0 (the VAR provides all reward), termination by step budget
  only, checkTaskDone from object state, goal_area_count accounting at
  eval (RL_env_VAR.py:585-648);
- the pretext labeling rule: exactly one object visible -> state-consistent
  Task; zero or >=2 visible -> empty class taskNum (pretext_env_VAR.py).

The first-person frame is a cheap raycast renderer (walls shaded by
distance, objects as colored columns whose color encodes type and toggle
state) — enough signal for the VAR image CNN to learn view->task
associations.

A copy of var_tpu/envs/grid_sim.py that draws from its numpy RandomState in
the same order, so both packages collect byte-identical shards and episodes
from one seed. The first-person frame comes, as in the JAX package, from
the native raycast (`_render_native`, the port's own copy of the C++
library, var_tpu_torch/native.py), byte for byte the JAX library's frame.
`_render_numpy` is its plain version and the device sim's reference: the
two differ at a few boundary pixels where a float tie falls the other way
(tests/test_torch_native.py bounds the share). VAR_TPU_NO_NATIVE asks for
the numpy render. Episode images (episodeImgSaveInterval) are written as
PNG by envs/recording.py; with render=True the goal command plays at the
first step (utils/audio_play.py) and every step draws its current sound.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
from scipy import ndimage

from var_tpu_torch.data.audio_store import AudioStore, Task
from var_tpu_torch.envs import spaces
from var_tpu_torch.envs.core import Env
from var_tpu_torch.envs.recording import save_episode_image
from var_tpu_torch.utils.audio_play import play_clip

WALL_COLOR = np.array([120, 110, 100])
FLOOR_COLOR = np.array([60, 55, 50])
CEIL_COLOR = np.array([40, 42, 48])
OBJ_COLORS = {
    # (off, on)
    "FloorLamp": (np.array([90, 80, 30]), np.array([250, 230, 120])),
    "Television": (np.array([30, 30, 35]), np.array([80, 160, 250])),
}


def _gen_room(floor_plan: int, n: int = 16):
    """Deterministic room layout per floor plan id: rectangular room with a
    few rectangular obstacles. 0 = free, 1 = wall/occupied."""
    rng = np.random.RandomState(floor_plan)
    grid = np.ones((n, n), dtype=np.uint8)
    grid[1:-1, 1:-1] = 0
    for _ in range(rng.randint(2, 5)):
        h, w = rng.randint(2, 5), rng.randint(2, 5)
        r = rng.randint(2, n - h - 2)
        c = rng.randint(2, n - w - 2)
        grid[r : r + h, c : c + w] = 1
    return grid


class GridHouseSim(Env):
    """RL environment ('ai2thor-RL-v2' when simBackend == 'builtin')."""

    is_pretext = False

    def __init__(self, config, audio: Optional[AudioStore] = None):
        self.config = config
        self.audio = audio
        c = config
        d = OrderedDict(
            [
                ("image", spaces.Box(0, 255, shape=c.img_dim, dtype=np.uint8)),
                ("occupancy", spaces.Box(0, 255, shape=(1, c.RLVisibleGrid,
                                                        c.RLVisibleGrid),
                                         dtype=np.uint8)),
                ("goal_sound", spaces.Box(-np.inf, np.inf, shape=c.sound_dim)),
                ("current_sound", spaces.Box(-np.inf, np.inf, shape=c.sound_dim)),
                ("goal_sound_label", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                                dtype=np.int32)),
                ("goal_sound_feat", spaces.Box(-np.inf, np.inf,
                                               shape=(c.representationDim,))),
                ("image_feat", spaces.Box(-np.inf, np.inf,
                                          shape=(c.representationDim,))),
            ]
        )
        self.observation_space = spaces.DictSpace(d)
        self.action_space = spaces.Discrete(len(c.allActions))
        self.maxSteps = c.RLEnvMaxSteps
        self.visibleDist = c.RLVisibilityDistance

        self.np_random = np.random.RandomState(0)
        self.episodeCounter = -1
        self.envStepCounter = 0
        self.episodeReward = 0.0
        self.done = False
        self.goal_area_count = 0
        self.saved_pairs = []  # manual collection
        self.transcription = ""

        # task list (reference: RL_env_VAR.py taskList/task2ID built from
        # config.allTasks; also dataset.py:20-28)
        self.taskList = []
        for loc in c.allTasks:
            for obj in c.allTasks[loc]:
                for act in c.allTasks[loc][obj]:
                    self.taskList.append(Task(loc, obj, act))
        self.task2ID = {t: i for i, t in enumerate(self.taskList)}
        self.taskLocRange = {}
        for loc in c.allTasks:
            ids = [i for i, t in enumerate(self.taskList) if t.loc == loc]
            self.taskLocRange[loc] = (min(ids), max(ids) + 1)

        # per-class quotas for eval (mirrors the arm env; the iTHOR
        # evaluation also iterates per-class episodes)
        n_eval = getattr(c, "testEpisodesPerClass", 10)
        self.size_per_class = np.full((c.taskNum,), n_eval, dtype=np.int64)
        self.size_per_class_cumsum = np.cumsum(self.size_per_class)

        # world state
        self.floor_plan = None
        self.grid = None  # occupancy (rows, cols); 0 free
        self.occupancy_grid = None  # uint8 255 occupied / 0 free, padded
        self._pad = c.RLVisibleGrid + 3
        self.pos = np.zeros(2, dtype=np.int64)  # (row, col)
        self.rot = 0.0  # degrees, 0 = +row direction
        self.objects: Dict[str, dict] = {}
        self.task: Task = None
        self.taskID = 0
        self.goal_sound = None

    # -- world construction --------------------------------------------------

    def _build_world(self):
        c = self.config
        self.grid = _gen_room(self.floor_plan)
        # occupancy map like get_occupancy_grid (255 occupied), padded so the
        # 9x9 crop never leaves the array (RL_env_VAR.py:169-191)
        p = self._pad
        self.occupancy_grid = np.full(
            (self.grid.shape[0] + 2 * p, self.grid.shape[1] + 2 * p), 255,
            dtype=np.uint8)
        self.occupancy_grid[p : p + self.grid.shape[0],
                            p : p + self.grid.shape[1]] = (
            self.grid.astype(np.uint8) * 255)
        # place FloorLamp and Television at distinct free cells adjacent to
        # walls (deterministic per floor plan)
        rng = np.random.RandomState(self.floor_plan + 7777)
        free = np.argwhere(self.grid == 0)
        order = rng.permutation(len(free))
        self.objects = {}
        for name in ("FloorLamp", "Television"):
            for k in order:
                cell = free[k]
                if any((o["cell"] == cell).all() for o in self.objects.values()):
                    continue
                self.objects[name] = {"cell": cell.copy(), "isToggled": False}
                break
            order = rng.permutation(len(free))

    def _free(self, cell) -> bool:
        r, c = int(cell[0]), int(cell[1])
        if not (0 <= r < self.grid.shape[0] and 0 <= c < self.grid.shape[1]):
            return False
        if self.grid[r, c]:
            return False
        for o in self.objects.values():
            if o["cell"][0] == r and o["cell"][1] == c:
                return False
        return True

    def _random_teleport(self):
        while True:
            r = self.np_random.randint(self.grid.shape[0])
            c = self.np_random.randint(self.grid.shape[1])
            if self._free((r, c)):
                self.pos = np.array([r, c])
                rots = np.arange(0, 360, self.config.rotateStepDegrees)
                self.rot = float(self.np_random.choice(rots))
                return

    def _domain_randomization(self):
        if "randomInitialPose" in self.config.domainRandomization:
            self._random_teleport()
        if "randomObjState" in self.config.domainRandomization:
            for name in self.objects:
                self.objects[name]["isToggled"] = bool(self.np_random.randint(2))

    def _setup_task(self):
        """Force the target opposite to the commanded act
        (RL_env_VAR.py:251-266)."""
        self._domain_randomization()
        if self.task.act == "ToggleObjectOn":
            self.objects[self.task.obj]["isToggled"] = False
        elif self.task.act == "ToggleObjectOff":
            self.objects[self.task.obj]["isToggled"] = True

    # -- geometry -------------------------------------------------------------

    def _heading(self):
        th = np.deg2rad(self.rot)
        return np.array([np.cos(th), np.sin(th)])  # (drow, dcol)

    def visible_objects(self):
        """Objects within visibilityDistance and the 90-degree FoV with
        line of sight (reference relies on iTHOR's 'visible' metadata)."""
        out = []
        h = self._heading()
        for name, o in self.objects.items():
            d = o["cell"].astype(np.float64) - self.pos
            dist = np.linalg.norm(d) * self.config.gridSize.get(self.floor_plan, 0.25)
            if dist > self.visibleDist:
                continue
            if dist > 0:
                cosang = float(d @ h) / (np.linalg.norm(d) + 1e-9)
                if cosang < np.cos(np.deg2rad(self.config.fieldOfView / 2)):
                    continue
            if self._line_blocked(self.pos, o["cell"]):
                continue
            out.append(name)
        return out

    def _line_blocked(self, a, b) -> bool:
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) * 2 + 1
        for t in np.linspace(0.0, 1.0, n)[1:-1]:
            p = a + (b - a) * t
            if self.grid[int(round(p[0])), int(round(p[1]))]:
                return True
        return False

    def get_local_occupancy_map(self):
        """Rotated egocentric crop (RL_env_VAR.py:193-209)."""
        g = self.config.RLVisibleGrid
        p = self._pad
        r, c = int(self.pos[0]) + p, int(self.pos[1]) + p
        radius = g // 2
        visible = self.occupancy_grid[r - radius : r + radius + 1,
                                      c - radius : c + radius + 1]
        # Egocentric: the cell AHEAD of the agent must land above center for
        # every heading. This sim's heading is (drow, dcol)=(cos, sin) with
        # row increasing downward, so the image must turn by 180-rot
        # (verified for all 8 headings in tests/test_sims.py). The iTHOR
        # adapter keeps the reference's +y (correct for iTHOR's z-up-north
        # frame, RL_env_VAR.py:193-209).
        rotated = ndimage.rotate(visible, 180.0 - self.rot, reshape=False,
                                 order=0)
        rotated = rotated.copy()
        rotated[radius, radius] = 128
        return rotated

    # -- first-person rendering -----------------------------------------------

    def get_image(self) -> np.ndarray:
        """96x96x3 uint8 raycast view: the native renderer, or the numpy
        one where VAR_TPU_NO_NATIVE is set."""
        from var_tpu_torch.native import simcore

        lib = simcore()
        if lib is not None:
            return self._render_native(lib)
        return self._render_numpy()

    def _render_native(self, lib) -> np.ndarray:
        import ctypes

        H = W = 96
        out = np.empty((H, W, 3), dtype=np.uint8)
        names = list(self.objects.keys())
        objs = np.zeros((len(names), 4), dtype=np.float32)
        colors = np.zeros((len(names), 2, 3), dtype=np.float32)
        for i, name in enumerate(names):
            o = self.objects[name]
            objs[i] = (o["cell"][0], o["cell"][1], float(o["isToggled"]), i)
            colors[i, 0] = OBJ_COLORS[name][0]
            colors[i, 1] = OBJ_COLORS[name][1]
        grid = np.ascontiguousarray(self.grid, dtype=np.uint8)
        wall = np.asarray(WALL_COLOR, np.uint8)
        floor = np.asarray(FLOOR_COLOR, np.uint8)
        ceil = np.asarray(CEIL_COLOR, np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.raycast_render(
            grid.ctypes.data_as(u8p), grid.shape[0], grid.shape[1],
            objs.ctypes.data_as(f32p), len(names),
            colors.ctypes.data_as(f32p),
            float(self.pos[0]), float(self.pos[1]), float(self.rot),
            float(self.config.fieldOfView), H, W,
            wall.ctypes.data_as(u8p), floor.ctypes.data_as(u8p),
            ceil.ctypes.data_as(u8p), out.ctypes.data_as(u8p),
        )
        return out

    def _render_numpy(self) -> np.ndarray:
        H = W = 96
        img = np.empty((H, W, 3), dtype=np.uint8)
        img[: H // 2] = CEIL_COLOR
        img[H // 2 :] = FLOOR_COLOR
        fov = np.deg2rad(self.config.fieldOfView)
        angles = self.rot + np.rad2deg(
            np.arctan(np.linspace(-np.tan(fov / 2), np.tan(fov / 2), W)))
        max_range = 12.0
        obj_cells = {
            name: o["cell"] for name, o in self.objects.items()
        }
        for col, ang in enumerate(angles):
            th = np.deg2rad(ang)
            d = np.array([np.cos(th), np.sin(th)])
            hit_obj, hit_dist, wall_dist = None, None, max_range
            pos = self.pos.astype(np.float64) + 0.5
            for t in np.arange(0.15, max_range, 0.15):
                p = pos + d * t
                r, c = int(p[0]), int(p[1])
                if not (0 <= r < self.grid.shape[0] and 0 <= c < self.grid.shape[1]):
                    wall_dist = t
                    break
                # object occlusion check first
                matched = False
                for name, cell in obj_cells.items():
                    if cell[0] == r and cell[1] == c:
                        hit_obj, hit_dist = name, t
                        matched = True
                        break
                if matched:
                    break
                if self.grid[r, c]:
                    wall_dist = t
                    break
            dist = hit_dist if hit_obj else wall_dist
            # projected column height
            hgt = int(np.clip(H / (dist + 0.3), 4, H))
            top = (H - hgt) // 2
            shade = np.clip(1.5 / (0.4 + 0.25 * dist), 0.15, 1.0)
            if hit_obj:
                off, on = OBJ_COLORS[hit_obj]
                base = on if self.objects[hit_obj]["isToggled"] else off
            else:
                base = WALL_COLOR
            img[top : top + hgt, col] = np.clip(base * shade, 0, 255).astype(np.uint8)
        return img

    # -- sounds / labeling ------------------------------------------------------

    def _get_negatives(self, empty: bool, ground_truth: int) -> int:
        rng_lo, rng_hi = self.taskLocRange[self.task.loc]
        neg = int(self.np_random.randint(rng_lo, rng_hi))
        if not empty and ground_truth == neg:
            neg = self.config.taskNum
        return neg

    def check_task_done(self) -> bool:
        o = self.objects[self.task.obj]
        if self.task.act == "ToggleObjectOn":
            return bool(o["isToggled"])
        if self.task.act == "ToggleObjectOff":
            return not o["isToggled"]
        raise NotImplementedError(self.task.act)

    def _pos_act(self, obj_in_view: str) -> str:
        """RL labeling: choose the act consistent with *progress toward the
        commanded task* (RL_env_VAR.py:496... get_pos_act)."""
        acts = self.config.allTasks[self.task.loc][obj_in_view]
        if len(acts) == 1:
            return acts[0]
        toggled = self.objects[obj_in_view]["isToggled"]
        if self.check_task_done():  # choose the same
            return "ToggleObjectOn" if toggled else "ToggleObjectOff"
        return "ToggleObjectOff" if toggled else "ToggleObjectOn"

    def get_positive_negative(self, get_negative: bool, generate_audio: bool):
        """(RL_env_VAR.py:394-459)."""
        c = self.config
        visible = self.visible_objects()
        sound_positive = sound_negative = None
        intent_negative = None
        if len(visible) != 1:
            ground_truth = np.int32(c.taskNum)
            if generate_audio:
                sound_positive = np.zeros(shape=c.sound_dim, dtype=np.float32)
            if get_negative:
                intent_negative = self._get_negatives(True, int(ground_truth))
                if generate_audio:
                    sound_negative, _, _ = self.audio.getAudioFromTask(
                        self.np_random, self.taskList[intent_negative])
        else:
            obj = visible[0]
            act = self._pos_act(obj)
            pos_tsk = Task(self.task.loc, obj, act)
            ground_truth = np.int32(self.task2ID[pos_tsk])
            if generate_audio:
                sound_positive, _, _ = self.audio.getAudioFromTask(
                    self.np_random, pos_tsk)
            if get_negative:
                intent_negative = self._get_negatives(False, int(ground_truth))
                if generate_audio:
                    if intent_negative == c.taskNum:
                        sound_negative = np.zeros(shape=c.sound_dim,
                                                  dtype=np.float32)
                    else:
                        sound_negative, _, _ = self.audio.getAudioFromTask(
                            self.np_random, self.taskList[intent_negative])
        return sound_positive, sound_negative, ground_truth, None, intent_negative

    # -- Env API ------------------------------------------------------------------

    def reset(self):
        c = self.config
        if self.audio is None:
            self.audio = AudioStore(c)
        self.audio.loadData()

        self.episodeCounter += 1
        self.envStepCounter = 0
        self.episodeReward = 0.0
        self.done = False

        # choose task + floor plan (RL_env_VAR.py:275-280); round-robin the
        # task at eval time like the arm env
        if c.RLTrain or self.is_pretext or c.render:
            self.taskID = int(self.np_random.randint(len(self.taskList)))
        else:
            idx = np.where(self.size_per_class_cumsum <= self.episodeCounter)[0]
            self.taskID = 0 if len(idx) == 0 else min(
                int(idx.max() + 1), c.taskNum - 1)
        self.task = self.taskList[self.taskID]
        self.floor_plan = int(self.np_random.choice(c.allScene[self.task.loc]))
        self._build_world()
        self._setup_task()
        self.goal_area_count = 0
        return self.gen_obs()

    def gen_obs(self):
        c = self.config
        image = self.get_image()
        save_episode_image(c, image, self.episodeCounter, self.envStepCounter)
        local_occ = self.get_local_occupancy_map()
        # per-step current_sound only when something consumes it (see arm_sim)
        if c.RLRewardSoundSound or c.render:
            sound_positive, _, _, _, _ = self.get_positive_negative(
                get_negative=False, generate_audio=True)
        else:
            sound_positive = np.zeros(c.sound_dim, np.float32)
        if self.envStepCounter == 0:
            self.goal_sound, clip, self.transcription = \
                self.audio.getAudioFromTask(self.np_random, self.task)
            if c.render:
                # the spoken command, while rendering (RL_env_VAR.py:507,513)
                play_clip(clip)
        else:
            # inf sentinel -> frozen VAR reuses the cached goal embedding
            # (RL_env_VAR.py:498-510)
            self.goal_sound = np.full_like(self.goal_sound, np.inf)
        return OrderedDict(
            [
                ("image", np.transpose(image, (2, 0, 1))),
                ("occupancy", local_occ[None].astype(np.uint8)),
                ("goal_sound", np.asarray(self.goal_sound, dtype=np.float32)),
                ("current_sound", np.asarray(sound_positive, dtype=np.float32)),
                ("goal_sound_label", np.asarray([self.taskID], np.int32)),
                ("goal_sound_feat", np.zeros((c.representationDim,), np.float32)),
                ("image_feat", np.zeros((c.representationDim,), np.float32)),
            ]
        )

    def _exe_action(self, action_str: str):
        moves = {
            "MoveAhead": 0.0, "MoveBack": 180.0,
            "MoveLeft": -90.0, "MoveRight": 90.0,
        }
        if action_str in moves:
            th = np.deg2rad(self.rot + moves[action_str])
            step = np.array([np.cos(th), np.sin(th)])
            target = self.pos + np.round(step).astype(np.int64)
            if self._free(target):
                self.pos = target
        elif action_str == "RotateLeft":
            self.rot = (self.rot - self.config.rotateStepDegrees) % 360.0
        elif action_str == "RotateRight":
            self.rot = (self.rot + self.config.rotateStepDegrees) % 360.0
        elif action_str in ("ToggleObjectOn", "ToggleObjectOff"):
            visible = self.visible_objects()
            if len(visible) >= 1:
                # the reference toggles the (single) visible object
                self.objects[visible[0]]["isToggled"] = (
                    action_str == "ToggleObjectOn")
        else:
            raise NotImplementedError(action_str)

    def step(self, action):
        action_str = self.config.allActions[int(np.asarray(action).reshape(()))]
        self._exe_action(action_str)
        self.envStepCounter += 1
        obs = self.gen_obs()
        info = {}
        reward = 0.0  # VAR provides all reward (RL_env_VAR.py:638-641)
        self.done = self.envStepCounter >= self.maxSteps
        if not self.config.RLTrain and not self.is_pretext:
            if self.check_task_done():
                self.goal_area_count += 1
            if self.done:
                info["goal_area_count"] = self.goal_area_count
                self.goal_area_count = 0
        return obs, reward, self.done, info

    def render(self, mode="human"):
        return self.get_image()

    def saveManualPairs(self):
        """Flush manually collected pairs to a timestamped shard; returns
        its path, or None when no pair is buffered."""
        import os
        from datetime import datetime

        from var_tpu_torch.data.triplets import save_shard

        if not self.saved_pairs:
            return None
        name = "data_" + datetime.now().strftime("%m_%d_%Y_%H_%M_%S_%f")
        path = os.path.join(self.config.pretextDataDir[0], "train",
                            name + ".pickle")
        save_shard(path, list(self.saved_pairs))
        self.saved_pairs.clear()
        print("Data saved to", self.config.pretextDataDir[0])
        return path


class GridHousePretextSim(GridHouseSim):
    """Pretext collection env ('ai2thor-pretext-v2' builtin)
    (reference: Envs/ai2thor/pretext_env_VAR.py)."""

    is_pretext = True

    def __init__(self, config, audio: Optional[AudioStore] = None):
        super().__init__(config, audio)
        c = config
        d = OrderedDict(
            [
                ("image", spaces.Box(0, 255, shape=c.img_dim, dtype=np.uint8)),
                ("sound_negative_id", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                                 dtype=np.int32)),
                ("ground_truth", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                            dtype=np.int32)),
            ]
        )
        if c.pretextDataHasSound:
            d["sound_positive"] = spaces.Box(-np.inf, np.inf, shape=c.sound_dim)
            d["sound_negative"] = spaces.Box(-np.inf, np.inf, shape=c.sound_dim)
        self.observation_space = spaces.DictSpace(d)
        self.maxSteps = c.pretextEnvMaxSteps
        self.visibleDist = c.pretextVisibilityDistance

    def _pos_act(self, obj_in_view: str) -> str:
        """Pretext labeling: act consistent with the object's CURRENT state
        (pretext_env_VAR.py:34-43)."""
        acts = self.config.allTasks[self.task.loc][obj_in_view]
        if len(acts) == 1:
            return acts[0]
        return ("ToggleObjectOn" if self.objects[obj_in_view]["isToggled"]
                else "ToggleObjectOff")

    def gen_obs(self):
        c = self.config
        image = self.get_image()
        sp, sn, gt, _, ineg = self.get_positive_negative(
            get_negative=True, generate_audio=c.pretextDataHasSound)
        obs = OrderedDict(
            [
                ("image", np.transpose(image, (2, 0, 1))),
                ("ground_truth", np.asarray([gt], np.int32)),
                ("sound_negative_id", np.asarray([ineg], np.int32)),
            ]
        )
        if c.pretextDataHasSound:
            obs["sound_positive"] = np.asarray(sp, np.float32)
            obs["sound_negative"] = np.asarray(sn, np.float32)
        return obs

    def step(self, action):
        # random teleport per step (data collection — pretext_env_VAR random
        # exploration)
        self._random_teleport()
        if "randomObjState" in self.config.domainRandomization:
            for name in self.objects:
                self.objects[name]["isToggled"] = bool(self.np_random.randint(2))
        self.envStepCounter += 1
        obs = self.gen_obs()
        self.done = self.envStepCounter >= self.maxSteps
        return obs, 0.0, self.done, {}
