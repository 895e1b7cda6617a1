"""Built-in planar-arm "fourInARow" simulator (pure NumPy).

Behavioral rebuild of the reference's PyBullet Kuka task
(reference: Envs/pybullet/arms/tasks/fourInARow/fourInARow.py,
robot_manipulators.py): four identical objects in a row on a table, a
gripper moving in the XY plane, a spoken command naming which object (by
row order) to point at. Preserves:

- the obs dict schema {image (3,96,96) u8, goal_sound, current_sound
  (1,100,40), robot_pose (2,), goal_sound_label, goal_sound_feat,
  image_feat} (fourInARow.py:36-49);
- object shuffle + pose randomization ranges (fourInARow.py:141-170 with
  kuka/env_config.py constants);
- ray-test labeling of the pointed object -> intent, with the empty class
  taskNum when pointing at nothing (fourInARow.py:172-209);
- goal intent sampled at episode start (train) / round-robin by episode
  counter (test) (fourInARow.py:254-264, getIntentIdx);
- RL action = 2-D continuous, scaled to clipped +/-0.02 m XY deltas
  (robot_manipulators.py:127-153); pretext actions = random walk
  (robot_manipulators.py:59-86);
- optional env reward 1.0 when pointing at the commanded object
  (fourInARow.py:398-406) and goal_area_count success bookkeeping at
  test time (fourInARow.py:317-335).

The PyBullet dynamics/IK/TinyRenderer are replaced by direct end-effector
kinematics and a rasterized top-down camera view. Simulators are host-side
by design.

A copy of var_tpu/envs/arm_sim.py that draws from its numpy RandomState in
the same order, so both packages collect byte-identical shards from one
seed. Episode images (episodeImgSaveInterval) are written as PNG by
envs/recording.py; with render=True the goal command plays at the first
step (utils/audio_play.py) and every step draws its current sound.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from var_tpu_torch.data.audio_store import AudioStore
from var_tpu_torch.envs import spaces
from var_tpu_torch.envs.core import Env
from var_tpu_torch.envs.recording import save_episode_image
from var_tpu_torch.utils.audio_play import play_clip

# "key" object footprint used for the ray test (the reference ray-casts from
# the gripper straight down and reports the object hit; our objects are
# axis-aligned boxes of roughly the key mesh's footprint).
OBJ_HALF_X = 0.035
OBJ_HALF_Y = 0.03


class FourInARowSim(Env):
    """RL environment ('arms-RL-v2' when simBackend == 'builtin')."""

    def __init__(self, config, audio: Optional[AudioStore] = None):
        self.config = config
        self.audio = audio  # injected by the vec-env factory, like the
        # reference's module-level audioLoader (shmem_vec_env.py:16-22)

        c = config
        d = OrderedDict(
            [
                ("image", spaces.Box(0, 255, shape=c.img_dim, dtype=np.uint8)),
                ("goal_sound", spaces.Box(-np.inf, np.inf, shape=c.sound_dim)),
                ("current_sound", spaces.Box(-np.inf, np.inf, shape=c.sound_dim)),
                ("robot_pose", spaces.Box(-np.inf, np.inf, shape=(c.robotStateDim,))),
                ("goal_sound_label", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                                dtype=np.int32)),
                ("goal_sound_feat", spaces.Box(-np.inf, np.inf,
                                               shape=(c.representationDim,))),
                ("image_feat", spaces.Box(-np.inf, np.inf,
                                          shape=(c.representationDim,))),
            ]
        )
        self.observation_space = spaces.DictSpace(d)
        high = np.ones(c.RLActionDim)  # the Kuka profile is continuous
        self.action_space = spaces.Box(-high, high, dtype=np.float32)
        self.maxSteps = c.RLEnvMaxSteps

        self.np_random = np.random.RandomState(0)
        self.episodeCounter = -1
        self.envStepCounter = 0
        self.episodeReward = 0.0
        self.done = False

        # object bookkeeping (reference fourInARow.py:66-99)
        self.objList = c.objList
        self.objOrder = {}
        self.objPose = np.zeros((len(c.objList), 2))
        self.ee = np.zeros(2)
        self.intentIdx = None
        self.goal_sound = None
        self.ground_truth = None
        self.goal_area_count = 0
        self.saved_pairs = []  # manual collection

        # per-class episode quotas for eval (fourInARow.py:92-96)
        self.size_per_class = np.zeros((c.taskNum,), dtype=np.int64)
        for key in c.soundSource["size"]:
            self.size_per_class = self.size_per_class + np.asarray(
                c.soundSource["size"][key])
        self.size_per_class_cumsum = np.cumsum(self.size_per_class)

    # -- physics-free kinematics -------------------------------------------

    def _randomize(self):
        """Object shuffle + pose randomization (fourInARow.py:141-170)."""
        c = self.config
        randomx = self.np_random.uniform(c.xMin + c.objXRand[0],
                                         c.xMax + c.objXRand[1])
        randomy = self.np_random.uniform(c.yMin + c.objYRand[0],
                                         c.yMax + c.objYRand[1])
        shuffled = np.arange(len(self.objList))
        self.np_random.shuffle(shuffled)
        self.objOrder = dict(zip(range(len(self.objList)), shuffled))
        for i in range(len(self.objList)):
            y = randomy + self.objOrder[i] * c.objInterval + self.np_random.uniform(
                c.objsYRand[0], c.objsYRand[1])
            x = randomx + self.np_random.uniform(c.objsXRand[0], c.objsXRand[1])
            self.objPose[i] = (x, y)
        self.ee = np.array(
            [
                self.np_random.uniform(c.xMin + c.eeXInitRand[0],
                                       c.xMax + c.eeXInitRand[1]),
                self.np_random.uniform(c.yMin + c.eeYInitRand[0],
                                       c.yMax + c.eeYInitRand[1]),
            ]
        )

    def ray_test(self) -> int:
        """Index of the object under the gripper, or -1
        (robot_manipulators.py:185-202 rayTest from gripper to table)."""
        d = np.abs(self.objPose - self.ee[None, :])
        hit = (d[:, 0] <= OBJ_HALF_X) & (d[:, 1] <= OBJ_HALF_Y)
        if not hit.any():
            return -1
        # nearest hit wins (a ray hits exactly one body first)
        cand = np.where(hit)[0]
        return int(cand[np.argmin(np.linalg.norm(d[cand], axis=1))])

    def _apply_action_rl(self, action):
        """2-D action -> clipped +/-0.02 m deltas
        (robot_manipulators.py:127-153)."""
        c = self.config
        a = np.clip(np.asarray(action, dtype=np.float64).reshape(-1)[:2], -1, 1)
        self.ee = self.ee + np.clip(a * 0.02, -0.02, 0.02)
        self.ee[0] = np.clip(self.ee[0], c.xMin, c.xMax)
        self.ee[1] = np.clip(self.ee[1], c.yMin, c.yMax)

    def _apply_action_pretext(self, action):
        """Random-walk data collection (robot_manipulators.py:59-86).

        With config.pretextCoverageCollect, the walk is replaced by
        deliberate pose sampling (legitimate in simulation — the
        reference random-walks because a real arm must move
        continuously): with probability pretextBoundaryFrac the pose
        lands in a band around a random object's ray-test hitbox (the
        region where the VAR reward landscape is decided), otherwise
        uniformly over the workspace. Defaults keep reference semantics.
        """
        c = self.config
        flank_p = getattr(c, "pretextEndFlankFrac", 0.0)
        if flank_p > 0 and self.np_random.uniform() < flank_p:
            # Outward flank of a random END slot. Round-4 diagnosis
            # (ROADMAP "class_3 drag"): the end slots of the row leak
            # reward outward on their open side — no adjacent object to
            # discriminate against — out to 6-8 cm, beyond where the
            # reference random walk leaves enough empty-labeled views.
            # Teleporting a fraction of collection poses into that zone
            # covers it with ordinary (uniform-negative) samples; labels
            # still come from the ray test, so this changes the POSE
            # distribution only, never the labeling semantics. No hard
            # negatives (round-4 reward-wall lesson).
            slot = 0 if self.np_random.randint(2) == 0 else c.taskNum - 1
            inv = {v: k for k, v in self.objOrder.items()}
            obj = self.objPose[inv[slot]]
            sign = -1.0 if slot == 0 else 1.0  # slots ordered along +y
            band = getattr(c, "pretextEndFlankBand", 0.09)
            # strictly OUTSIDE the hitbox: flank poses must only add
            # empty-labeled views (probing showed that including the
            # hitbox edge biases end-class positives toward boundary
            # views and widens the leak instead of closing it)
            dy = self.np_random.uniform(OBJ_HALF_Y + 0.005, band)
            dx = self.np_random.uniform(-(OBJ_HALF_X + 0.02),
                                        OBJ_HALF_X + 0.02)
            self.ee = obj + np.array([dx, sign * dy])
        elif getattr(c, "pretextCoverageCollect", False):
            band = getattr(c, "pretextBoundaryBand", 0.03)
            if self.np_random.uniform() < getattr(
                    c, "pretextBoundaryFrac", 0.5):
                obj = self.objPose[self.np_random.randint(len(self.objList))]
                self.ee = obj + np.array([
                    self.np_random.uniform(-(OBJ_HALF_X + band),
                                           OBJ_HALF_X + band),
                    self.np_random.uniform(-(OBJ_HALF_Y + band),
                                           OBJ_HALF_Y + band),
                ])
            else:
                self.ee = np.array([
                    self.np_random.uniform(c.xMin, c.xMax),
                    self.np_random.uniform(c.yMin, c.yMax),
                ])
        else:
            dx = self.np_random.uniform(-0.3, 0.3)
            dy = self.np_random.uniform(-0.4, 0.4)
            self.ee = self.ee + np.array([dx, dy])
        self.ee[0] = np.clip(self.ee[0], c.xMin, c.xMax)
        self.ee[1] = np.clip(self.ee[1], c.yMin, c.yMax)

    # -- rendering ----------------------------------------------------------

    def get_image(self) -> np.ndarray:
        """96x96x3 uint8 top-down view: table, objects, gripper
        (replaces robot_manipulators.py:155-183 camera render + crop)."""
        c = self.config
        H = W = 96
        img = np.full((H, W, 3), 70, dtype=np.uint8)  # table gray
        # workspace mapping with margin, x (depth) -> rows, y -> cols
        x0, x1 = c.xMin - 0.08, c.xMax + 0.08
        y0, y1 = c.yMin - 0.12, c.yMax + 0.12

        def to_px(x, y):
            r = int((x - x0) / (x1 - x0) * (H - 1))
            col = int((y - y0) / (y1 - y0) * (W - 1))
            return np.clip(r, 0, H - 1), np.clip(col, 0, W - 1)

        # objects: golden "keys"
        hx = int(OBJ_HALF_X / (x1 - x0) * H) + 2
        hy = int(OBJ_HALF_Y / (y1 - y0) * W) + 2
        for i in range(len(self.objList)):
            r, col = to_px(*self.objPose[i])
            img[max(0, r - hx) : r + hx, max(0, col - hy) : col + hy] = (
                200, 170, 40)
        # gripper: red disc with a darker arm shadow toward the base
        r, col = to_px(*self.ee)
        rr, cc = np.ogrid[:H, :W]
        arm = (cc >= 0) & (cc <= col) & (np.abs(rr - r) <= 2)
        img[arm] = (90, 40, 40)
        disc = (rr - r) ** 2 + (cc - col) ** 2 <= 16
        img[disc] = (220, 40, 40)
        return img

    # -- sounds / labeling ---------------------------------------------------

    def _hard_negative_class(self, hit: int) -> int:
        """Spatially-hardest negative class for the current gripper pose.

        Empty views: the class of the NEAREST object — pushing
        just-outside-the-hitbox views away from that object's sound is
        what pulls the VAR reward peak inside the ray-test box (the
        round-3 probe failure mode: peaks saturating on a plateau wider
        than the box). On-object views: the class of the nearest OTHER
        object (the adjacent slot in the row), sharpening the
        between-object decision boundary."""
        d = np.linalg.norm(self.objPose - self.ee[None, :], axis=1)
        if hit >= 0:
            d[hit] = np.inf
        return self.objOrder[int(np.argmin(d))]

    def get_positive_negative(self, get_negative=True, generate_audio=True):
        """Label the current view by ray test (fourInARow.py:172-209).

        With config.pretextHardNegProb > 0, the negative class is the
        spatially-hardest one (see _hard_negative_class) with that
        probability instead of the reference's uniform draw — a
        collection-time extension; default 0.0 keeps reference semantics.
        """
        c = self.config
        hit = self.ray_test()
        sound_positive = sound_negative = None
        intent_negative = None
        hard_p = getattr(c, "pretextHardNegProb", 0.0)
        if hit < 0:
            intent_positive = c.taskNum  # empty
            if generate_audio:
                sound_positive = np.zeros(shape=c.sound_dim, dtype=np.float32)
            if get_negative:
                if hard_p > 0 and self.np_random.uniform() < hard_p:
                    intent_negative = self._hard_negative_class(hit)
                else:
                    intent_negative = self.np_random.randint(0, c.taskNum)
                if generate_audio:
                    sound_negative, _ = self.audio.genSoundFeat(
                        intentIdx=intent_negative, featType="MFCC",
                        rand_fn=self.np_random.randint)
        else:
            intent_positive = self.objOrder[hit]
            if generate_audio:
                sound_positive, _ = self.audio.genSoundFeat(
                    intentIdx=intent_positive, featType="MFCC",
                    rand_fn=self.np_random.randint)
            if get_negative:
                if hard_p > 0 and self.np_random.uniform() < hard_p:
                    intent_negative = self._hard_negative_class(hit)
                else:
                    intent_negative = self.np_random.randint(0, c.taskNum)
                if intent_positive == intent_negative:
                    intent_negative = c.taskNum
                    if generate_audio:
                        sound_negative = np.zeros(shape=c.sound_dim,
                                                  dtype=np.float32)
                else:
                    if generate_audio:
                        sound_negative, _ = self.audio.genSoundFeat(
                            intentIdx=intent_negative, featType="MFCC",
                            rand_fn=self.np_random.randint)
        return (sound_positive, sound_negative, np.int32(intent_positive),
                None, intent_negative)

    def _get_intent_idx(self):
        """Train: random; test: round-robin per-class quotas
        (fourInARow.py:254-264)."""
        c = self.config
        if c.RLTrain or c.render:
            self.intentIdx = int(self.np_random.randint(0, c.taskNum))
        else:
            idx = np.where(self.size_per_class_cumsum <= self.episodeCounter)[0]
            self.intentIdx = 0 if len(idx) == 0 else min(
                int(idx.max() + 1), c.taskNum - 1)

    def _setup_first_step(self):
        self._get_intent_idx()
        self.goal_sound, clip = self.audio.genSoundFeat(
            intentIdx=self.intentIdx, featType="MFCC",
            rand_fn=self.np_random.randint)
        self.ground_truth = np.int32(self.intentIdx)
        if self.config.render:
            # the spoken command, while rendering (RL_env_VAR.py:507,513)
            play_clip(clip)

    def gen_obs(self):
        c = self.config
        image = self.get_image()
        save_episode_image(c, image, self.episodeCounter, self.envStepCounter)
        if self.envStepCounter == 0:
            self._setup_first_step()
            goal_sound = np.asarray(self.goal_sound, dtype=np.float32)
        else:
            # Goal-sound cache sentinel after step 0 (the ai2thor protocol,
            # reference RL_env_VAR.py:498-510, extended to the arm): the
            # goal is fixed for the episode, so the VAR consumers reuse
            # their cached per-row embedding instead of re-encoding the
            # identical MFCC every step. The reference's arm env resent
            # the real sound each step only because its cache was hidden
            # global model state; ours is explicit per-row state
            # (rl/reward.py, rl/rollout_device.py), so mixed
            # fresh/cached rows from independent env resets are exact.
            goal_sound = np.full(c.sound_dim, np.inf, dtype=np.float32)
        # current_sound is consumed only by the sound-sound reward term and
        # render playback (reference: vec_pretext_normalize.py:84,
        # RLObsIgnore drops it from the policy); skip the per-step MFCC
        # otherwise.
        if c.RLRewardSoundSound or c.render:
            sound_positive, _, _, _, _ = self.get_positive_negative(
                get_negative=False)
        else:
            sound_positive = np.zeros(c.sound_dim, np.float32)
        return OrderedDict(
            [
                ("image", np.transpose(image, (2, 0, 1))),
                ("goal_sound", goal_sound),
                ("current_sound", np.asarray(sound_positive, dtype=np.float32)),
                ("robot_pose", self.ee.astype(np.float32).copy()),
                ("goal_sound_label", np.asarray([self.ground_truth], np.int32)),
                ("goal_sound_feat", np.zeros((c.representationDim,), np.float32)),
                ("image_feat", np.zeros((c.representationDim,), np.float32)),
            ]
        )

    # -- Env API -------------------------------------------------------------

    def reset(self):
        if self.audio is None:
            self.audio = AudioStore(self.config)
        self.audio.loadData()
        self.episodeCounter += 1
        self.envStepCounter = 0
        self.episodeReward = 0.0
        self.done = False
        self.goal_area_count = 0
        if self.config.ifReset or self.episodeCounter == 0:
            self._randomize()
        return self.gen_obs()

    def _rewards(self) -> float:
        c = self.config
        if getattr(c, "RLUseEnvReward", False):
            hit = self.ray_test()
            if hit >= 0 and self.objOrder[hit] == self.intentIdx:
                return 1.0
        return 0.0

    def _test_policy(self, info):
        """Success bookkeeping at eval time (fourInARow.py:317-335)."""
        if self.done:
            hit = self.ray_test()
            if hit >= 0 and self.objOrder[hit] == self.intentIdx:
                self.goal_area_count += 1
            info["goal_area_count"] = self.goal_area_count

    def _apply(self, action):
        self._apply_action_rl(action)

    def step(self, action):
        self._apply(action)
        self.envStepCounter += 1
        obs = self.gen_obs()
        info = {}
        reward = self._rewards()
        self.episodeReward += reward
        self.done = self.envStepCounter >= self.maxSteps
        if not self.config.RLTrain:
            self._test_policy(info)
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


class FourInARowPretextSim(FourInARowSim):
    """Pretext data-collection environment ('arms-pretext-v2' builtin)
    (reference: Envs/pybullet/arms/tasks/fourInARow/pretext_env_VAR.py)."""

    def __init__(self, config, audio: Optional[AudioStore] = None):
        super().__init__(config, audio)
        c = config
        d = OrderedDict(
            [
                ("image", spaces.Box(0, 255, shape=c.img_dim, dtype=np.uint8)),
                ("ground_truth", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                            dtype=np.int32)),
                ("sound_negative_id", spaces.Box(0, c.taskNum + 1, shape=(1,),
                                                 dtype=np.int32)),
            ]
        )
        if c.pretextDataHasSound:
            d["sound_positive"] = spaces.Box(-np.inf, np.inf, shape=c.sound_dim)
            d["sound_negative"] = spaces.Box(-np.inf, np.inf, shape=c.sound_dim)
        self.observation_space = spaces.DictSpace(d)
        high = np.ones(c.pretextActionDim)
        self.action_space = spaces.Box(-high, high, dtype=np.float32)
        self.maxSteps = c.pretextEnvMaxSteps

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

    def _apply(self, action):
        self._apply_action_pretext(action)

    def step(self, action):
        self._apply(action)
        self.envStepCounter += 1
        obs = self.gen_obs()
        self.done = self.envStepCounter >= self.maxSteps
        return obs, 0.0, self.done, {}
