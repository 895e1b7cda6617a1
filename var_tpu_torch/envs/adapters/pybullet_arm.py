"""PyBullet-backed Kuka fourInARow adapter (gated on pybullet).

Real-physics counterpart of the built-in FourInARowSim: same task logic,
labeling, quotas and obs schema (all inherited), with the kinematics,
ray test and camera replaced by PyBullet calls mirroring the reference's
robot stack (reference: Envs/pybullet/arms/env_bases.py,
robot_manipulators.py:59-223, scene_abstract.py:8-49).

Requires `pybullet` plus the reference's URDF/SDF assets
(kuka_with_gripper2.sdf, table, key objects) under config.mediaPath.
Select with config.simBackend = 'pybullet'.

The twin of var_tpu/envs/adapters/pybullet_arm.py: the same calls in the
same order with the same arguments, the same numpy draws, and the camera
frame resized by `resize_linear_u8` (cv2's INTER_LINEAR, exact) in place
of cv2.
"""
from __future__ import annotations

import os

import numpy as np

from var_tpu_torch.envs.arm_sim import FourInARowPretextSim, FourInARowSim
from var_tpu_torch.envs.recording import resize_linear_u8


def _require_pybullet():
    try:
        import pybullet
        import pybullet_data  # noqa: F401
        from pybullet_utils import bullet_client
    except ImportError as e:
        raise ImportError(
            "simBackend='pybullet' requires the pybullet package "
            "(pip install pybullet) and the reference URDF assets; use "
            "simBackend='builtin' for the dependency-free simulator"
        ) from e
    return pybullet, bullet_client


class PyBulletFourInARow(FourInARowSim):
    """RL env with real PyBullet physics/rendering."""

    def __init__(self, config, audio=None):
        super().__init__(config, audio)
        self._p = None
        self.robotId = None
        self.objUids = []
        self.tableUid = None
        self._ee_orn = None

    # -- lifecycle ---------------------------------------------------------

    def _connect(self):
        pybullet, bullet_client = _require_pybullet()
        self._pb = pybullet
        mode = pybullet.GUI if self.config.render else pybullet.DIRECT
        self._p = bullet_client.BulletClient(connection_mode=mode)
        self._p.setGravity(0, 0, -9.8)
        self._p.setPhysicsEngineParameter(numSolverIterations=30)
        self._p.setTimeStep(1.0 / 240.0)
        self._load_models()

    def _load_models(self):
        c = self.config
        p = self._p
        media = c.mediaPath
        sdf = os.path.join(media, "kuka", "kuka_with_gripper2.sdf")
        self.robotId = p.loadSDF(sdf)[0]
        p.resetBasePositionAndOrientation(
            self.robotId, c.robotPosition, [0, 0, 0, 1])
        self.tableUid = p.loadURDF(
            os.path.join(media, "table", "table.urdf"), c.tablePosition,
            [0, 0, 0, 1])
        self.objUids = []
        for name in c.objList:
            path = os.path.join(media, "objects", "fourInARow", name,
                                name + ".urdf")
            self.objUids.append(p.loadURDF(path))
        self._ee_orn = p.getQuaternionFromEuler([0, -np.pi, 0])

    # -- physics overrides -------------------------------------------------

    def _move_ee(self, x, y):
        """IK position control with null-space limits
        (reference: robot_manipulators.py:204-223 invKin + applyAction)."""
        c = self.config
        p = self._p
        target = [x, y, c.endEffectorHeight]
        joints = p.calculateInverseKinematics(
            self.robotId, c.endEffectorIndex, target, self._ee_orn,
            lowerLimits=c.ik_ll, upperLimits=c.ik_ul, jointRanges=c.ik_jr,
            restPoses=c.ik_rp, jointDamping=c.ik_jd,
        )
        for j in range(c.endEffectorIndex + 1):
            p.setJointMotorControl2(
                self.robotId, j, p.POSITION_CONTROL,
                targetPosition=joints[j] if j < len(joints) else 0.0,
                force=c.positionControlMaxForce,
                positionGain=c.positionControlPositionGain,
                velocityGain=c.positionControlVelGain,
            )
        for _ in range(c.frameSkip):
            p.stepSimulation()
        state = p.getLinkState(self.robotId, c.endEffectorIndex)
        self.ee = np.asarray(state[0][:2])

    def _randomize(self):
        if self._p is None:
            self._connect()
        super()._randomize()  # draws objPose/ee targets with shared RNG logic
        c = self.config
        for uid, pose in zip(self.objUids, self.objPose):
            self._p.resetBasePositionAndOrientation(
                uid, [pose[0], pose[1], c.objZ[c.objList[0]]], [0, 0, 0, 1])
        self._move_ee(self.ee[0], self.ee[1])
        for _ in range(20):
            self._p.stepSimulation()

    def _apply_action_rl(self, action):
        c = self.config
        a = np.clip(np.asarray(action, dtype=np.float64).reshape(-1)[:2], -1, 1)
        target = self.ee + np.clip(a * 0.02, -0.02, 0.02)
        target[0] = np.clip(target[0], c.xMin, c.xMax)
        target[1] = np.clip(target[1], c.yMin, c.yMax)
        self._move_ee(target[0], target[1])

    def _apply_action_pretext(self, action):
        c = self.config
        dx = self.np_random.uniform(-0.3, 0.3)
        dy = self.np_random.uniform(-0.4, 0.4)
        target = self.ee + np.array([dx, dy])
        target[0] = np.clip(target[0], c.xMin, c.xMax)
        target[1] = np.clip(target[1], c.yMin, c.yMax)
        self._move_ee(target[0], target[1])

    def ray_test(self) -> int:
        """Ray from the gripper straight down to the table
        (reference: robot_manipulators.py:185-202)."""
        c = self.config
        p = self._p
        state = p.getLinkState(self.robotId, c.endEffectorIndex)
        src = list(state[0])
        dst = [src[0], src[1], -0.1]
        hit = p.rayTest(src, dst)[0][0]
        for i, uid in enumerate(self.objUids):
            if hit == uid:
                return i
        return -1

    def get_image(self) -> np.ndarray:
        """External camera render, crop, resize to 96x96
        (reference: robot_manipulators.py:155-183)."""
        c = self.config
        p = self._p
        h, w, _ = c.robotCamRenderSize
        view = p.computeViewMatrix(
            cameraEyePosition=c.externalCamEyePosition,
            cameraTargetPosition=c.externalCamTargetPosition,
            cameraUpVector=[0, 0, 1])
        proj = p.computeProjectionMatrixFOV(
            fov=c.robotFov, aspect=w / h, nearVal=0.1, farVal=3.0)
        _, _, rgba, _, _ = p.getCameraImage(
            w, h, view, proj, renderer=p.ER_TINY_RENDERER)
        rgb = np.reshape(rgba, (h, w, 4))[:, :, :3].astype(np.uint8)
        rgb = rgb[:, 12:87]  # crop columns (reference: :175)
        return resize_linear_u8(rgb, 96, 96)

    # -- GUI debug visuals (reference: env_bases.py:135-212) ----------------

    def drawRectangleDebug(self, debugLines, xMin, xMax, yMin, yMax, z):
        from .debug_draw import draw_rectangle

        return draw_rectangle(self._p, debugLines, xMin, xMax, yMin, yMax, z)

    def drawGrid(self, gridLines, gridSize, xMin, xMax, yMin, yMax, z):
        from .debug_draw import draw_grid

        return draw_grid(self._p, gridLines, gridSize, xMin, xMax, yMin,
                         yMax, z)

    def drawAABB(self, aabb):
        from .debug_draw import draw_aabb

        draw_aabb(self._p, aabb)

    def close(self):
        if self._p is not None:
            self._p.disconnect()
            self._p = None


class PyBulletFourInARowPretext(
        PyBulletFourInARow, FourInARowPretextSim):
    """Pretext collection on real physics (diamond: physics overrides from
    PyBulletFourInARow, obs schema/actions from FourInARowPretextSim)."""

    def __init__(self, config, audio=None):
        FourInARowPretextSim.__init__(self, config, audio)
        self._p = None
        self.robotId = None
        self.objUids = []
        self.tableUid = None
        self._ee_orn = None

    gen_obs = FourInARowPretextSim.gen_obs
    step = FourInARowPretextSim.step
