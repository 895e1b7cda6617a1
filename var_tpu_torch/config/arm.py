"""Arm (Kuka fourInARow) configuration profile.

A copy of var_tpu/config/arm.py: the same knob names, defaults and
semantics, so that a config file or a --set line means the same in both
packages. The backend knobs at the bottom keep their names too;
`audioBackend='pallas'` selects the port's hand-written CUDA mel-log-DCT
kernel (var_tpu_torch/ops/mel_log_dct.py); `meshShape={'dp': n}` trains
on n ranks (var_tpu_torch/parallel/). A knob of a path this package does
not run (realTimeVec's live plot) is kept so that configs stay
interchangeable; the trainer raises where one is set.
"""
import os

import numpy as np

from .base import ConfigBase


class ArmConfig(ConfigBase):
    def __init__(self):
        self.name = self.__class__.__name__
        self.pretext_RL = "pretext"  # which driver is running; set by entry points

        # --- Visualization ---
        self.render = False
        self.realTimeVec = False

        # --- VAR (pretext) settings ---
        self.pretextTrain = True
        self.pretextCollection = True
        self.pretextManualCollect = False
        self.pretextManualControl = False
        self.pretextDataDir = [os.path.join("data", "pretext_training", "default")]
        self.pretextCollectNum = [50, 50, 50, 50, 100]
        self.pretextDataHasSound = False
        self.pretextModelFineTune = True
        # registry key -> dataset class (see var_tpu_torch/data/triplets.py)
        self.pretextDataset = (
            "VARFineTuneDataset" if self.pretextModelFineTune else "VARDataset"
        )
        self.pretextDataFileLoadNum = ["all", "all", "all"]
        self.pretextModel = "arm_VARPretextNet"  # registry key (var_tpu_torch/models)
        self.pretextModelSaveDir = os.path.join("data", "pretext_model", "default")
        self.pretextModelLoadDir = os.path.join(self.pretextModelSaveDir, "39")
        self.pretextModelSaveInterval = 10
        self.pretextDataNumWorkers = 4  # host-side prefetch threads
        self.pretextDataEpisode = 500
        self.pretextDataNumFiles = 20
        self.pretextTrainBatchSize = 128
        self.pretextTestBatchSize = 128
        self.pretextLR = 1e-4
        self.pretextAdamL2 = 1e-6
        self.pretextLRStep = "step"
        self.pretextEpoch = 40
        self.pretextLRDecayEpoch = [10, 30, 50]
        self.pretextLRDecayGamma = 0.2
        self.representationDim = 3
        self.tripletMargin = 1.0
        # collection-time triplet quality knobs (defaults = reference
        # semantics: uniform negatives, random-walk poses). Hard
        # negatives pick the spatially-nearest wrong class with this
        # probability (arm_sim._hard_negative_class); coverage
        # collection teleports the gripper instead of random-walking,
        # concentrating pretextBoundaryFrac of poses in a band of
        # pretextBoundaryBand metres around object hitboxes — the
        # region that decides whether the VAR reward peak falls inside
        # the ray-test success box (fourInARow.py:317-335).
        self.pretextHardNegProb = 0.0
        self.pretextCoverageCollect = False
        self.pretextBoundaryFrac = 0.5
        self.pretextBoundaryBand = 0.03
        # End-slot flank coverage (round-5): fraction of collection
        # poses teleported into the outward flank zone of the row's end
        # slots (out to pretextEndFlankBand metres from the end object's
        # centre), where end-slot reward leaks outward with the default
        # random walk (ROADMAP round-4 class_3 diagnosis). Pose
        # distribution only — ray-test labeling and uniform negatives
        # are unchanged. 0.0 keeps reference semantics.
        self.pretextEndFlankFrac = 0.0
        self.pretextEndFlankBand = 0.09
        self.plotRepresentation = 50
        self.plotNumBatch = 10
        self.annotateLastBatch = False
        self.plotRepresentationExtra = False
        self.plotExtraPath = os.path.join("data", "episodeRecord", "extra")
        # pretext env configuration
        self.pretextEnvName = "arms-pretext-v2"
        self.pretextEnvMaxSteps = 30
        self.pretextEnvSeed = 453
        self.pretextNumEnvs = 4 if not self.render else 1

        # --- RL settings ---
        self.RLManualControl = False
        self.RLManualControlLoaded = False
        if self.realTimeVec:
            self.RLManualControlLoaded = True
        self.RLTrain = False
        self.RLModelFineTune = True
        self.RLPolicyBase = "arm_VAR"
        self.RLGamma = 0.99
        self.RLRecurrentPolicy = True
        self.RLLr = 3e-5
        self.RLEps = 1e-5
        # PPO LR schedule — None keeps the reference's constant-LR Adam
        # (reference: RL.py:115). 'linear' or 'cosine' holds RLLr until
        # RLLrDecayStart of the run, then decays to RLLr*RLLrFinalFactor,
        # damping the post-saturation success-band oscillation.
        self.RLLrDecay = None
        self.RLLrDecayStart = 0.33
        self.RLLrFinalFactor = 0.1
        self.RLMaxGradNorm = 0.5
        self.RLTotalSteps = 3e6
        self.RLModelSaveInterval = 200
        self.RLLogInterval = 100
        self.RLObsIgnore = {"current_sound", "goal_sound", "goal_sound_label"}
        self.RLModelSaveDir = os.path.join("data", "RL_model", "default")
        self.RLModelLoadDir = os.path.join("data", "RL_model", "default", "00000")
        self.RLUseProperTimeLimits = False
        self.RLRecurrentSize = 512
        self.RLRecurrentInputSize = 128
        self.RLActionHiddenSize = 128
        # RL env configuration
        self.RLEnvMaxSteps = 100
        self.RLEnvName = "arms-RL-v2"
        self.RLEnvSeed = 40
        self.RLNumEnvs = 8 if not self.render else 1
        self.RLRewardSoundSound = False
        self.RLUseEnvReward = False
        self.episodeImgSaveDir = os.path.join("data", "episodeRecord", "tempImgs")
        self.episodeImgSaveInterval = -1
        self.episodeImgSize = (224, 224, 3)
        # ppo algorithm settings
        self.ppoClipParam = 0.2
        self.ppoEpoch = 4
        self.ppoNumMiniBatch = 2 if not self.render else 1
        self.ppoValueLossCoef = 0.5
        self.ppoEntropyCoef = 0.01
        self.ppoUseGAE = True
        self.ppoGAELambda = 0.95
        self.ppoNumSteps = self.RLEnvMaxSteps
        # test RL policy
        self.success_threshold = 1
        self.RLDeterministic = True
        self.skillInfos = [
            {"path": os.path.join("data", "RL_model", "default", "00000"),
             "actionDim": 2}
        ]

        # --- Sound command and env settings ---
        self.robotType = "kuka"
        self.objSet = 0
        self.commandType = "order"
        self.commonMediaPath = os.path.join("commonMedia")

        self.soundSourcePreset = "normal"
        self._apply_sound_preset()
        self.ifReset = True

        # --- backend settings (same names as var_tpu's) ---
        self.meshShape = None  # e.g. {'dp': 8}; None = single device
        self.computeDtype = "float32"  # or "bfloat16": bf16 conv stacks
        # 'fft' (torch.fft.rfft) | 'gemm' (conv1d DFT) | 'pallas' (gemm
        # power spectrum + the hand-written CUDA mel-log-DCT kernel)
        self.audioBackend = "fft"
        self.simBackend = "builtin"  # 'builtin' numpy sim | 'pybullet' adapter
        self.vecEnvBackend = "auto"  # 'auto'|'dummy'|'shmem'
        self.vecEnvContext = "forkserver"  # mp start method for shmem workers
        # fuse VAR reward + policy act into one device call per env step
        self.fusedRollout = True
        # one-step-stale pipelined rollout: overlaps sim stepping with the
        # device step + readback (train/rl.py); off = exact reference timing
        self.RLPipelinedRollout = False
        # run the simulator on the device (RL slice)
        self.RLDeviceSimRollout = False
        # testRL on the device-resident sim (RL slice)
        self.RLDeviceSimEval = False

        self.cfg_check()

    def _apply_sound_preset(self):
        """Expand soundSourcePreset into soundSource/sound_dim/taskNum
        (reference: .../fourInARow/config.py:120-139); re-run by
        _recompute_derived when the preset is overridden."""
        d = self.__dict__  # bypass reassign warnings: these ARE derived
        if self.soundSourcePreset == "mix":
            d["sound_dim"] = (1, 100, 40)
            d["soundSource"] = {
                "dataset": ["GoogleCommand", "UrbanSound"],
                "items": {
                    "GoogleCommand": ["house", "tree", "bird", "dog"],
                    "UrbanSound": ["jackhammer", None, None, "dog_bark"],
                },
                "size": {"GoogleCommand": [25, 50, 50, 25],
                         "UrbanSound": [25, 0, 0, 25]},
                "train_test": "test",
            }
        else:
            d["sound_dim"] = (1, 100, 40)
            d["soundSource"] = {
                "dataset": ["GoogleCommand"],
                "max_sound_dur": {"GoogleCommand": 6.0},
                "items": {"GoogleCommand": ["zero", "one", "two", "three"]},
                "size": {"GoogleCommand": [1000] * 4},
                "train_test": "train",
            }
        d["taskNum"] = len(
            self.soundSource["items"][self.soundSource["dataset"][0]])

    def _recompute_derived(self, explicit):
        """Keep coupled knobs in sync after override() (see base.py)."""
        d = self.__dict__
        if ("pretextModelFineTune" in explicit
                and "pretextDataset" not in explicit):
            d["pretextDataset"] = ("VARFineTuneDataset"
                                   if self.pretextModelFineTune
                                   else "VARDataset")
        if "RLEnvMaxSteps" in explicit and "ppoNumSteps" not in explicit:
            d["ppoNumSteps"] = self.RLEnvMaxSteps
        if "soundSourcePreset" in explicit and "soundSource" not in explicit:
            self._apply_sound_preset()

    def get_env_config(self, env_config_cls=None):
        cls = env_config_cls if env_config_cls is not None else KukaEnvConfig
        super().get_env_config(cls)


class KukaEnvConfig:
    """Kuka fourInARow environment constants
    (reference: Envs/pybullet/arms/tasks/fourInARow/kuka/env_config.py:4-88)."""

    def __init__(self, x):
        x.objList = ["key", "key", "key", "key"]
        x.taskNum = len(x.objList)
        x.hideObj = {"mode": "none", "hideNum": 1, "hideIdx": [2]}
        x.objInterval = 0.1
        x.objXRand = [0.05, -0.05]
        x.objYRand = [0.05, -0.45]
        x.objsXRand = [0, 0]
        x.objsYRand = [0, 0]
        x.objZ = {"key": -0.085}
        x.tablePosition = [0.5, 0.0, -0.75]
        x.xMax = 0.75
        x.xMin = 0.45
        x.yMax = 0.35
        x.yMin = -0.25
        x.img_dim = (3, 96, 96)

        x.frameSkip = 16
        x.rayHitColor = [1, 0, 0]
        x.rayMissColor = [0, 1, 0]

        x.robotName = "base_link"
        x.robotStateDim = 2
        x.continuousControl = True
        x.robotPosition = [-0.1, 0.0, 0.07]
        x.eeXInitRand = [0.05, -0.05]
        x.eeYInitRand = [0.05, -0.05]
        x.robotScale = 1
        x.endEffectorHeight = 0.22
        x.RLRobotControl = "position"
        x.pretextRobotControl = "position"

        x.selfCollision = True
        x.endEffectorIndex = 6
        x.positionControlMaxForce = 500
        x.positionControlPositionGain = 0.03
        x.positionControlVelGain = 1.0
        x.fingerAForce = 2
        x.fingerBForce = 2
        x.fingerTipForce = 2

        x.ik_useNullSpace = True
        x.ik_useOrientation = True
        x.ik_ll = [-0.967, -2, -2.96, 0.19, -2.96, -2.09, -3.05]
        x.ik_ul = [0.967, 2, 2.96, 2.29, 2.96, 2.09, 3.05]
        x.ik_jr = [5.8, 4, 5.8, 4, 5.8, 4, 6]
        x.ik_rp = [0, 0, 0, 0.5 * np.pi, 0, -np.pi * 0.5 * 0.66, 0]
        x.ik_jd = [0.1] * 7

        x.robotCamOffset = 0
        x.robotCamRenderSize = (75, 100, 3)
        x.robotFov = 48.8
        x.externalCamEyePosition = [1.2, 0, 0.3]
        x.externalCamTargetPosition = [0.6, 0, 0]
        x.debugCam_dist = 1.0
        x.debugCam_yaw = 90
        x.debugCam_pitch = -30

        x.mediaPath = os.path.join("Envs", "pybullet", "arms", "media")
        x.envFolder = os.path.join("pybullet", "arms")

        x.RLActionDim = (2,)
        x.pretextActionDim = (2,)
