"""AI2-THOR (iTHOR living-room navigation) configuration profile.

A copy of var_tpu/config/ai2thor.py: the same knob names, defaults and
semantics, so that a config file or a --set line means the same in both
packages. `simBackend='builtin'` selects the port's grid sims
(var_tpu_torch/envs/grid_sim.py on the host, grid_sim_device.py on the
device); `simBackend='ithor'` the adapter onto the real iTHOR scenes
(var_tpu_torch/envs/adapters/ithor.py, which needs the ai2thor package).
"""
import os
from collections import OrderedDict

from .base import ConfigBase


class AI2ThorConfig(ConfigBase):
    def __init__(self):
        self.name = self.__class__.__name__
        self.pretext_RL = "pretext"

        # --- Visualization ---
        self.render = False
        self.use3rdCam = False
        self.renderUnity = True
        self.realTimeVec = False

        # --- VAR (pretext) settings ---
        self.pretextTrain = True
        self.pretextCollection = True
        self.pretextManualControl = False
        self.pretextManualCollect = False
        self.pretextCollectNum = [100, 100, 100, 100, 100]
        self.pretextDataHasSound = False
        self.pretextModelFineTune = False
        self.pretextDataDir = [
            os.path.join("data", "pretext_training", "default_finetune")
        ]
        self.pretextDataFileLoadNum = ["all"]
        self.pretextDataset = (
            "VARFineTuneDataset" if self.pretextModelFineTune else "VARDataset"
        )
        self.pretextModel = "ai2thor_VARPretextNet"
        self.pretextModelSaveDir = os.path.join("data", "pretext_model", "default")
        self.pretextModelLoadDir = os.path.join("data", "pretext_model", "default", "39")
        self.pretextModelSaveInterval = 10
        self.pretextDataNumWorkers = 8
        self.pretextDataEpisode = 200
        self.pretextDataNumFiles = 20
        self.pretextTrainBatchSize = 128
        self.pretextTestBatchSize = 128
        self.pretextLR = 1e-4
        self.pretextAdamL2 = 1e-6
        self.pretextLRStep = "step"
        self.pretextEpoch = 40
        self.pretextLRDecayEpoch = [20, 30]
        self.pretextLRDecayGamma = 0.2
        self.representationDim = 3
        self.tripletMargin = 1.0
        self.pretextTestMethod = "plot"
        self.plotRepresentation = 50
        self.plotNumBatch = 7
        self.annotateLastBatch = False
        self.plotRepresentationExtra = False
        self.plotExtraPath = os.path.join("data", "episodeRecord", "extra")
        # pretext env configuration
        self.pretextEnvName = "ai2thor-pretext-v2"
        self.pretextEnvMaxSteps = 15
        self.pretextEnvSeed = 977
        self.pretextNumEnvs = 4 if not self.render else 1
        self.pretextVisibilityDistance = 100.0

        # --- RL settings ---
        self.RLTrain = True
        self.RLManualControl = False
        self.RLManualControlLoaded = False
        if self.realTimeVec:
            self.RLManualControlLoaded = True
        self.RLModelFineTune = False
        self.RLLogDir = os.path.join("data", "RL_model", "ai2thor")
        self.RLPolicyBase = "ai2thor_VAR"
        self.RLGamma = 0.99
        self.RLRecurrentPolicy = True
        self.RLLr = 6e-5
        self.RLEps = 1e-5
        # PPO LR schedule — None keeps the reference's constant-LR Adam
        # (reference: RL.py:115); see config/arm.py for semantics.
        self.RLLrDecay = None
        self.RLLrDecayStart = 0.33
        self.RLLrFinalFactor = 0.1
        self.RLMaxGradNorm = 0.5
        self.RLTotalSteps = 1e6
        self.RLModelSaveInterval = 200
        self.RLLogInterval = 100
        self.RLModelSaveDir = os.path.join("data", "RL_model", "default")
        self.RLModelLoadDir = os.path.join("data", "RL_model", "default", "00000")
        self.RLUseProperTimeLimits = False
        self.RLRecurrentSize = 1024
        self.RLRecurrentInputSize = 128
        self.RLActionHiddenSize = 128
        # RL env configuration
        self.RLEnvMaxSteps = 50
        self.RLRewardSoundSound = False
        self.RLEnvName = "ai2thor-RL-v2"
        self.RLEnvSeed = 349
        self.RLNumEnvs = 8 if not self.render else 1
        self.RLVisibilityDistance = 1.5
        self.RLVisibleGrid = 9
        self.RLObsIgnore = {"current_sound", "goal_sound", "goal_sound_label"}
        self.episodeImgSaveDir = os.path.join("data", "episodeRecord", "tempImgs")
        self.episodeImgSaveInterval = -1
        self.episodeImgSize = (96 * 5, 96 * 5, 3)
        # ppo algorithm settings
        self.ppoClipParam = 0.2
        self.ppoEpoch = 4
        self.ppoNumMiniBatch = 2
        self.ppoValueLossCoef = 0.5
        self.ppoEntropyCoef = 0.01
        self.ppoUseGAE = True
        self.ppoGAELambda = 0.95
        self.ppoNumSteps = self.RLEnvMaxSteps
        # test RL policy
        self.success_threshold = 1
        self.RLDeterministic = True
        # eval episodes per task class (round-robin; the reference iterates
        # the whole FSC test split, VAR/RL_VAR.py:35 size_per_class)
        self.testEpisodesPerClass = 10
        self.skillInfos = [
            {"path": os.path.join("data", "RL_model", "default", "00000"),
             "actionDim": 8, "actionOffset": 0}
        ]

        # --- Sound command and env settings ---
        self.sound_dim = (1, 600, 40)
        self.commonMediaPath = os.path.join("commonMedia")
        self.soundSource = {
            "dataset": "FSC",
            "train_test": "train",
            "FSC_max_sound_dur": 6.0,
            "size": 1000,
            "FSC_obj_act": {
                "lights": ["activate", "deactivate"],
                "music": ["activate", "deactivate"],
                "lamp": ["activate", "deactivate"],
            },
            "FSC_locations": ["none"],
        }
        self.soundSource["FSC_csv"] = self.soundSource["train_test"] + "_data.csv"

        self.trainingRoom = list(range(201, 221))
        self.testingRoom = [226, 227, 228, 229, 230]
        self.allScene = {"livingRoom": self.trainingRoom}

        # --- backend settings (same names as var_tpu's) ---
        self.meshShape = None
        self.computeDtype = "float32"  # or "bfloat16": bf16 conv stacks
        # 'fft' | 'gemm' | 'pallas' (the CUDA mel-log-DCT kernel), as arm.py
        self.audioBackend = "fft"
        self.simBackend = "builtin"  # 'builtin' gridworld sim | 'ithor' adapter
        self.vecEnvBackend = "auto"
        self.vecEnvContext = "forkserver"  # mp start method for shmem workers
        self.fusedRollout = True
        # one-step-stale pipelined rollout: overlaps sim stepping with the
        # device step + readback (train/rl.py); off = exact reference timing
        self.RLPipelinedRollout = False
        # run the simulator on the device (envs/grid_sim_device.py,
        # rl/device_sim.py::GridDeviceSimEngine)
        self.RLDeviceSimRollout = False
        # testRL on the device-resident sim; writes test_<ckpt>_devicesim.csv
        self.RLDeviceSimEval = False

        self.cfg_check()

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

    def get_env_config(self, env_config_cls=None):
        cls = env_config_cls if env_config_cls is not None else AI2ThorEnvConfig
        super().get_env_config(cls)


class AI2ThorEnvConfig:
    """iTHOR environment constants
    (reference: Envs/ai2thor/env_config.py:4-55)."""

    def __init__(self, x):
        x.envFolder = "ai2thor"
        x.img_dim = (3, 96, 96)
        x.keyBoardMapping = OrderedDict(
            [
                ("w", "MoveAhead"), ("s", "MoveBack"),
                ("a", "MoveLeft"), ("d", "MoveRight"),
                ("q", "RotateLeft"), ("e", "RotateRight"),
                ("T", "ToggleObjectOn"), ("t", "ToggleObjectOff"),
            ]
        )
        x.allActions = list(x.keyBoardMapping.values())
        x.allTasks = OrderedDict(
            [
                (
                    "livingRoom",
                    OrderedDict(
                        [
                            ("FloorLamp", ["ToggleObjectOn", "ToggleObjectOff"]),
                            ("Television", ["ToggleObjectOn", "ToggleObjectOff"]),
                        ]
                    ),
                )
            ]
        )
        x.RLActionDim = (len(x.allActions),)

        x.taskNum = 0
        for loc in x.allTasks:
            for obj in x.allTasks[loc]:
                x.taskNum = x.taskNum + len(x.allTasks[loc][obj])

        x.gridSize = {k: 0.25 for k in list(range(201, 221)) + [226, 227, 228, 229]}
        x.gridSize[230] = 0.5
        x.snapToGrid = False
        x.rotateStepDegrees = 45
        x.fieldOfView = 90

        # ai2thor vocabulary -> FSC vocabulary
        x.synonym = {
            "livingRoom": ["none"],
            "FloorLamp": ["lights", "lamp"],
            "Television": ["music"],
            "ToggleObjectOn": ["increase", "activate"],
            "ToggleObjectOff": ["decrease", "deactivate"],
        }

        x.domainRandomization = ["randomInitialPose", "randomObjState"]
