"""Configuration base machinery (copy of var_tpu/config/base.py).

A config object with colored printing, a warning on attribute reassignment
(catching config typos), cfg_check() validation of mutually exclusive flags
and override() for CLI knobs. Model and dataset choices are string keys
resolved through registries.
"""
from __future__ import annotations

import json


class printColor:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


class ConfigBase:
    """Attribute-namespace config with reassignment warnings and validation."""

    _warn_reassign = True

    def print(self, txt: str, color: str = printColor.OKBLUE):
        print(color + txt + printColor.ENDC)

    def get_env_config(self, env_config_cls):
        """Splice an EnvConfig into this config."""
        env_config_cls(self)

    def __setattr__(self, name, value):
        # 'taskNum' is legitimately recomputed when the env config is spliced
        # in; 'pretext_RL' when an entry point declares its role.
        if (self._warn_reassign and name in self.__dict__
                and name not in ("taskNum", "pretext_RL")):
            self.print(
                f"Reassignment of {name} to {value}", printColor.WARNING
            )
        self.__dict__[name] = value

    def override(self, **kwargs):
        """Silently override knobs (for programmatic/CLI configuration).

        Knobs derived from other knobs at __init__ time (pretextDataset
        from pretextModelFineTune, ppoNumSteps from RLEnvMaxSteps, the
        soundSource preset expansion) are recomputed afterwards unless
        the caller overrode them explicitly."""
        for k, v in kwargs.items():
            if k not in self.__dict__:
                raise AttributeError(f"Unknown config knob {k!r}")
            self.__dict__[k] = v
        hook = getattr(self, "_recompute_derived", None)
        if hook is not None:
            hook(set(kwargs))
        return self

    def cfg_check(self):
        """Validate flag combinations."""
        if getattr(self, "RLTrain", False) and getattr(self, "RLManualControl", False):
            raise ValueError("RLTrain and RLManualControl cannot both be True")
        interval = getattr(self, "episodeImgSaveInterval", -1)
        if 0 < interval < 5:
            self.print(
                "You may save the episode image too frequently", printColor.WARNING
            )
        self.print("Configuration Check Passed!", printColor.OKGREEN)

    def to_dict(self) -> dict:
        """JSON-serializable snapshot, saved beside checkpoints."""
        out = {}
        for k, v in self.__dict__.items():
            try:
                json.dumps(v)
                out[k] = v
            except TypeError:
                out[k] = repr(v)
        return out

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=repr)
