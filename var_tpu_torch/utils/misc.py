"""Small utilities (port of var_tpu/utils/misc.py; the reference's
utils.py:9-54)."""
from __future__ import annotations

import functools
import glob
import os
import pickle


def rgetattr(obj, attr: str, *default):
    """Recursive getattr through dots (reference: utils.py rgetattr)."""

    def _get(o, name):
        return getattr(o, name, *default) if default else getattr(o, name)

    return functools.reduce(_get, attr.split("."), obj)


def confirm_from_user(prompt: str, assume_yes: bool = False) -> bool:
    """y/n confirmation (reference: utils.py confirm_from_user); headless
    callers pass assume_yes."""
    if assume_yes or os.environ.get("VAR_TPU_ASSUME_YES"):
        return True
    while True:
        ans = input(f"{prompt} [y/n] ").strip().lower()
        if ans in ("y", "yes"):
            return True
        if ans in ("n", "no"):
            return False


def convert_pickle_protocol(path_glob: str, protocol: int = 2):
    """Re-pickle shards at a given protocol for cross-version portability
    (reference: utils.py convert_pickle_protocol)."""
    for path in glob.glob(path_glob):
        with open(path, "rb") as f:
            data = pickle.load(f)
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=protocol)
