"""CSV progress logging (copy of var_tpu/utils/logging.py; reference:
RL.py:230-243, VAR/pretext_VAR.py:88-91)."""
from __future__ import annotations

import os
from typing import Dict


class CSVLogger:
    """Append-mode CSV with the reference's header-once behavior, plus
    header reconciliation: appended rows align to the existing file's
    columns (missing values empty), and new keys rewrite the file with a
    widened header instead of silently misaligning columns."""

    def __init__(self, path: str):
        self.path = path
        self._keys = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _load_keys(self):
        if self._keys is not None:
            return
        if os.path.exists(self.path):
            with open(self.path) as f:
                header = f.readline().strip()
            self._keys = header.split(",") if header else []
        else:
            self._keys = []

    def log(self, row: Dict):
        self._load_keys()
        new_keys = [k for k in row if k not in self._keys]
        if new_keys:
            self._keys = list(self._keys) + new_keys
            old_rows = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    lines = f.read().splitlines()
                old_rows = lines[1:] if lines else []
            with open(self.path, "w") as f:
                f.write(",".join(self._keys) + "\n")
                pad = "," * len(new_keys)
                for r in old_rows:
                    f.write(r + pad + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")
