"""Key-value metrics logger with the baselines logkv/dumpkvs API (port of
var_tpu/utils/kvlogger.py).

Accumulate key->value pairs, dump to any combination of human-readable
stdout, CSV, JSONL and TensorBoard event files (utils/tb_writer.py), plus
a profile_kv timing context.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 formats: List[str] = ("stdout",)):
        self.kvs: Dict[str, float] = {}
        self.counts: Dict[str, int] = defaultdict(int)
        self.formats = list(formats)
        self.log_dir = log_dir
        self._csv_keys: Optional[List[str]] = None
        self._tb = None  # lazy EventFileWriter ('tensorboard' format)
        self._tb_step = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def logkv(self, key: str, val):
        self.kvs[key] = val

    def logkv_mean(self, key: str, val):
        n = self.counts[key]
        old = self.kvs.get(key, 0.0)
        self.kvs[key] = (old * n + val) / (n + 1)
        self.counts[key] = n + 1

    def dumpkvs(self) -> Dict[str, float]:
        out = dict(self.kvs)
        if "stdout" in self.formats and out:
            width = max(len(k) for k in out)
            print("-" * (width + 24))
            for k in sorted(out):
                v = out[k]
                vs = f"{v:.5g}" if isinstance(v, float) else str(v)
                print(f"| {k.ljust(width)} | {vs.ljust(16)} |")
            print("-" * (width + 24))
        if self.log_dir:
            if "json" in self.formats:
                with open(os.path.join(self.log_dir, "progress.jsonl"), "a") as f:
                    f.write(json.dumps(out, default=float) + "\n")
            if "csv" in self.formats:
                self._dump_csv(out)
            if "tensorboard" in self.formats:
                # TF-free event-file sink (utils/tb_writer.py; replaces
                # the reference's dead TensorBoardOutputFormat,
                # Envs/vec_env/logger.py:139-172). Step = the 'nupdates'
                # key when present (the RL progress schema), else a
                # dump counter.
                if self._tb is None:
                    from var_tpu_torch.utils.tb_writer import EventFileWriter

                    self._tb = EventFileWriter(
                        os.path.join(self.log_dir, "tb"))
                step = out.get("nupdates", self._tb_step)
                try:
                    step = int(step)
                except (TypeError, ValueError):
                    step = self._tb_step
                # In a stream mixing dumps with and without 'nupdates',
                # a plain dump-counter fallback could fall BELOW the last
                # real step and write out-of-order points; keep the step
                # monotone instead.
                step = max(step, self._tb_step)
                self._tb.add_scalars(step, out)
                self._tb_step = step + 1
        self.kvs.clear()
        self.counts.clear()
        return out

    def _dump_csv(self, out: Dict[str, float]):
        """CSV with a growing column set (the vendored baselines logger's
        behavior, Envs/vec_env/logger.py:198-230): new keys REWRITE the
        file with the widened header instead of being dropped, and a
        restart against an existing file adopts its header instead of
        appending a second one."""
        path = os.path.join(self.log_dir, "progress_kv.csv")
        if self._csv_keys is None:
            if os.path.exists(path):
                with open(path) as f:
                    header = f.readline().strip()
                self._csv_keys = header.split(",") if header else []
            else:
                self._csv_keys = []
        new_keys = sorted(set(out) - set(self._csv_keys))
        if new_keys:
            self._csv_keys = list(self._csv_keys) + new_keys
            rows = []
            if os.path.exists(path):
                with open(path) as f:
                    lines = f.read().splitlines()
                rows = lines[1:] if lines else []
            with open(path, "w") as f:
                f.write(",".join(self._csv_keys) + "\n")
                pad = "," * len(new_keys)
                for r in rows:
                    f.write(r + pad + "\n")
        with open(path, "a") as f:
            f.write(",".join(str(out.get(k, "")) for k in
                             self._csv_keys) + "\n")

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.logkv_mean(f"wait_{name}", time.time() - t0)
