"""Phase timing and a host-memory watchdog (copy of
var_tpu/utils/profiling.py without its jax.profiler trace; the port traces
with torch.profiler where it needs a trace, as chip_smoke.py does).

PhaseTimer's times are host wall-clock: a phase that launches CUDA work
measures the device too only where it ends in a synchronising read, as the
fused step's packed readback and the PPO update's metrics read do.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict, deque
from typing import Dict, Iterator


class PhaseTimer:
    """Wall-clock per named phase ('env_step', 'fused_step', 'ppo_update',
    ...), with a bounded window of recent samples per phase so p50_ms is
    a true median that one first-call outlier cannot pollute."""

    WINDOW = 512  # recent samples kept per phase

    def __init__(self):
        self.samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.WINDOW))

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def p50_ms(self, name: str) -> float:
        window = self.samples.get(name)
        if not window:
            return 0.0
        ordered = sorted(window)
        return 1e3 * ordered[len(ordered) // 2]


def host_rss_gb() -> float:
    """Current process resident set size in GiB (0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:  # pragma: no cover - non-procfs platforms
        pass
    return 0.0


class RSSWatchdog:
    """Warns once when host RSS passes `frac` of physical memory, so a
    long run that leaks host memory can be checkpoint-resumed before it
    is killed."""

    def __init__(self, frac: float = 0.8):
        self.limit_gb = 0.0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal"):
                        self.limit_gb = (int(line.split()[1]) / 1024 / 1024
                                         * frac)
                        break
        except OSError:  # pragma: no cover
            pass
        self._warned = False

    def check(self) -> float:
        rss = host_rss_gb()
        if self.limit_gb and rss > self.limit_gb and not self._warned:
            self._warned = True
            warnings.warn(
                f"host RSS {rss:.1f} GiB exceeds {self.limit_gb:.0f} GiB "
                "(80% of RAM); checkpoint-resume the run")
        return rss
