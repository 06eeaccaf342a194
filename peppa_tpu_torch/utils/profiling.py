"""Throughput accounting for the trainer's logs.

Mirrors `StepTimer` of peppa_tpu/utils/profiling.py.  It reads the host
clock only and synchronises nothing: in the trainer each step is timed
where it has been issued, and the device holds the host back where the loop
reads a loss (the finiteness check, one step late), as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional


class StepTimer:
    """Steps/s and items/s after `warmup_steps` steps (the first steps
    build kernels and pick algorithms).  The clock starts at step
    warmup_steps + 1; the window holds the steps after it, and so do the
    items counted."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._items = 0
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def step(self, items: int = 0) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._count == self.warmup_steps + 1:
            self._t0 = now
        elif self._count > self.warmup_steps + 1:
            self._items += items
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return (self._count - self.warmup_steps - 1) / (self._last - self._t0)

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return self._items / (self._last - self._t0)

    def metrics(self, prefix: str = "perf/") -> Dict[str, float]:
        return {f"{prefix}steps_per_sec": self.steps_per_sec,
                f"{prefix}items_per_sec": self.items_per_sec}


def host_rss_bytes() -> int:
    """Resident set size of this process, in bytes (0 if unreadable)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
