"""Profiling hooks, as ``autovc_tpu/train/profiler.py``.

- ``trace(log_dir)``: a ``torch.profiler`` window (host and, with a card,
  device activity) written as a Chrome/Perfetto trace into ``log_dir``.
- ``StepTimer``: steady-state step timing that skips the first steps, with a
  percentile summary. Its ticks are host times: they measure the device
  only where the loop waits for it (the Solver's loss fetch at each
  ``log_step``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip_first:
                self._times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps_per_sec": float(1.0 / arr.mean()),
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p95": float(np.percentile(arr, 95) * 1e3),
        }
