"""Throughput and trace annotations (counterpart of
`bsarec_tpu/utils/profiling.py`).

- `trace(dir, device)` records the enclosed region with `torch.profiler`
  (host activity, and the card's kernels when `device` is CUDA) and
  writes a Chrome/Perfetto trace into `dir`, which TensorBoard's profiler
  plugin also reads; `main --profile <dir>` wraps `Trainer.fit` in it;
- `annotate(name)` names a region in such a trace;
- `Throughput` accumulates steady-state examples/s and skips the first
  observation, which carries one-time start-up costs (on the card: the
  kernels' build and CUDA's lazy initialisation).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str | None, device: torch.device | str = "cpu"):
    """Profile the enclosed region into `log_dir` as
    `<host>_<pid>.<time>.pt.trace.json` (a no-op when `log_dir` is falsy)."""
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region for a torch.profiler timeline."""
    return torch.profiler.record_function(name)


class Throughput:
    """Steady-state examples/s; the first observation is left out."""

    def __init__(self):
        self._t0 = None
        self._samples = 0.0
        self._seconds = 0.0
        self._warm = False

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_examples: int) -> float:
        dt = time.perf_counter() - self._t0
        rate = n_examples / dt if dt > 0 else 0.0
        if self._warm:
            self._samples += n_examples
            self._seconds += dt
        self._warm = True
        return rate

    @property
    def steady_rate(self) -> float:
        return self._samples / self._seconds if self._seconds > 0 else 0.0
