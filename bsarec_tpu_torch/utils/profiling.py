"""Throughput and trace annotations (counterpart of
`bsarec_tpu/utils/profiling.py`).

- `annotate(name)` names a region in a `torch.profiler` trace;
- `Throughput` accumulates steady-state examples/s and skips the first
  observation, which carries one-time start-up costs (on the card: the
  kernels' build and CUDA's lazy initialisation).

`trace(dir)` behind `--profile` is not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import time

import torch


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
