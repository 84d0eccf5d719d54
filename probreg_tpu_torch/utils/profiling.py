"""Tracing and timing (counterpart of probreg_tpu/utils/profiling.py):

* :func:`trace`: a ``torch.profiler`` profile of the block (CPU, and the
  CUDA device when there is one), written to ``logdir`` for TensorBoard;
* :class:`IterationTimer`: a registration callback that records the wall
  time of every EM iteration;
* :func:`time_fn`: the median time of a call, each timing ended by
  ``torch.cuda.synchronize()`` once CUDA is in use, since CUDA launches
  return before the device finishes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block to ``logdir``; yields the
    ``torch.profiler.profile`` (its ``key_averages()`` sum by kernel)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class IterationTimer:
    """Registration callback recording the wall time of each EM iteration.

    Usage::

        timer = IterationTimer()
        cpd.registration_cpd(src, tgt, callbacks=[timer], device="cuda")
        print(timer.laps)
    """

    def __init__(self):
        self.laps: List[float] = []
        self._last = time.perf_counter()

    def __call__(self, _transformation) -> None:
        now = time.perf_counter()
        self.laps.append(now - self._last)
        self._last = now

    @property
    def total(self) -> float:
        return sum(self.laps)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, n_warmup: int = 1, n_iter: int = 10,
            **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)`` after
    ``n_warmup`` calls (the kernels' build, caches)."""
    for _ in range(n_warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(n_iter):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
