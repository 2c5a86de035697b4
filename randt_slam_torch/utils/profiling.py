"""Structured stage timing and ``torch.profiler`` capture (port of
``randt_slam_tpu/utils/profiling.py``).

The reference times its stages with ad-hoc ``TicToc`` stopwatches and
accumulating counters.  Here: named wall-clock stages, synchronised with the
device when given a CUDA tensor, an accumulating registry, and an optional
device trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Accumulating stage timer (the structured ``TicToc`` / ``total_time_``
    replacement, cf. ``tictoc.h`` and ``local_fuser.h:164-165``)."""

    def __init__(self, sync: bool = True):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        """Time the block; with ``sync`` on and a CUDA tensor as
        ``sync_value``, the stage ends when the device has finished."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if (self.sync and isinstance(sync_value, torch.Tensor)
                    and sync_value.is_cuda):
                torch.cuda.synchronize(sync_value.device)
            self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> dict:
        return {
            k: {
                "count": v.count,
                "total_s": round(v.total_s, 6),
                "mean_s": round(v.mean_s, 6),
                "min_s": round(v.min_s, 6),
                "max_s": round(v.max_s, 6),
            }
            for k, v in sorted(self.stages.items())
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (host ranges, and the
    device's kernels when CUDA is present) into ``logdir/trace.json``, a
    Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
