"""Runtime observability: event counters + EWMA stage timings.

A copy of lsd_slam_tpu/utils/stats.py whose device barrier is
`torch.cuda.synchronize`.

== RunningStats (settings.h:259-352) and the per-stage EWMA ms/Hz tracking
sprinkled through SlamSystem/DepthMap (SURVEY.md section 5.1). Counters are
plain ints fed from the sweeps' stats dicts; timers wrap host-side
dispatch+block windows.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class RunningStats:
    """Event counters, merged from device stats dicts per iteration."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)

    def add(self, prefix: str, stats: dict):
        for k, v in stats.items():
            self.counters[f"{prefix}_{k}"] += float(v)

    def bump(self, key: str, n: float = 1):
        self.counters[key] += n

    def high_water(self, key: str, value: float):
        """Keep the maximum seen (queue depths, batch sizes)."""
        if value > self.counters[key]:
            self.counters[key] = value

    def snapshot(self) -> Dict[str, float]:
        return dict(self.counters)

    def reset(self):
        self.counters.clear()

    def format(self, prefix: str = "") -> str:
        items = sorted(k for k in self.counters if k.startswith(prefix))
        return "; ".join(f"{k}={self.counters[k]:.0f}" for k in items)


def device_sync():
    """Barrier for profiling: wait until the CUDA device drained, so
    wall-clock around a stage measures device time, not dispatch time
    (a no-op without CUDA)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimers:
    """Per-stage wall-clock statistics (SlamSystem.h:115-118,
    DepthMap.h:87-93: EWMA ms = 0.9*ms + 0.1*dt).

    The FIRST sample of each stage is recorded separately
    (`first_ms`) and excluded from the EWMA / median / max: in the
    engine the first call of a stage includes kernel builds and library
    initialisation, and folding
    it into the EWMA makes the published per-stage cost ~the compile time
    for rarely-called stages (keyframe switches run a handful of times per
    sequence). `ms` (EWMA), `median()` and `max_ms` are therefore
    steady-state numbers; `first_ms` is the warmup cost.

    By default the timers measure host dispatch windows (cheap, async-
    friendly — like the reference's gettimeofday pairs). With a `sync`
    callable (profiling mode, SystemConfig.profile_sync) every stage exit
    blocks until the device drained, so the numbers are true per-stage
    device cost (SURVEY section 5.1)."""

    def __init__(self, alpha: float = 0.9, sync=None):
        self.alpha = alpha
        self.sync = sync
        self.ms: Dict[str, float] = defaultdict(float)
        self.n: Dict[str, int] = defaultdict(int)
        self.first_ms: Dict[str, float] = {}
        self.max_ms: Dict[str, float] = defaultdict(float)
        self.samples: Dict[str, list] = defaultdict(list)

    def record(self, stage: str, dt_ms: float):
        n = self.n[stage]
        if n == 0:
            self.first_ms[stage] = dt_ms
        else:
            if n == 1:
                self.ms[stage] = dt_ms
            else:
                self.ms[stage] = self.alpha * self.ms[stage] \
                    + (1 - self.alpha) * dt_ms
            self.max_ms[stage] = max(self.max_ms[stage], dt_ms)
            self.samples[stage].append(dt_ms)
        self.n[stage] = n + 1

    @contextmanager
    def time(self, stage: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.record(stage, (time.perf_counter() - t0) * 1000.0)

    def median(self, stage: str) -> float:
        s = sorted(self.samples.get(stage, ()))
        return s[len(s) // 2] if s else 0.0

    def summary(self) -> str:
        """One line like the reference's 1-Hz timing printout
        (SlamSystem.cpp:639-649)."""
        return ", ".join(
            f"{k}: {self.ms[k]:.1f}ms (med {self.median(k):.1f}, "
            f"max {self.max_ms[k]:.1f}, first {self.first_ms.get(k, 0):.0f}, "
            f"{self.n[k]}x)"
            for k in sorted(self.ms))
