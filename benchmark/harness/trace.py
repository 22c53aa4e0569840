"""The device trace of a `--trace 1` run: torch.profiler over the window,
the card's activity only, read from the raw kineto events (building the
profiler's event tree for a window of a million device operations would
take longer than the window).

The profiler's clock is put on the host's `perf_counter_ns` by marker
kernels (`torch.cuda._sleep`, kernel `spin_kernel`), each launched on an
idle card right after reading the host clock: three before the window
and three after it, 3 and 7 ms apart, so that the markers found in the
trace are matched to their host times even where the profiler missed
one (its first kernels after start can go unrecorded). The host's kernel
launches (CUDA runtime events) come with the trace, on the same clock to
within a launch's latency; their correlation ids name the device
operations that each launched, so a harness span on the host names its
kernels.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Sequence

import numpy as np

MARKER = "spin_kernel"
GAPS_S = (0.003, 0.007)       # host sleeps between a group's markers


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.groups: List[List[int]] = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.groups.append(self._group())

    def _group(self) -> List[int]:
        marks = [self._mark()]
        for gap in GAPS_S:
            time.sleep(gap)
            marks.append(self._mark())
        return marks

    def _mark(self) -> int:
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        torch.cuda._sleep(2000)
        torch.cuda.synchronize()
        return t

    def stop(self):
        """(kernel names, (N, 4) int64 rows of name index, start, end,
        correlation id of the device operations, (M, 2) int64 rows of
        start, correlation id of the host's kernel launches), times on the
        host's perf_counter_ns, the markers left out."""
        from torch.autograd import DeviceType
        self.groups.append(self._group())
        self.prof.stop()
        names, index, rows, marks, launches = [], {}, [], [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != DeviceType.CUDA:
                if "LaunchKernel" in name:
                    launches.append((e.start_ns(), e.correlation_id()))
                continue
            start = e.start_ns()
            if MARKER in name:
                marks.append(start)
                continue
            k = index.get(name)
            if k is None:
                k = index[name] = len(names)
                names.append(name)
            rows.append((k, start, start + e.duration_ns(),
                         e.correlation_id()))
        offset = marker_offset(marks, self.groups)
        ev = np.asarray(rows, np.int64).reshape(-1, 4)
        ev[:, 1:3] -= offset
        la = np.asarray(launches, np.int64).reshape(-1, 2)
        la[:, 0] -= offset
        self.prof = None
        return names, ev, la[np.argsort(la[:, 0], kind="stable")]


def marker_offset(found: Sequence[int], groups: Sequence[Sequence[int]]
                  ) -> int:
    """The profiler's clock less the host's, from the marker kernels found
    in the trace and each group's host times: the found markers are split
    into groups by the time between them, each group's markers matched,
    in order, to host times so that all offsets agree best, and the
    offsets averaged."""
    found = sorted(int(x) for x in found)
    split = max(GAPS_S) * 1e9 * 20
    parts: List[List[int]] = []
    for x in found:
        if parts and x - parts[-1][-1] < split:
            parts[-1].append(x)
        else:
            parts.append([x])
    if len(parts) != len(groups):
        raise RuntimeError(f"found {len(found)} marker kernels ({MARKER}) "
                           f"in {len(parts)} groups, expected "
                           f"{len(groups)} groups")
    options = []
    for got, host in zip(parts, groups):
        if len(got) > len(host):
            raise RuntimeError(f"{len(got)} markers for {len(host)} "
                               f"host marks")
        options.append([[g - host[k] for g, k in zip(got, idx)]
                        for idx in itertools.combinations(range(len(host)),
                                                          len(got))])
    best = min(itertools.product(*options),
               key=lambda pick: np.ptp(np.concatenate(pick)))
    return int(np.mean(np.concatenate(best)))
