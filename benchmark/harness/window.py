"""What one measured window left behind, in the form the metrics read:
the stream (its frames, counters and timers), the window's bounds on the
host's perf_counter_ns, and, in a traced run, the device operations and
the host's kernel launches on that clock."""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np

from benchmark.harness import stats


class Run:
    def __init__(self, cell, stream, t0_ns: int, t_end_ns: int,
                 image_size, names: Optional[List[str]] = None,
                 events: Optional[np.ndarray] = None,
                 launches: Optional[np.ndarray] = None):
        self.cell = cell
        self.stream = stream
        self.t0, self.t_end = t0_ns, t_end_ns
        self.seconds = (t_end_ns - t0_ns) / 1e9
        self.width, self.height = image_size
        self.names = names
        self.events = None
        if events is not None:
            keep = (events[:, 2] > t0_ns) & (events[:, 1] < t_end_ns)
            ev = events[keep].copy()
            ev[:, 1] = np.maximum(ev[:, 1], t0_ns)
            ev[:, 2] = np.minimum(ev[:, 2], t_end_ns)
            self.events = ev
        self.launches = launches

    # ---------------------------------------------------------- frames
    def window_frames(self):
        """Every frame completed inside the window."""
        return self.stream.in_window(self.t_end)

    def frames_called(self) -> int:
        return len(self.stream.frames)

    def counter(self, key: str) -> float:
        return self.stream.counter(key)

    # ---------------------------------------------------------- device
    @property
    def traced(self) -> bool:
        return self.events is not None

    def busy_intervals(self):
        if not self.traced:
            return []
        return stats.union(((int(s), int(e)) for _, s, e, _ in self.events),
                           self.t0, self.t_end)

    def busy_s(self) -> Optional[float]:
        if not self.traced:
            return None
        return stats.covered(self.busy_intervals()) / 1e9

    def kernel(self, fragment: str):
        """(launches, device seconds) of the kernels whose name holds
        `fragment`."""
        if not self.traced:
            return 0, 0.0
        ids = [k for k, n in enumerate(self.names) if fragment in n]
        sel = np.isin(self.events[:, 0], ids)
        return int(sel.sum()), float(
            (self.events[sel, 2] - self.events[sel, 1]).sum() / 1e9)

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, s], ...]."""
        if not self.traced:
            return []
        dur = np.bincount(self.events[:, 0],
                          weights=self.events[:, 2] - self.events[:, 1],
                          minlength=len(self.names))
        order = np.argsort(-dur)[:top]
        return [[self.names[k], float(dur[k] / 1e9)] for k in order
                if dur[k] > 0]

    def launched_in(self, spans):
        """For each host span (start, end): the device seconds covered by
        the operations launched inside it (the union of their intervals);
        None where the trace holds no launches."""
        if not self.traced or self.launches is None \
                or not len(self.launches):
            return None
        row_of = {c: k for k, c in enumerate(self.events[:, 3].tolist())}
        times = self.launches[:, 0]
        out = []
        for a, b in spans:
            lo, hi = np.searchsorted(times, [a, b])
            rows = [row_of[c] for c in self.launches[lo:hi, 1].tolist()
                    if c in row_of]
            merged = stats.union(((int(self.events[k, 1]),
                                   int(self.events[k, 2])) for k in rows),
                                 -np.inf, np.inf)
            out.append(stats.covered(merged) / 1e9)
        return out

    def host_state(self, t_ns: int) -> str:
        """What the host was doing at t: inside a switch frame's call, an
        ordinary frame's call, or outside the program."""
        frames = self.stream.frames
        starts = [f.t_start for f in frames]
        j = bisect.bisect_right(starts, t_ns) - 1
        if j >= 0 and frames[j].t_end >= t_ns:
            return "switch frame" if frames[j].switched else "frame"
        return "outside"

    def idle_gaps(self, top: int = 10):
        """The longest idle gaps of the card: [[host state, s], ...]."""
        if not self.traced:
            return []
        g = stats.gaps(self.busy_intervals(), self.t0, self.t_end)
        g.sort(key=lambda ab: ab[0] - ab[1])
        return [[self.host_state((a + b) // 2), (b - a) / 1e9]
                for a, b in g[:top]]
