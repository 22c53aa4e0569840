"""The program's own spans in a measured window, for the metrics that read
them.

The port's engine records spans (`lsd_slam_tpu_torch.utils.stats`
`StageTimers.spans`) while a torch.profiler records on its tracking
thread (`SlamSystem.track_frame`): in a `--trace 1` run, from the
window's first frame. Each span carries its
name, its start and end on `time.perf_counter_ns` (the clock
`harness/trace.py` puts the device trace on), the frame id of its
`track_frame` call and the span open around it. A program without the
recorder, or a run without a device trace, leaves nothing to read: every
reader here then returns None.

Span names of the sequential engine (`pipeline_lag` 0): a root
`track_frame` per call; an ordinary frame's `frame_step` (`pyramid`,
`track`, `observe`) and `retire` (`pull.pack`); a switch frame's
`switch_pyramid`, `switch_track`, `retire` and `switch` (its keyframe
work, the back end's `constraints`, `pgo` and `reposition_search`
inside). Every device-to-host pull is a span named `pull.*`; `gc` is a
pause of Python's collector.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def window_spans(run) -> Optional[list]:
    """The spans that lie inside the window, by start; None where the
    program recorded none."""
    timers = getattr(getattr(run.stream, "sys", None), "timers", None)
    read = getattr(timers, "spans", None)
    if read is None:
        return None
    spans = sorted(read(run.t0, run.t_end),
                   key=lambda s: (s.start_ns, s.seq))
    return spans or None


def under(spans, name: str, parent: str) -> list:
    """The spans named `name` whose enclosing span is named `parent`."""
    names = {s.seq: s.name for s in spans}
    return [s for s in spans if s.name == name
            and names.get(s.parent) == parent]


def mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def launched(run, spans) -> Optional[np.ndarray]:
    """A mask over the trace's device operations: the kernels whose launch
    (the host's runtime call, matched by correlation id) lies inside one
    of the spans. Copies and fills are never in it: the trace keeps no
    host call for them. None where the trace holds no launches."""
    if not run.traced or run.launches is None or not len(run.launches):
        return None
    times = run.launches[:, 0]
    ids = [run.launches[np.searchsorted(times, s.start_ns):
                        np.searchsorted(times, s.end_ns, side="right"), 1]
           for s in spans]
    ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    return np.isin(run.events[:, 3], ids)
