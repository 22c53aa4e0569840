"""Runtime observability: event counters, EWMA stage timings and spans.

A copy of lsd_slam_tpu/utils/stats.py whose device barrier is
`torch.cuda.synchronize` and whose counters take a lock (the engine's
worker threads bump them too), with a span recorder the JAX package does
not have.

== RunningStats (settings.h:259-352) and the per-stage EWMA ms/Hz tracking
sprinkled through SlamSystem/DepthMap (SURVEY.md section 5.1). Counters are
plain ints fed from the sweeps' stats dicts; timers wrap host-side
dispatch+block windows.

Spans: while tracing is on (`StageTimers.set_tracing`), every timed stage
and every `StageTimers.span(name)` site also records a `Span`: its name,
start and end on `time.perf_counter_ns` (the clock a device trace is put
on), the frame id of the `track_frame` call it ran in, the span open
around it on its thread and the thread. Closed spans go into a bounded
ring (`SPANS_MAX`), which counts what it drops; `StageTimers.spans(t0,
t1)` reads those that lie between two times. The collector's pauses are
spans named `gc`, nested under whatever was open on the collecting
thread. With tracing off a site costs one boolean test.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import weakref
from collections import defaultdict, deque
from contextlib import contextmanager
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional

# samples kept per stage: the newest this many (a 51 s window at 50
# frames/s takes ~2,600)
SAMPLES_MAX = 1 << 17
# closed spans kept while tracing (~15 a frame: ~5 minutes at 50 frames/s)
SPANS_MAX = 1 << 18

NULL_SPAN = contextlib.nullcontext()


class RunningStats:
    """Event counters, merged from device stats dicts per iteration."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def add(self, prefix: str, stats: dict):
        with self._lock:
            for k, v in stats.items():
                self.counters[f"{prefix}_{k}"] += float(v)

    def bump(self, key: str, n: float = 1):
        with self._lock:
            self.counters[key] += n

    def high_water(self, key: str, value: float):
        """Keep the maximum seen (queue depths, batch sizes)."""
        with self._lock:
            if value > self.counters[key]:
                self.counters[key] = value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

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


class Span(NamedTuple):
    """One closed span. `seq` numbers spans in the order they opened (from
    1); `parent` is the seq of the span open around this one on its thread
    (0: none); `frame_id` the id given to the `frame` span it ran in (-1:
    outside one); `thread` the thread's `threading.get_ident()`."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    frame_id: int
    parent: int
    thread: int


class SpanRing:
    """The newest `capacity` (a power of two) closed spans, as plain
    tuples in `Span` order; `closed` counts every span added, `dropped`
    those overwritten."""

    def __init__(self, capacity: int = SPANS_MAX):
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two: {capacity}")
        self.capacity = int(capacity)
        self._mask = self.capacity - 1
        self._buf: list = [None] * self.capacity
        self._next = itertools.count()
        self.closed = 0

    def add(self, row: tuple):
        k = next(self._next)          # atomic: threads may add at once
        self._buf[k & self._mask] = row
        if k >= self.closed:
            self.closed = k + 1

    @property
    def dropped(self) -> int:
        return max(0, self.closed - self.capacity)

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The kept spans that lie inside [t0, t1], by start time."""
        out = [Span._make(r) for r in self._buf
               if r is not None and r[2] >= t0_ns and r[3] <= t1_ns]
        out.sort(key=lambda s: (s.start_ns, s.seq))
        return out


class _SpanContext:
    """The context of one span name, shared by every use of the name: the
    open span's state lives on the recording thread's stack. Its enter and
    exit are `StageTimers._open` and `_close` written out, a Python call
    less each (a span costs ~1 us of host time)."""

    __slots__ = ("timers", "name")

    def __init__(self, timers: "StageTimers", name: str):
        self.timers = timers
        self.name = name

    def __enter__(self):
        t = self.timers
        try:
            stack = t._local.stack
        except AttributeError:
            stack = t._stack()
        stack.append((next(t._seq), self.name, perf_counter_ns(),
                      stack[-1][0] if stack else 0, t.frame_id))

    def __exit__(self, *exc):
        end = perf_counter_ns()
        t = self.timers
        loc = t._local
        seq, name, start, parent, frame_id = loc.stack.pop()
        t.ring.add((seq, name, start, end, frame_id, parent, loc.ident))
        return False


class _FrameContext(_SpanContext):
    """The root span of a `track_frame` call; its spans carry its frame
    id until it closes."""

    __slots__ = ()

    def __exit__(self, *exc):
        self.timers._close(perf_counter_ns())
        self.timers.frame_id = -1
        return False


def _gc_hook(ref):
    """A `gc.callbacks` entry holding its recorder weakly: a recorder
    that was dropped without `set_tracing(False)` leaves a hook that does
    nothing, and removes it when collected (weakref.finalize)."""
    def hook(phase, info):
        rec = ref()
        if rec is None:
            return
        if phase == "start":
            rec._open("gc", perf_counter_ns())
        else:
            # a hook added or removed during a collection sees one phase
            stack = rec._stack()
            if stack and stack[-1][1] == "gc":
                rec._close(perf_counter_ns())
    return hook


def _unhook(hook):
    try:
        gc.callbacks.remove(hook)
    except ValueError:
        pass


class StageTimers:
    """Per-stage wall-clock statistics (SlamSystem.h:115-118,
    DepthMap.h:87-93: EWMA ms = 0.9*ms + 0.1*dt), and the span recorder.

    The FIRST sample of each stage is recorded separately
    (`first_ms`) and excluded from the EWMA / median / max: in the
    engine the first call of a stage includes kernel builds and library
    initialisation, and folding
    it into the EWMA makes the published per-stage cost ~the compile time
    for rarely-called stages (keyframe switches run a handful of times per
    sequence). `ms` (EWMA), `median()` and `max_ms` are therefore
    steady-state numbers; `first_ms` is the warmup cost; `last_ms` the
    newest sample of each stage (first included), which the callers that
    feed a counter from a stage's duration read.

    By default the timers measure host dispatch windows (cheap, async-
    friendly — like the reference's gettimeofday pairs). With a `sync`
    callable (profiling mode, SystemConfig.profile_sync) every stage exit
    blocks until the device drained, so the numbers are true per-stage
    device cost (SURVEY section 5.1)."""

    def __init__(self, alpha: float = 0.9, sync=None,
                 span_capacity: int = SPANS_MAX):
        self.alpha = alpha
        self.sync = sync
        self.ms: Dict[str, float] = defaultdict(float)
        self.n: Dict[str, int] = defaultdict(int)
        self.first_ms: Dict[str, float] = {}
        self.last_ms: Dict[str, float] = {}
        self.max_ms: Dict[str, float] = defaultdict(float)
        self.samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=SAMPLES_MAX))
        # spans: off until set_tracing(True), which allocates the ring
        self.tracing = False
        self.frame_id = -1
        self.span_capacity = int(span_capacity)
        self.ring: Optional[SpanRing] = None
        self._contexts: Dict[str, _SpanContext] = {}
        self._frame_context = _FrameContext(self, "track_frame")
        self._local = threading.local()
        self._seq = itertools.count(1)
        self._gc_hook = None

    # ---------------------------------------------------------- timings

    def record(self, stage: str, dt_ms: float):
        n = self.n[stage]
        self.last_ms[stage] = dt_ms
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
        """Time a stage (and, while tracing, record it as a span)."""
        if self.sync is not None:
            self.sync()
        tracing = self.tracing
        t0 = perf_counter_ns()
        if tracing:
            self._open(stage, t0)
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            t1 = perf_counter_ns()
            if tracing:
                self._close(t1)
            self.record(stage, (t1 - t0) / 1e6)

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

    # ------------------------------------------------------------ spans

    def set_tracing(self, on: bool):
        """Turn span recording on (allocating the ring the first time and
        hooking the collector, whose pauses are spans too) or off (the gc
        hook is removed; the ring is kept for its readers)."""
        on = bool(on)
        if on and self.ring is None:
            self.ring = SpanRing(self.span_capacity)
        if on and self._gc_hook is None:
            hook = _gc_hook(weakref.ref(self))
            gc.callbacks.append(hook)
            weakref.finalize(self, _unhook, hook)
            self._gc_hook = hook
        if not on and self._gc_hook is not None:
            _unhook(self._gc_hook)
            self._gc_hook = None
        self.tracing = on

    def span(self, name: str):
        """A span around a block while tracing; else a shared no-op
        context."""
        if self.tracing:
            try:
                return self._contexts[name]
            except KeyError:
                ctx = self._contexts[name] = _SpanContext(self, name)
                return ctx
        return NULL_SPAN

    def frame(self, frame_id: int):
        """The root span of a `track_frame` call (`track_frame`), whose
        frame id every span opened inside it carries."""
        if not self.tracing:
            return NULL_SPAN
        self.frame_id = int(frame_id)
        return self._frame_context

    def spans(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The recorded spans that lie between two perf_counter_ns times
        (empty when nothing was recorded)."""
        return [] if self.ring is None else self.ring.between(t0_ns, t1_ns)

    @property
    def spans_dropped(self) -> int:
        return 0 if self.ring is None else self.ring.dropped

    def _stack(self) -> list:
        loc = self._local
        try:
            return loc.stack
        except AttributeError:
            loc.stack = []
            loc.ident = threading.get_ident()
            return loc.stack

    def _open(self, name: str, t0: int):
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._stack()
        stack.append((next(self._seq), name, t0,
                      stack[-1][0] if stack else 0, self.frame_id))

    def _close(self, t1: int):
        loc = self._local
        seq, name, t0, parent, frame_id = loc.stack.pop()
        self.ring.add((seq, name, t0, t1, frame_id, parent, loc.ident))


# the recorder of objects built without an engine (a DepthMap or a pose
# graph on its own): never tracing, so its spans are no-ops
NULL_TIMERS = StageTimers()
