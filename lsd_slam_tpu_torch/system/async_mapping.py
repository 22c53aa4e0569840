"""The engine's worker threads: mapping, constraint search, optimisation.

Port of lsd_slam_tpu/system/async_mapping.py. The reference runs tracking
and mapping in separate threads joined by the unmappedTrackedFrames queue
(SlamSystem.cpp:111-117, 206-223; capped at 50/100 entries,
SlamSystem.cpp:1023-1027), with constraint search and pose-graph
optimisation on two more (SlamSystem.cpp:266-381). Tracking stays on the
caller's thread; depth-map updates and keyframe switches drain a bounded
queue on the mapping thread (`sequential=False, pipeline_lag=0`), and new
keyframes drain into constraint search and PGO slices
(`sequential=False` at any lag).

Rules on the card:
- One stream. Every thread issues to the device's default stream, so
  device work runs in issue order, as the chip serialises the JAX
  engine's programs; host work (pose bookkeeping, graph search, Python)
  overlaps with it. No worker owns a side stream: handing a tensor from
  one stream to another would need a `wait_stream` and a `record_stream`
  at every hand-off between threads.
- No hidden failure. A worker catches any exception of its loop, records
  it as `error`, marks itself idle so no waiter blocks, and exits;
  SlamSystem re-raises it (as `WorkerError`) in the caller at the next
  `track_frame`, `block_until_mapped` or `finalize`. A healthy run is
  unchanged.

Consistency model (as in the JAX engine): the mapping thread is the only
mutator of depth and keyframe state; the tracking thread reads
`current_keyframe.tracking_ref` through single attribute loads (the
depthHasBeenUpdatedFlag handshake, SlamSystem.cpp:905-915).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from lsd_slam_tpu_torch.utils.native import NotifyQueue


class WorkerError(RuntimeError):
    """A worker thread failed; the original exception is the cause."""


class _Worker:
    """A daemon thread running `_loop` while `_running`, with an idle event
    for drain waits, a count of the items pushed and not yet done for
    `wait_for_room`, and the failure record of the rules above."""

    name = "lsd-worker"

    def __init__(self):
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        self.error: Optional[Exception] = None
        self._pending = 0
        self._done = threading.Condition()

    def _push(self, queue: NotifyQueue, item) -> bool:
        """Queue `item`, counted pending until `_finished` (a dropped item
        is not counted)."""
        with self._done:
            if not queue.push(item):
                return False
            self._pending += 1
            return True

    def _finished(self, n: int):
        with self._done:
            self._pending -= n
            self._done.notify_all()

    def wait_for_room(self, limit: int, timeout: float = 60.0) -> bool:
        """Block while more than `limit` pushed items are not done (queued
        or being worked on); returns at once when the worker has stopped
        or failed. False on timeout."""
        with self._done:
            return self._done.wait_for(
                lambda: (self._pending <= limit or not self._running
                         or self.error is not None), timeout)

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=self.name)
        self._thread.start()

    def _run(self):
        try:
            self._loop()
        except Exception as exc:  # noqa: BLE001 - re-raised in the caller
            self.error = exc
            self._running = False
            self._idle.set()
            self._finished(0)

    def _wake(self):
        """Unblock the loop so that it sees `_running` cleared."""

    def stop(self, timeout: float = 60.0):
        self._running = False
        self._wake()
        self._finished(0)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait_until_drained(self, timeout: float = 60.0) -> bool:
        """Wait until the worker is idle (or failed); False on timeout."""
        return self._idle.wait(timeout)

    def _loop(self):
        raise NotImplementedError


class MappingThread(_Worker):
    """Drains tracked frames into mapping iterations
    (== mappingThreadLoop, SlamSystem.cpp:206-223)."""

    name = "lsd-mapping"

    def __init__(self, system, queue_capacity: int = 50):
        super().__init__()
        self.system = system
        self.queue = NotifyQueue(queue_capacity)

    def push(self, tracked) -> bool:
        """Queue a tracked frame (drop-on-full like the reference's cap).
        Busy is marked before the push, so the worker's idle mark after
        draining it can never come first."""
        self._idle.clear()
        return self._push(self.queue, tracked)

    def _loop(self):
        sys_ = self.system
        while self._running:
            tracked = self.queue.pop(0.05)
            if tracked is None:
                if self.queue.size() == 0:
                    self._idle.set()
                continue
            # drain everything queued into one mapping iteration: the
            # reference's whole-deque updateKeyframe (SlamSystem.cpp:
            # 542-571), one multi-reference sweep per chunk
            batch = [tracked]
            while True:
                nxt = self.queue.pop(0.0)
                if nxt is None:
                    break
                batch.append(nxt)
            sys_.stats.bump("mapping_batches")
            sys_.stats.high_water("mapping_batch_max", len(batch))
            try:
                sys_.do_mapping_iteration_batch(batch)
            finally:
                self._finished(len(batch))
                if self.queue.size() == 0:
                    self._idle.set()


class ConstraintThread(_Worker):
    """Drains new keyframes into Sim(3) constraint search, and re-tracks
    random old keyframes when idle (== constraintSearchThreadLoop,
    SlamSystem.cpp:266-357): a random pick from the first third of
    keyframes_for_retrack is searched again with force_parent off and a
    relaxed closeness of 2.0 (SlamSystem.cpp:281-290)."""

    name = "lsd-constraints"

    def __init__(self, backend, queue_capacity: int = 32):
        super().__init__()
        self.backend = backend
        self.queue = NotifyQueue(queue_capacity)
        # quiesce: pause the idle re-track densifier. Each retrack issues
        # device work, so a caller waiting for the back-end to drain
        # (finalize, benches) would never see the card go quiet; drained
        # therefore means quiescent, and a new keyframe resumes it
        self._quiesce = threading.Event()
        self._failed_to_retrack = 0

    def push(self, kf) -> bool:
        self._idle.clear()
        self._quiesce.clear()
        return self._push(self.queue, kf)

    def wait_until_drained(self, timeout: float = 120.0) -> bool:
        self._quiesce.set()
        return self._idle.wait(timeout)

    def _idle_retrack(self) -> bool:
        """One random old-keyframe re-track (SlamSystem.cpp:275-310).
        Returns True when a retrack ran and the pool is still productive
        (== doneSomething)."""
        graph = self.backend._graph
        if graph is None:
            return False
        retrack = graph.keyframes_for_retrack
        sys_ = self.backend.system
        if len(retrack) <= sys_.cfg.keyframe.retrack_min_keyframes:
            return False
        idx = graph._rng.randrange(max(len(retrack) // 3, 1))
        kf = retrack.pop(idx)
        retrack.append(kf)
        sys_.stats.bump("retrack_attempts")
        with sys_.timers.time("retrack"):
            found = graph.find_constraints_for_new_keyframe(
                kf, force_parent=False, use_fabmap=False,
                close_candidates_th=2.0)
        if found == 0:
            self._failed_to_retrack += 1
        else:
            self._failed_to_retrack = 0
            sys_.stats.bump("retrack_constraints_found", found)
            self.backend.signal_new_constraints()
        return self._failed_to_retrack < len(retrack) - 5

    def _loop(self):
        while self._running:
            kf = self.queue.pop(0.05)
            if kf is None:
                if self.queue.size() == 0:
                    did_something = False
                    try:
                        if not self._quiesce.is_set():
                            did_something = self._idle_retrack()
                    finally:
                        if self.queue.size() == 0:
                            self._idle.set()
                    # pace the densifier: the reference wakes at most every
                    # 500 ms (SlamSystem.cpp:308) on its own core; here each
                    # retrack queues device work ahead of tracking's
                    time.sleep(0.2 if did_something else 0.5)
                continue
            try:
                graph = self.backend._ensure()
                sys_ = self.backend.system
                with sys_.timers.time("constraint_search"):
                    n = graph.find_constraints_for_new_keyframe(
                        kf, force_parent=True)
                sys_.stats.bump("constraint_search_ms",
                                sys_.timers.last_ms["constraint_search"])
                sys_.stats.bump("constraint_searches")
                self._failed_to_retrack = 0
                if n > 0:
                    self.backend.signal_new_constraints()
            finally:
                self._finished(1)
                if self.queue.size() == 0:
                    self._idle.set()


class OptimizationThread(_Worker):
    """Runs pose-graph slices whenever constraints arrive
    (== optimizationThreadLoop, SlamSystem.cpp:359-381): slices until the
    change is small, results staged for the merge on the mapping path
    (mergeOptimizationOffset)."""

    name = "lsd-optimization"

    def __init__(self, backend):
        super().__init__()
        self.backend = backend
        self._wake_ev = threading.Event()

    def _wake(self):
        self._wake_ev.set()

    def signal(self):
        self._idle.clear()
        self._wake_ev.set()

    def _loop(self):
        while self._running:
            # a timed wait, like the reference's 2000 ms timed_wait
            # (SlamSystem.cpp:366), so that a missed signal costs little
            self._wake_ev.wait(2.0)
            self._wake_ev.clear()
            graph = self.backend._graph
            if graph is None or graph.pose_graph.n_edges == 0:
                self._idle.set()
                continue
            try:
                if graph.optimize_slices():
                    self.backend._have_unmerged = True
            finally:
                if not self._wake_ev.is_set():
                    self._idle.set()
