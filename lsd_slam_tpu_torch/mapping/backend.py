"""SLAM back-end orchestration: constraint search + pose-graph optimisation
(torch).

Port of lsd_slam_tpu/mapping/backend.py (the constraint-search and
optimisation threads of SlamSystem.cpp:266-381). `sequential=True` runs
both inline after each new keyframe; `sequential=False` hands new
keyframes to a ConstraintThread, which also re-tracks random old keyframes
when idle (SlamSystem.cpp:275-310), and runs PGO slices on an
OptimizationThread (system/async_mapping.py says how they share the
card). Optimised poses are staged and merged back on the mapping path
(mergeOptimizationOffset, SlamSystem.cpp:176-202).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from lsd_slam_tpu_torch.system.slam_system import SlamSystem
    from lsd_slam_tpu_torch.system.keyframe import Keyframe


class MappingBackend:
    """Owns the keyframe graph, the constraint trackers and the
    optimiser."""

    def __init__(self, system: "SlamSystem"):
        self.system = system
        self._graph = None
        self._have_unmerged = False
        self._finalizing = False
        self.constraint_thread = None
        self.optimization_thread = None
        if not system.cfg.system.sequential:
            from lsd_slam_tpu_torch.system.async_mapping import (
                ConstraintThread, OptimizationThread)
            self.constraint_thread = ConstraintThread(self)
            self.optimization_thread = OptimizationThread(self)
            self.constraint_thread.start()
            self.optimization_thread.start()

    def _ensure(self):
        if self._graph is None:
            from lsd_slam_tpu_torch.mapping.keyframe_graph import \
                KeyFrameGraph
            self._graph = KeyFrameGraph(self.system)
        return self._graph

    @property
    def graph(self):
        return self._ensure()

    def workers(self):
        return [w for w in (self.constraint_thread, self.optimization_thread)
                if w is not None]

    def on_new_keyframe(self, kf: "Keyframe"):
        graph = self._ensure()
        graph.add_keyframe(kf)
        if self.constraint_thread is not None:
            # threaded: hand the keyframe to the constraint worker
            # (== newKeyFrames queue, SlamSystem.cpp:417-420)
            self.constraint_thread.push(kf)
            return
        n_added = graph.find_constraints_for_new_keyframe(
            kf, force_parent=True)
        # the reference optimises only when constraints arrived
        # (newConstraintAdded handshake, SlamSystem.cpp:359-381)
        if n_added > 0:
            changed = graph.optimize_slices(
                max_slices=self.system.cfg.system.pgo_max_slices_per_update)
            if changed:
                self._have_unmerged = True

    def signal_new_constraints(self):
        """== newConstraintAdded + signal (SlamSystem.cpp:1570-1579)."""
        if self.optimization_thread is not None:
            self.optimization_thread.signal()

    def wait_until_drained(self, timeout: float = 120.0):
        """Drain the threaded back-end (constraint queue, then optimiser)."""
        for w in self.workers():
            w.wait_until_drained(timeout)

    def stop_threads(self):
        for w in self.workers():
            w.stop()

    def merge_optimization_offset(self):
        """Apply staged graph-opt results (SlamSystem.cpp:176-202)."""
        if not self._have_unmerged or self._graph is None:
            return
        if self.system.cfg.system.defer_pgo_merge and not self._finalizing:
            return  # measurement mode: merges land only at finalize
        needs_publish = False
        for kf in list(self.system.keyframes):
            if kf.pose.apply_graph_opt_result():
                needs_publish = True
        if needs_publish:
            self.system.registry.invalidate_all()
            if self.system.output is not None:
                # == publishKeyframeGraph after the merge
                # (SlamSystem.cpp:198-200): a poses-only update
                self.system.output.publish_keyframe_graph(
                    self.system.keyframes, self._graph.edges)
        self._have_unmerged = False

    def refresh_permaref(self, kf):
        """== Frame::setPermaRef at finishCurrentKeyframe."""
        if self._graph is not None:
            self._graph.set_permaref(kf)

    def find_reposition_candidate(self, tracked, max_score: float):
        if self._graph is None:
            return None
        return self._graph.find_reposition_candidate(tracked, max_score)

    def relocalize(self, pyr):
        if self._graph is None:
            return None
        return self._graph.relocalize(pyr)

    def full_reconstraint_search(self):
        """Re-search constraints for every keyframe
        (== doFullReConstraintTrack, SlamSystem.cpp:332-350)."""
        if self._graph is None:
            return 0
        n = 0
        for kf in list(self.system.keyframes):
            n += self._graph.find_constraints_for_new_keyframe(
                kf, force_parent=False)
        return n

    def finalize(self):
        """Final full optimisation (SlamSystem.cpp:225-263), after the
        threads drained and stopped; a failed worker raises first."""
        self._finalizing = True
        self.wait_until_drained()
        self.stop_threads()
        self.system.raise_worker_error()
        if self._graph is None:
            return
        if self.system.cfg.system.full_reconstraint_on_finalize:
            self.full_reconstraint_search()
            self._graph.optimize_slices()
        self._graph.optimize_final()
        self._have_unmerged = True
        self.merge_optimization_offset()
