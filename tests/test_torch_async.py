"""The port's worker threads on the CPU: the bounded queue, the failure
rule (a worker's exception is raised in the caller and no thread is left
running) and the keyframe's deferred depth under concurrent readers.

Every wait here has its own timeout of at most 60 s.
"""

import threading
import time

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
from lsd_slam_tpu_torch.frames import build_frame
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.system.async_mapping import WorkerError
from lsd_slam_tpu_torch.system.keyframe import Keyframe
from lsd_slam_tpu_torch.system.poses import PoseNode, PoseRegistry
from lsd_slam_tpu_torch.utils import synth
from lsd_slam_tpu_torch.utils.native import NotifyQueue

W, H = 160, 128
CAM = Camera(fx=112.0, fy=112.0, cx=79.5, cy=63.5, width=W, height=H)
THREADED = LSDConfig(width=W, height=H).replace(
    system=SystemConfig(sequential=False))


class Injected(Exception):
    pass


def _raise(*a, **k):
    raise Injected("injected into a worker")


def test_notify_queue_drops_on_full_and_pops_in_order():
    q = NotifyQueue(2)
    assert q.push(1) and q.push(2)
    assert not q.push(3) and q.dropped == 1
    assert q.size() == 2
    assert q.pop(0.0) == 1 and q.pop(0.0) == 2
    t0 = time.perf_counter()
    assert q.pop(0.05) is None
    assert time.perf_counter() - t0 >= 0.04


def test_notify_queue_pop_wakes_on_push():
    q = NotifyQueue(4)
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop(30.0)))
    t.start()
    time.sleep(0.05)
    q.push("frame")
    t.join(30.0)
    assert got == ["frame"] and not t.is_alive()


def _inject(sys_, worker):
    """Make `worker` fail on its next unit of work, and hand it one."""
    backend = sys_.backend
    if worker == "mapping":
        sys_.do_mapping_iteration_batch = _raise
        sys_.mapping_thread.push(object())
    elif worker == "constraints":
        backend._ensure = _raise
        backend.constraint_thread.push(object())
    else:
        class FakeGraph:
            class pose_graph:
                n_edges = 1
            optimize_slices = staticmethod(_raise)
        backend._graph = FakeGraph()
        backend.signal_new_constraints()


@pytest.mark.parametrize("worker", ["mapping", "constraints",
                                    "optimization"])
def test_worker_failure_is_raised_by_finalize(worker):
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    assert len(sys_.workers()) == 3
    assert all(w.alive() for w in sys_.workers())
    _inject(sys_, worker)
    failed = {"mapping": sys_.mapping_thread,
              "constraints": sys_.backend.constraint_thread,
              "optimization": sys_.backend.optimization_thread}[worker]
    deadline = time.time() + 30.0
    while failed.error is None and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(WorkerError) as exc:
        sys_.finalize()
    assert isinstance(exc.value.__cause__, Injected)
    assert not any(w.alive() for w in sys_.workers())
    assert not [t for t in threading.enumerate()
                if t.name in ("lsd-mapping", "lsd-constraints",
                              "lsd-optimization")]


def test_worker_failure_is_raised_by_the_next_call():
    """track_frame and block_until_mapped raise a worker's failure too."""
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    try:
        _inject(sys_, "mapping")
        assert sys_.mapping_thread.wait_until_drained(30.0)
        with pytest.raises(WorkerError):
            sys_.block_until_mapped(30.0)
        with pytest.raises(WorkerError):
            sys_.track_frame(np.zeros((H, W), np.float32), 1, 0.0)
    finally:
        with pytest.raises(WorkerError):
            sys_.finalize()
    assert not any(w.alive() for w in sys_.workers())


def _gated_mapping(sys_):
    """Make the mapping thread's iterations wait on the returned gate."""
    gate, batches = threading.Event(), []

    def iteration(batch):
        batches.append(len(batch))
        assert gate.wait(30.0)
    sys_.do_mapping_iteration_batch = iteration
    return gate, batches


def test_back_pressure_waits_for_the_mapping_thread():
    """`wait_for_room(limit)` blocks while more than `limit` pushed frames
    are unmapped (queued or in the batch being mapped)."""
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    try:
        mt = sys_.mapping_thread
        gate, batches = _gated_mapping(sys_)
        assert mt.push("frame 1") and mt.push("frame 2")
        assert not mt.wait_for_room(1, timeout=0.2)
        gate.set()
        assert mt.wait_for_room(0, timeout=30.0)
        assert sum(batches) == 2
    finally:
        gate.set()
        sys_.finalize()


def test_back_pressure_returns_when_the_mapping_thread_fails():
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    try:
        sys_.do_mapping_iteration_batch = _raise
        sys_.mapping_thread.push(object())
        sys_.mapping_thread.push(object())
        assert sys_.mapping_thread.wait_for_room(0, timeout=30.0)
    finally:
        with pytest.raises(WorkerError):
            sys_.finalize()


def test_threaded_track_frame_runs_ahead_of_the_mapping_thread():
    """A threaded frame never waits for the mapping thread, as in the JAX
    engine: with the mapping thread held, three frames are tracked and
    queued unmapped; released, it maps them all."""
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    gate = threading.Event()
    try:
        scene = synth.PlaneScene(seed=3)
        poses = synth.orbit_trajectory(2)
        img0, dep0 = synth.render(scene, CAM, poses[0], device="cpu")
        img1, _ = synth.render(scene, CAM, poses[1], device="cpu")
        sys_.gt_depth_init(img0, dep0, 0, 0.0)
        real = sys_.do_mapping_iteration_batch
        batches = []

        def held(batch):
            assert gate.wait(30.0)
            batches.append(len(batch))
            return real(batch)
        sys_.do_mapping_iteration_batch = held
        for i in (1, 2, 3):
            sys_.track_frame(img1, i, i / 30.0)
        assert sys_.mapping_thread._pending == 3
        assert not batches
        gate.set()
        sys_.block_until_mapped(30.0)
        assert sum(batches) == 3 and sys_.tracking_is_good
    finally:
        gate.set()
        sys_.finalize()


def test_lost_frame_waits_for_the_queued_constraint_searches():
    """The relocaliser votes with graph neighbours, which the constraint
    thread adds: a lost frame first waits until every keyframe queued for
    constraint search has been searched."""
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    gate, seen = threading.Event(), []

    class Graph:
        @staticmethod
        def find_constraints_for_new_keyframe(kf, force_parent):
            assert gate.wait(30.0)
            return 0
    try:
        backend = sys_.backend
        backend._ensure = lambda: Graph
        backend.relocalize = lambda pyr: seen.append(
            backend.constraint_thread._pending)
        assert backend.constraint_thread.push("keyframe")
        threading.Timer(0.2, gate.set).start()
        t0 = time.perf_counter()
        sys_._attempt_relocalization(None, 5, 0.0)
        assert seen == [0] and time.perf_counter() - t0 >= 0.15
    finally:
        gate.set()
        sys_.finalize()


def test_healthy_threaded_finalize_stops_every_worker():
    sys_ = SlamSystem(CAM, THREADED, device="cpu")
    sys_.finalize()
    assert all(w.error is None for w in sys_.workers())
    assert not any(w.alive() for w in sys_.workers())


def test_deferred_depth_builds_once_under_concurrent_readers():
    """Readers of a keyframe's deferred depth on several threads all get the
    one built reference; a refresh in between is never lost."""
    img, dep = synth.render(synth.PlaneScene(seed=0), CAM,
                            np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                            device="cpu")
    pyr = build_frame(img, 5)
    kf = Keyframe(0, 0.0, pyr, PoseNode(0, PoseRegistry()))
    idepth = torch.where(dep > 0, 1.0 / dep, torch.zeros_like(dep))
    ivar = torch.full_like(idepth, 0.01)
    kf.set_depth(idepth, ivar, 1.0, 100, 5, defer=True)
    assert kf._pending_depth is not None and kf._tracking_ref is None
    start = threading.Barrier(4)
    refs = []

    def read():
        start.wait(30.0)
        refs.append(kf.tracking_ref)

    threads = [threading.Thread(target=read) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert len(refs) == 4 and all(r is refs[0] for r in refs)
    assert kf._pending_depth is None
    # a later deferred refresh replaces the built pair
    kf.set_depth(idepth * 2.0, ivar, 2.0, 100, 5, defer=True)
    assert kf.depth.idepth[0].max() == pytest.approx(
        float((idepth * 2.0).max()))
    assert kf.tracking_ref is not refs[0]
