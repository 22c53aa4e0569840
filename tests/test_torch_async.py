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
