"""The SLAM scenario of tests/test_torch_slam.py, run by one engine in a
fresh process.

    python tests/_torch_slam_scenario.py ENGINE IN.npz OUT.npz [LAG] [FABMAP]

ENGINE is `jax` (the reference engine) or `port`; IN.npz holds the
rendered sequence (`imgs`, `deps`) and the camera (`cam`: fx, fy, cx, cy);
OUT.npz receives what the tests read (see `summary`); LAG is the engine's
`pipeline_lag` (default 0); FABMAP 1 turns on `use_fabmap` (the
appearance index in the constraint search; default 0). The scenario: gt-depth init, N-1 tracked
frames, a manual tracking loss, the return leg fed backwards until the
relocaliser recovers, finalize. At lag > 0 the ring is drained
(`block_until_mapped`) before the loss and after the lost frame, so the
same frames are retired as at lag 0 (a no-op there).

Why a fresh process: the scenario turns rounding differences of a few
ulps into trajectory differences of ~1e-3, the parity bound, and inside a
long-lived pytest-xdist worker the port's CPU run was seen to differ in
the last bits from frame 9 on after other test files had run there (2 of
6 runs; in a fresh process every run is bit-identical). A fresh process
per engine, with the port's torch threads pinned, makes both runs
reproducible wherever the suite runs.
"""

from __future__ import annotations

import sys

import numpy as np

W, H = 160, 128
N = 36
PORT_THREADS = 8
KEYFRAME = dict(kf_dist_weight=25.0, kf_usage_weight=6.0,
                initialization_phase_count=1, min_num_mapped=2)
COUNTERS = ("keyframes_created", "keyframes_reactivated", "relocalized")


def scenario(sys_, imgs, deps):
    """Track, lose, relocalise, finalize. Returns (frame index recovered
    at or -1, tracking state before the loss)."""
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, N):
        sys_.track_frame(imgs[i], i, i / 30.0)
    sys_.block_until_mapped()
    good_before = sys_.tracking_is_good
    sys_.manual_tracking_loss = True
    sys_.track_frame(imgs[N - 1], N, N / 30.0)
    sys_.block_until_mapped()
    assert not sys_.tracking_is_good
    recovered = -1
    for j, i in enumerate(range(N - 2, N // 2, -1)):
        sys_.track_frame(imgs[i], N + 1 + j, (N + 1 + j) / 30.0)
        if sys_.tracking_is_good:
            recovered = i
            break
    sys_.finalize()
    return recovered, good_before


def nonparent_edges(parents: dict, edges) -> list:
    """The edges (a, b) of which neither keyframe is the other's tracking
    parent: loop closures, not the forced constraint every new keyframe
    gets to the keyframe it was tracked on (re-activated keyframes
    included). `parents` maps keyframe id -> parent id (-1 for none)."""
    return [(a, b) for a, b in edges
            if parents.get(a, -1) != b and parents.get(b, -1) != a]


def summary(sys_, counters, recovered, good_before) -> dict:
    graph = sys_.backend.graph
    return dict(
        keyframe_ids=np.asarray([kf.id for kf in sys_.keyframes]),
        parent_ids=np.asarray([-1 if kf.pose.parent is None
                               else kf.pose.parent.frame_id
                               for kf in sys_.keyframes]),
        edges=np.asarray([(e.first.id, e.second.id) for e in graph.edges]),
        counters=np.asarray([counters.get(k, 0) for k in COUNTERS]),
        recovered=recovered, good_before=good_before,
        tracking_is_good=sys_.tracking_is_good,
        n_vertices=graph.pose_graph.n_vertices,
        n_edges=graph.pose_graph.n_edges,
        appearance_size=(-1 if graph.appearance is None
                         else len(graph.appearance)),
        # the port's index counts the queries it scored (-1: none, or JAX)
        appearance_queries=getattr(graph.appearance, "n_queries", -1),
        trajectory=sys_.trajectory_array(),
        optimized=sys_.optimized_trajectory_array())


def run_jax(cam, imgs, deps, lag: int = 0, fabmap: bool = False) -> dict:
    from lsd_slam_tpu.camera import Camera
    from lsd_slam_tpu.config import LSDConfig, KeyframeConfig, SystemConfig
    from lsd_slam_tpu.system import SlamSystem

    cfg = LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME),
        system=SystemConfig(pipeline_lag=lag, use_fabmap=fabmap))
    sys_ = SlamSystem(Camera(*cam, width=W, height=H), cfg,
                      enable_slam=True)
    out = scenario(sys_, imgs, deps)
    return summary(sys_, dict(sys_.stats.counters), *out)


def run_port(cam, imgs, deps, lag: int = 0, fabmap: bool = False) -> dict:
    import torch
    from lsd_slam_tpu_torch.camera import Camera
    from lsd_slam_tpu_torch.config import (LSDConfig, KeyframeConfig,
                                           SystemConfig)
    from lsd_slam_tpu_torch.system import SlamSystem

    torch.set_num_threads(PORT_THREADS)
    cfg = LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME),
        system=SystemConfig(pipeline_lag=lag, use_fabmap=fabmap))
    sys_ = SlamSystem(Camera(*cam, width=W, height=H), cfg, device="cpu")
    out = scenario(sys_, imgs, deps)
    return summary(sys_, sys_.stats.snapshot(), *out)


def short_port_run(n_frames: int = 14, threads: int = 2):
    """The port alone, in this process, with `threads` torch threads, on
    the first n_frames of the loop sequence (rendered by the port): gt
    init, tracked frames with keyframe switches, propagate, constraint
    search and PGO, then finalize. Returns (logged trajectory, optimised
    trajectory, keyframe ids). Few threads: a test worker shares the host
    with the others."""
    import torch
    from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    torch.set_num_threads(threads)
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=13)
    poses = synth.loop_trajectory(N)
    cfg = LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME))
    sys_ = SlamSystem(cam, cfg, device="cpu")
    for i in range(n_frames):
        img, dep = synth.render(scene, cam, poses[i], device="cpu")
        if i == 0:
            sys_.gt_depth_init(img, dep, 0, 0.0)
        else:
            sys_.track_frame(img, i, i / 30.0)
    sys_.finalize()
    return (sys_.trajectory_array(), sys_.optimized_trajectory_array(),
            [kf.id for kf in sys_.keyframes])


def main(engine: str, src: str, dst: str, lag: str = "0",
         fabmap: str = "0") -> int:
    d = np.load(src)
    cam = [float(x) for x in d["cam"]]
    run = {"jax": run_jax, "port": run_port}[engine]
    np.savez(dst, **run(cam, d["imgs"], d["deps"], int(lag),
                        bool(int(fabmap))))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
