"""The port's mesh paths wired into the engine, on eight shards of the CPU
(`make_mesh(8, "cpu")`), against the JAX package's mesh paths on
conftest's eight virtual devices and against the port's own single-device
run (tests/test_engine_multichip.py's graphs and sequence).

Bounds:
  * `PoseGraph(mesh)` with `mesh_min_edges = 0` on `_loop_graph(17)` (17
    vertices padded to 32, the dense distributed step): every pose within
    2e-3 of JAX's mesh PoseGraph and of the port's single-device dense
    solve (the JAX test's bound);
  * the large-graph path (`dense_threshold = 8`: the edge-sharded PCG
    step) on `_loop_graph(40)`: the worst position error to the ground
    truth falls below 0.2x its initial value (the JAX test's bound);
  * three shards, a count that is no power of two, through the mesh
    (the dense distributed step) and through the SPMD CG program of a
    multi-process frontend (stood in for by one process): the padded
    edges divide over the shards, and every pose lies within 2e-3 of the
    single-device dense solve;
  * the 160x128 engine with a mesh and both gates forced (every
    quick-track batch split over the shards, every PGO on the mesh)
    against the port's single-device run: the same keyframes and edge
    pairs, both ATEs below 0.02, positions within 0.01 (the JAX test's
    bounds).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsd_slam_tpu.mapping.pose_graph import PoseGraph as JaxPoseGraph
from lsd_slam_tpu.parallel import make_mesh as jax_make_mesh

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
from lsd_slam_tpu_torch.mapping import keyframe_graph
from lsd_slam_tpu_torch.mapping.keyframe_graph import KeyFrameGraph
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
from lsd_slam_tpu_torch.parallel import make_mesh
from lsd_slam_tpu_torch.parallel.multihost_engine import _spmd_pgo
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils import synth
from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

from tests.test_engine_multichip import _loop_graph


def _aligned(a, b):
    """b with each quaternion's sign flipped to a's hemisphere."""
    sign = np.where(np.sum(a[:, :4] * b[:, :4], axis=1) < 0, -1.0, 1.0)
    return b * np.concatenate([np.tile(sign[:, None], (1, 4)),
                               np.ones((len(b), 4))], axis=1)


def test_posegraph_mesh_matches_jax_and_single_device():
    jax_mesh = JaxPoseGraph(mesh=jax_make_mesh(8))
    jax_mesh.mesh_min_edges = 0
    _loop_graph(jax_mesh, 17, np.random.default_rng(3))
    port_mesh = PoseGraph(device="cpu", mesh=make_mesh(8, "cpu"))
    port_mesh.mesh_min_edges = 0
    _loop_graph(port_mesh, 17, np.random.default_rng(3))
    single = PoseGraph(device="cpu")
    _loop_graph(single, 17, np.random.default_rng(3))
    for _ in range(4):
        jax_mesh.optimize(5)
        port_mesh.optimize(5)
        single.optimize(5)
    got = np.stack(port_mesh.poses)
    for want in (np.stack(jax_mesh.poses), np.stack(single.poses)):
        np.testing.assert_allclose(_aligned(want, got), want, atol=2e-3)


def test_posegraph_mesh_cg_reduces_error_large_graph():
    pg = PoseGraph(device="cpu", mesh=make_mesh(8, "cpu"))
    pg.mesh_min_edges = 0
    pg.dense_threshold = 8   # nb = 64 > 8: the edge-sharded PCG step
    gt = _loop_graph(pg, 40, np.random.default_rng(5))
    before = max(np.linalg.norm(pg.poses[i][4:7] - gt[i][4:7])
                 for i in range(40))
    for _ in range(6):
        pg.optimize(5)
    after = max(np.linalg.norm(pg.poses[i][4:7] - gt[i][4:7])
                for i in range(40))
    assert after < 0.2 * before, (before, after)


class _OneProcessFrontend:
    """The multi-process frontend's PGO side in one process: its global
    mesh is `n` CPU shards and `pgo` runs the SPMD CG program on it."""

    def __init__(self, n):
        self.mesh = make_mesh(n, "cpu")
        self.pgo_calls = 0

    def pgo(self, payload, num_iterations):
        self.pgo_calls += 1
        return _spmd_pgo(payload, num_iterations, self.mesh)


@pytest.mark.parametrize("path", ["mesh", "multihost"])
def test_posegraph_three_shards(path):
    pg = PoseGraph(device="cpu",
                   mesh=make_mesh(3, "cpu") if path == "mesh" else None)
    pg.mesh_min_edges = 0
    if path == "multihost":
        pg.multihost = _OneProcessFrontend(3)
        pg.multihost_min_edges = 0
    _loop_graph(pg, 17, np.random.default_rng(3))
    single = PoseGraph(device="cpu")
    _loop_graph(single, 17, np.random.default_rng(3))
    assert pg._padded_arrays(3)[1]["efrom"].shape[0] % 3 == 0
    for _ in range(4):
        pg.optimize(5)
        single.optimize(5)
    if path == "multihost":
        assert pg.multihost.pgo_calls == 4
    want = np.stack(single.poses)
    np.testing.assert_allclose(_aligned(want, np.stack(pg.poses)), want,
                               atol=2e-3)


W, H, N = 160, 128, 24


def _run_slam(mesh):
    """tests/test_engine_multichip.py's SLAM run, rendered by the port; with
    `mesh` the engine's default mesh is `mesh` and both gates are 0.
    Returns (system, ground truth, how many sharded quick-track batches and
    mesh PGO solves ran)."""
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=7)
    imgs, deps, gts = [], [], []
    for i in range(N):
        a = i / (N - 1)
        x = 0.4 * np.sin(np.pi * a)
        c2w = torch.tensor([1, 0, 0, 0, x, 0, 0.01 * np.sin(np.pi * a)],
                           dtype=torch.float32)
        w2c = lie.se3_inverse(c2w)
        img, dep = synth.render(scene, cam, w2c, device="cpu")
        imgs.append(img)
        deps.append(dep)
        gts.append(w2c.numpy())
    cfg = LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(kf_dist_weight=25.0, kf_usage_weight=6.0,
                                initialization_phase_count=1,
                                min_num_mapped=2))
    ran = {"quick": 0, "pgo": 0}

    def counted(make, key):
        def made(*a):
            fn = make(*a)

            def call(*b):
                ran[key] += 1
                return fn(*b)
            return call
        return made

    with pytest.MonkeyPatch.context() as mp:
        if mesh is not None:
            mp.setattr(keyframe_graph, "default_mesh", lambda device: mesh)
            mp.setattr(KeyFrameGraph, "mesh_min_lanes_per_device", 0)
            mp.setattr(PoseGraph, "mesh_min_edges", 0)
            for name in ("sharded_quick_track", "sharded_quick_track_frames"):
                mp.setattr(keyframe_graph, name,
                           counted(getattr(keyframe_graph, name), "quick"))
            optimize_mesh = PoseGraph._optimize_mesh

            def counted_optimize(self, num_iterations):
                ran["pgo"] += 1
                return optimize_mesh(self, num_iterations)
            mp.setattr(PoseGraph, "_optimize_mesh", counted_optimize)
        sys_ = SlamSystem(cam, cfg, enable_slam=True, device="cpu")
        sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
        for i in range(1, N):
            sys_.track_frame(imgs[i], i, i / 30.0)
        sys_.finalize()
    return sys_, np.stack(gts), ran


# both engines at one small thread count: the same rounding in both, and
# no oversubscribed cores when test files run side by side
ENGINE_THREADS = 2


@pytest.fixture(scope="module")
def engines():
    threads = torch.get_num_threads()
    torch.set_num_threads(ENGINE_THREADS)
    try:
        return _run_slam(make_mesh(8, "cpu")), _run_slam(None)
    finally:
        torch.set_num_threads(threads)


def test_engine_mesh_matches_single_device(engines):
    (sys_mesh, gt, ran), (sys_single, _, _) = engines
    graph = sys_mesh.backend.graph
    assert graph.mesh is not None and graph.pose_graph.mesh is graph.mesh
    assert sys_single.backend.graph.mesh is None
    assert graph.pose_graph.n_edges > 0
    assert ran["quick"] > 0 and ran["pgo"] > 0, ran
    assert ([kf.id for kf in sys_mesh.keyframes]
            == [kf.id for kf in sys_single.keyframes])
    assert ([(e.first.id, e.second.id) for e in graph.edges]
            == [(e.first.id, e.second.id)
                for e in sys_single.backend.graph.edges])
    traj_mesh = sys_mesh.trajectory_array()
    traj_single = sys_single.trajectory_array()
    assert ate_rmse(traj_mesh, gt) < 0.02
    assert ate_rmse(traj_single, gt) < 0.02
    assert traj_mesh.shape == traj_single.shape
    pos_diff = np.linalg.norm(traj_mesh[:, 4:7] - traj_single[:, 4:7],
                              axis=1).max()
    assert pos_diff < 0.01, pos_diff


def test_engine_without_mesh_flag_has_no_mesh():
    """`use_device_mesh=False` keeps the single-device paths whatever the
    default mesh would be."""
    cfg = LSDConfig(width=W, height=H)
    cfg = cfg.replace(system=dataclasses.replace(cfg.system,
                                                 use_device_mesh=False))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(keyframe_graph, "default_mesh",
                   lambda device: make_mesh(8, "cpu"))
        sys_ = SlamSystem(synth.default_camera(W, H), cfg, device="cpu")
        assert sys_.backend.graph.mesh is None
        assert sys_.backend.graph.pose_graph.mesh is None
