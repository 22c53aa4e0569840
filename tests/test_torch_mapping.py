"""Parity of the port's mapping pieces with the JAX package on the CPU.

  * `PoseGraph.optimize` on the dense graphs of tests/test_pose_graph.py,
    carried across with `interop.pose_graph_from_dict`: every vertex within
    1e-4 (|log| of the relative Sim3) of the JAX solve — both assemble in
    f32 and solve the same damped system in f64 — and the port's result
    passes the original test's own check;
  * `graph_distances_from` against the JAX graph's (native BFS): equal;
  * `find_euclidean_overlap_frames` against the loop oracle of
    tests/test_candidate_search.py and the JAX graph: the same keyframes,
    distances within 1e-12, poses within 1e-12 (both f64 numpy);
  * keyframe re-activation (`set_from_existing_kf`, regularize without
    occlusion removal) and the snapshot it starts from: masks and the
    blacklist equal, floats within 1e-6 (the stencil's bar).
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.depth import DepthMap as JaxDepthMap
from lsd_slam_tpu.lie import np_sim3 as nps
from lsd_slam_tpu.mapping.keyframe_graph import KeyFrameGraph as JaxGraph
from lsd_slam_tpu.mapping.pose_graph import PoseGraph as JaxPoseGraph
from lsd_slam_tpu.system.poses import (PoseNode as JaxPoseNode,
                                       PoseRegistry as JaxPoseRegistry)
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch import interop
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth import DepthMap
from lsd_slam_tpu_torch.mapping.keyframe_graph import KeyFrameGraph
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
from lsd_slam_tpu_torch.system.poses import PoseNode, PoseRegistry
from lsd_slam_tpu_torch.utils.stats import RunningStats

from _torch_parity import np_, to_dict

W, H = 160, 128
POSE_TOL = 1e-4


# ------------------------------------------------------------- pose graph

def circle(n, radius=2.0):
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        q = np.array([np.cos(a / 2), 0, np.sin(a / 2), 0])
        t = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))])
        out.append(np.concatenate([q, t, [1.0]]))
    return out


def rel(a, b):
    return nps.sim3_mul(nps.sim3_inverse(a), b)


def perturbed(rng, p, sigma):
    noise = np.concatenate([rng.normal(0, sigma, 6), [0.0]])
    pert = np.asarray(jlie.sim3_exp(jnp.asarray(noise, jnp.float32)),
                      np.float64)
    return nps.sim3_mul(pert, p)


def graph_case(name):
    """(vertices [(pose, fixed)], edges [(i, j, meas, info, delta)],
    iterations, ground truth) of one graph of tests/test_pose_graph.py."""
    if name == "identity":
        gt = circle(6)
        verts = [(p, i == 0) for i, p in enumerate(gt)]
        edges = [(i, i + 1, rel(gt[i], gt[i + 1]), np.eye(7), 1e6)
                 for i in range(5)]
        return verts, edges, 5, gt
    if name == "perturbed_chain":
        rng = np.random.default_rng(0)
        gt = circle(8)
        verts = [(gt[0], True)] + [(perturbed(rng, p, 0.03), False)
                                   for p in gt[1:]]
        info = np.eye(7) * 100
        edges = [(i, i + 1, rel(gt[i], gt[i + 1]), info, 1e6)
                 for i in range(7)] + [(0, 7, rel(gt[0], gt[7]), info, 1e6)]
        return verts, edges, 25, gt
    if name == "scale_drift":
        gt = circle(8)
        est = [gt[0]]
        for i in range(1, 8):
            r = rel(gt[i - 1], gt[i]).copy()
            r[7] *= 1.05
            est.append(nps.sim3_mul(est[-1], r))
        verts = [(p, i == 0) for i, p in enumerate(est)]
        edges = [(i, i + 1, rel(est[i], est[i + 1]), np.eye(7), 1e6)
                 for i in range(7)]
        edges.append((0, 7, rel(gt[0], gt[7]), np.eye(7) * 10000, 1e6))
        return verts, edges, 30, gt
    delta = 0.05 if name == "huber_robust" else 1e6
    gt = circle(6)
    verts = [(p, i == 0) for i, p in enumerate(gt)]
    info = np.eye(7) * 100
    edges = [(i, i + 1, rel(gt[i], gt[i + 1]), info, 1e6) for i in range(5)]
    bad = rel(gt[0], gt[5]).copy()
    bad[4:7] += np.array([3.0, -2.0, 1.0])
    edges.append((0, 5, bad, info, delta))
    return verts, edges, 15, gt


def build(graph, verts, edges):
    for p, fixed in verts:
        graph.add_vertex(p, fixed=fixed)
    for e in edges:
        graph.add_edge(*e)
    return graph


def log_dist(a, b):
    return nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(a), b))


@pytest.mark.parametrize("name", ["identity", "perturbed_chain",
                                  "scale_drift", "huber_robust",
                                  "huber_plain"])
def test_pose_graph_matches_jax(name):
    verts, edges, iters, gt = graph_case(name)
    jg = build(JaxPoseGraph(), verts, edges)
    tg = interop.pose_graph_from_dict(
        dict(poses=jg.poses, fixed=jg.fixed, e_from=jg.e_from, e_to=jg.e_to,
             e_meas_inv=jg.e_meas_inv, e_info=jg.e_info,
             e_delta=jg.e_delta), device="cpu")
    want_change = jg.optimize(iters)
    got_change = tg.optimize(iters)
    assert abs(got_change - want_change) <= POSE_TOL
    for a, b in zip(tg.poses, jg.poses):
        assert log_dist(a, b) <= POSE_TOL
    np.testing.assert_allclose(tg.chi2_initial, jg.chi2_initial, rtol=1e-4,
                               atol=1e-9)
    # the original test's own check, on the port's result
    errs = [log_dist(p, g) for p, g in zip(tg.poses, gt)]
    if name == "identity":
        assert got_change < 1e-3 and max(errs) < 1e-3
    elif name == "perturbed_chain":
        assert max(errs) < 5e-3
    elif name == "scale_drift":
        est7 = verts[7][0]
        assert abs(np.log(tg.poses[7][7] / gt[7][7])) \
            < 0.3 * abs(np.log(est7[7] / gt[7][7]))
    elif name == "huber_plain":
        assert max(errs) > 0.4


def test_pose_graph_built_in_the_port_matches_interop():
    verts, edges, iters, _ = graph_case("perturbed_chain")
    a = build(PoseGraph(device="cpu"), verts, edges)
    jg = build(JaxPoseGraph(), verts, edges)
    b = interop.pose_graph_from_dict(
        dict(poses=jg.poses, fixed=jg.fixed, e_from=jg.e_from, e_to=jg.e_to,
             e_meas_inv=jg.e_meas_inv, e_info=jg.e_info,
             e_delta=jg.e_delta), device="cpu")
    a.optimize(iters)
    b.optimize(iters)
    for x, y in zip(a.poses, b.poses):
        assert log_dist(x, y) == 0.0


def test_pose_graph_above_dense_threshold_raises():
    """Once a raise (the sparse solver was not ported); now the graph
    routes to `sparse_pgo.optimize_sparse` and returns (parity with JAX in
    tests/test_torch_sparse_pgo.py)."""
    g = PoseGraph(device="cpu")
    for i in range(PoseGraph.dense_threshold + 1):
        g.add_vertex(nps.sim3_identity(), fixed=(i == 0))
    g.add_edge(0, 1, nps.sim3_identity(), np.eye(7), 1e6)
    assert g.optimize(1) == 0.0
    assert len(g.cg_iters) == 1


# ---------------------------------------------------- graph and candidates

def _fake_systems(n_kf, seed=0):
    """The keyframe set of tests/test_candidate_search.py, built once for
    each package from the same draws."""
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(n_kf):
        q = rng.normal(size=4)
        q[0] = abs(q[0]) + 2.0
        q /= np.linalg.norm(q)
        t = rng.normal(scale=0.5, size=3)
        s = np.exp(rng.normal(scale=0.1))
        draws.append((np.concatenate([q, t, [s]]),
                      float(np.exp(rng.normal(scale=0.2)))))
    jcam = synth.default_camera(W, H)
    out = []
    for Registry, Node, cam, cfg in (
            (JaxPoseRegistry, JaxPoseNode, jcam, JaxConfig(width=W, height=H)),
            (PoseRegistry, PoseNode,
             Camera(fx=jcam.fx, fy=jcam.fy, cx=jcam.cx, cy=jcam.cy, width=W,
                    height=H), LSDConfig(width=W, height=H))):
        registry = Registry()
        kfs = []
        for i, (c2w, mean_id) in enumerate(draws):
            node = Node(i, registry)
            node.this_to_parent = c2w.copy()
            kfs.append(SimpleNamespace(id=i, pose=node, mean_idepth=mean_id,
                                       idx_in_keyframes=i))
        out.append(SimpleNamespace(
            cam=cam, cfg=cfg, keyframes=kfs, registry=registry,
            id_to_keyframe={kf.id: kf for kf in kfs}, device=torch.device(
                "cpu"), stats=RunningStats()))
    return out


def _loop_reference(graph, frame_c2w, mean_idepth, distance_th, angle_th,
                    check_both_scales):
    """The serial oracle of tests/test_candidate_search.py."""
    cos_angle_th = math.cos(angle_th * 0.5 * (graph.fow_x + graph.fow_y))
    pos = frame_c2w[4:7]
    view = nps.quat_to_matrix(frame_c2w[0:4])[:, 2]
    dist_fac_recip = mean_idepth / frame_c2w[7]
    out = []
    for kf in graph.system.keyframes:
        c2w = kf.pose.cam_to_world()
        dist_fac = kf.mean_idepth / c2w[7]
        if check_both_scales and dist_fac_recip < dist_fac:
            dist_fac = dist_fac_recip
        d = (pos - c2w[4:7]) * dist_fac
        d2 = float(d @ d)
        if d2 > distance_th:
            continue
        if float(nps.quat_to_matrix(c2w[0:4])[:, 2] @ view) < cos_angle_th:
            continue
        out.append((kf, d2, nps.se3_inverse(nps.se3_from_sim3(
            nps.sim3_mul(nps.sim3_inverse(c2w), frame_c2w)))))
    return out


@pytest.mark.parametrize("check_both_scales", [False, True])
def test_euclidean_overlap_matches_loop_and_jax(check_both_scales):
    jsys, tsys = _fake_systems(64)
    jg, tg = JaxGraph(jsys), KeyFrameGraph(tsys)
    query = tsys.keyframes[17].pose.cam_to_world()
    got = tg.find_euclidean_overlap_frames(query, 1.1, 0.9, 0.75,
                                           check_both_scales)
    for want in (_loop_reference(tg, query, 1.1, 0.9, 0.75,
                                 check_both_scales),
                 jg.find_euclidean_overlap_frames(query, 1.1, 0.9, 0.75,
                                                  check_both_scales)):
        assert [kf.id for kf, _, _ in got] == [kf.id for kf, _, _ in want]
        for (_, d2a, pa), (_, d2b, pb) in zip(got, want):
            assert abs(d2a - d2b) < 1e-12
            np.testing.assert_allclose(pa, pb, atol=1e-12)
    assert got, "the query overlaps no keyframe"


def test_graph_distances_match_jax():
    jsys, tsys = _fake_systems(12)
    jg, tg = JaxGraph(jsys), KeyFrameGraph(tsys)
    rng = np.random.default_rng(4)
    pairs = [(i, i + 1) for i in range(7)] + [
        tuple(int(x) for x in rng.choice(10, 2, replace=False))
        for _ in range(4)]
    for g in (jg, tg):
        for a, b in pairs:
            g.neighbors.setdefault(a, set()).add(b)
            g.neighbors.setdefault(b, set()).add(a)
        g.neighbors.setdefault(11, set())      # an isolated keyframe
    for start in (0, 5, 11):
        want = jg.graph_distances_from(jsys.keyframes[start])
        got = tg.graph_distances_from(tsys.keyframes[start])
        assert got == want
    assert tg.graph_distances_from(SimpleNamespace(id=99)) == {99: 0}


def test_fabmap_raises():
    """Once a raise (the appearance index was not ported); now the graph
    builds its AppearanceIndex (parity with JAX in
    tests/test_torch_appearance.py)."""
    from lsd_slam_tpu_torch.mapping.appearance import AppearanceIndex
    _, tsys = _fake_systems(2)
    tsys.cfg = tsys.cfg.replace(system=dataclasses.replace(
        tsys.cfg.system, use_fabmap=True))
    assert isinstance(KeyFrameGraph(tsys).appearance, AppearanceIndex)


# ------------------------------------------------------------ re-activation

@pytest.fixture(scope="module")
def snapshot():
    """A re-activation snapshot with valid, plain-invalid (-1) and
    blacklisted-invalid (-2) pixels."""
    rng = np.random.default_rng(9)
    idepth = rng.uniform(0.2, 2.0, (H, W)).astype(np.float32)
    var = rng.uniform(0.001, 0.05, (H, W)).astype(np.float32)
    u = rng.uniform(size=(H, W))
    var[u < 0.35] = -1.0
    var[u < 0.1] = -2.0
    idepth[var < 0] = 0.0
    validity = np.where(var > 0, rng.uniform(0, 60, (H, W)),
                        0.0).astype(np.float32)
    return idepth, var, validity


def test_set_from_existing_kf_matches_jax(snapshot):
    jcfg = JaxConfig(width=W, height=H)
    jdm = JaxDepthMap(synth.default_camera(W, H), jcfg)
    jdm.set_from_existing_kf(*(jnp.asarray(a) for a in snapshot))
    want = to_dict(jdm.state)
    tdm = DepthMap(Camera(fx=0.7 * W, fy=0.7 * W, cx=(W - 1) / 2.0,
                          cy=(H - 1) / 2.0, width=W, height=H),
                   LSDConfig(width=W, height=H), "cpu")
    tdm.num_mapped_on_this = 3
    tdm.set_from_existing_kf(*interop.reactivation_from_dict(
        dict(zip(("idepth", "var", "validity"), snapshot)), device="cpu"))
    got = np_(tdm.state)
    assert tdm.num_mapped_on_this == 0 and tdm.last_active is None
    for k in ("valid", "blacklisted"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0 < got["valid"].mean() < 1 and (got["blacklisted"] < 0).any()
    for k in ("idepth", "var", "idepth_smoothed", "var_smoothed", "validity",
              "next_min_id"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_reactivation_snapshot_matches_jax(snapshot):
    """The snapshot a finished keyframe keeps, from the same state."""
    jcfg = JaxConfig(width=W, height=H)
    jdm = JaxDepthMap(synth.default_camera(W, H), jcfg)
    jdm.set_from_existing_kf(*(jnp.asarray(a) for a in snapshot))
    tdm = DepthMap(Camera(fx=0.7 * W, fy=0.7 * W, cx=(W - 1) / 2.0,
                          cy=(H - 1) / 2.0, width=W, height=H),
                   LSDConfig(width=W, height=H), "cpu")
    tdm.state = interop.depth_state_from_dict(to_dict(jdm.state),
                                              device="cpu")
    for a, b in zip(tdm.reactivation_snapshot(), jdm.reactivation_snapshot()):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
