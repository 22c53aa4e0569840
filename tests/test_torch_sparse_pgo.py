"""The port's sparse PGO (`mapping/sparse_pgo.py`) against the JAX package's
on the CPU, on the graphs of tests/test_pose_graph.py.

Bounds:
  * `edge_blocks`: blocks, gradient terms and chi2 within 1e-5 of the
    largest entry (both f32; XLA contracts and orders the 7x7 sums
    differently from torch's matmuls);
  * one `pcg_solve`: delta within 1e-4 of max |delta|, chi2 within 1e-5
    relative, the CG iteration count within 10% (the last iterations
    creep to tol = 1e-7 near f32's floor, so their count follows the
    rounding; 57 against JAX's 54 here);
  * `optimize_sparse` (12 vertices, 20 GN iterations) and
    `PoseGraph.optimize` (340 vertices, 12): every vertex within POSE_TOL
    (|log| of the relative Sim(3)) of the JAX solve, and the port's
    result passes the JAX test's own ground-truth bounds (5e-3 on the
    small graph, where the port's sparse result is also within 2e-3 of its
    dense one; 8e-3 on the large one).
The fixed-budget CG loop with a device-side converged mask gives the early
stop's result: the same bits as a budget that ends where CG converged.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.lie import np_sim3 as nps
from lsd_slam_tpu.mapping import sparse_pgo as jsp
from lsd_slam_tpu.mapping.pose_graph import PoseGraph as JaxPoseGraph

from lsd_slam_tpu_torch.mapping import sparse_pgo as tsp
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph

POSE_TOL = 1e-4


def circle(n, radius=2.0):
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        q = np.array([np.cos(a / 2), 0, np.sin(a / 2), 0])
        t = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))])
        poses.append(np.concatenate([q, t, [1.0]]))
    return poses


def rel(a, b):
    return nps.sim3_mul(nps.sim3_inverse(a), b)


def perturbed(gt, seed, sigma):
    """gt with every vertex but the first perturbed by exp(N(0, sigma)) on
    its six motion coordinates (JAX's f32 exp, as the JAX test does)."""
    rng = np.random.default_rng(seed)
    out = [gt[0]]
    for p in gt[1:]:
        noise = np.concatenate([rng.normal(0, sigma, 6), [0.0]])
        pert = np.asarray(jlie.sim3_exp(jnp.asarray(noise, jnp.float32)),
                          np.float64)
        out.append(nps.sim3_mul(pert, p))
    return out


def small_graph():
    """tests/test_pose_graph.py::test_sparse_pcg_matches_dense."""
    gt = circle(12)
    info = np.eye(7) * 100
    edges = [(i, i + 1) for i in range(11)] + [(0, 11), (2, 9)]
    return perturbed(gt, 3, 0.02), [(a, b, rel(gt[a], gt[b]), info, 1e6)
                                    for a, b in edges], gt


def large_graph():
    """tests/test_pose_graph.py::test_large_graph_routes_to_sparse_and_
    converges: 340 vertices, the loop closure and mid-loop closures."""
    n = 340
    gt = circle(n)
    info = np.eye(7) * 100
    edges = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)] + [
        (a, a + 11) for a in range(0, n - 20, 17)]
    return perturbed(gt, 7, 0.01), [(a, b, rel(gt[a], gt[b]), info, 1e6)
                                    for a, b in edges], gt


def build(graph, verts, edges):
    for i, p in enumerate(verts):
        graph.add_vertex(p, fixed=(i == 0))
    for e in edges:
        graph.add_edge(*e)
    return graph


def log_dist(a, b):
    return nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(a), b))


def device_arrays(verts, edges):
    """(poses, fixed, efrom, eto, meas_inv, info, delta) as f32 numpy."""
    g = build(JaxPoseGraph(), verts, edges)
    return (np.stack(g.poses).astype(np.float32), np.asarray(g.fixed),
            np.asarray(g.e_from, np.int64), np.asarray(g.e_to, np.int64),
            np.stack(g.e_meas_inv).astype(np.float32),
            np.stack(g.e_info).astype(np.float32),
            np.asarray(g.e_delta, np.float32))


def _close(got, want, rel_tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel_tol * scale, (
        np.abs(got - want).max(), scale)


def test_edge_blocks_match_jax():
    verts, edges, _ = small_graph()
    poses, _, ef, et, meas, info, delta = device_arrays(verts, edges)
    want = jsp.edge_blocks(jnp.asarray(poses), jnp.asarray(ef, jnp.int32),
                           jnp.asarray(et, jnp.int32), jnp.asarray(meas),
                           jnp.asarray(info), jnp.asarray(delta))
    got = tsp.edge_blocks(*(torch.as_tensor(a) for a in (poses, ef, et, meas,
                                                         info, delta)))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 1e-5)


@pytest.fixture(scope="module")
def one_solve():
    verts, edges, _ = small_graph()
    poses, fixed, ef, et, meas, info, delta = device_arrays(verts, edges)
    want = jsp.pcg_solve(jnp.asarray(poses), jnp.asarray(fixed),
                         jnp.asarray(ef, jnp.int32), jnp.asarray(et, jnp.int32),
                         jnp.asarray(meas), jnp.asarray(info),
                         jnp.asarray(delta), jnp.float32(1e-6), len(verts),
                         250)
    args = [torch.as_tensor(a) for a in (poses, fixed, ef, et, meas, info,
                                         delta)]
    return want, args, len(verts)


def test_pcg_solve_matches_jax(one_solve):
    want, args, n = one_solve
    x, chi2, iters, rel_res = tsp.pcg_solve(*args, 1e-6, n, 250)
    _close(x.numpy(), np.asarray(want[0]), 1e-4)
    np.testing.assert_allclose(float(chi2), float(want[1]), rtol=1e-5)
    assert abs(int(iters) - int(want[2])) <= 0.1 * int(want[2]), (
        int(iters), int(want[2]))
    assert float(rel_res) <= 1e-7 and float(want[3]) <= 1e-7


def test_converged_mask_gives_the_early_stop(one_solve):
    """The converged mask freezes the state: the whole 250-iteration
    budget gives the bits of a budget that ends at the iteration where CG
    converged, and a budget one short of it has not converged."""
    _, args, n = one_solve
    full = tsp.pcg_solve(*args, 1e-6, n, 250)
    k = int(full[2])
    assert 0 < k < 250
    stop = tsp.pcg_solve(*args, 1e-6, n, k)
    assert torch.equal(full[0], stop[0]) and int(stop[2]) == k
    assert torch.equal(full[3], stop[3])
    short = tsp.pcg_solve(*args, 1e-6, n, k - 1)
    assert float(short[3]) > 1e-7


def test_optimize_sparse_matches_jax():
    verts, edges, gt = small_graph()
    jg = build(JaxPoseGraph(), verts, edges)
    tg = build(PoseGraph(device="cpu"), verts, edges)
    dense = build(PoseGraph(device="cpu"), verts, edges)
    want = jsp.optimize_sparse(jg, 20)
    got = tsp.optimize_sparse(tg, 20)
    dense.optimize(20)
    assert abs(got - want) <= POSE_TOL
    assert tg.cg_iters and max(tg.cg_iters) <= 250
    for i in range(len(verts)):
        assert log_dist(tg.poses[i], jg.poses[i]) <= POSE_TOL, i
        assert log_dist(tg.poses[i], dense.poses[i]) < 2e-3, i
        assert log_dist(tg.poses[i], gt[i]) < 5e-3, i


def test_large_graph_routes_to_sparse_and_matches_jax():
    verts, edges, gt = large_graph()
    assert len(verts) > PoseGraph.dense_threshold
    jg = build(JaxPoseGraph(), verts, edges)
    tg = build(PoseGraph(device="cpu"), verts, edges)
    want = jg.optimize(12)
    got = tg.optimize(12)
    assert tg.cg_iters, "the dense path ran"
    # one pull per GN iteration and one of the poses: none inside the CG
    assert tg.n_pulls == len(tg.cg_iters) + 1
    assert abs(got - want) <= POSE_TOL
    errs = [log_dist(p, g) for p, g in zip(tg.poses, gt)]
    assert max(errs) < 8e-3, max(errs)
    worst = max(log_dist(a, b) for a, b in zip(tg.poses, jg.poses))
    assert worst <= POSE_TOL, worst
