"""Sparse Sim(3) pose-graph solver: block-Jacobi preconditioned CG (torch).

Port of lsd_slam_tpu/mapping/sparse_pgo.py, the path `PoseGraph.optimize`
takes above `dense_threshold` vertices: the Gauss-Newton system
H delta = -g is solved without forming H. H's only nonzeros are 7x7 blocks
on the edge pattern, so the matvec H v = sum_e B_e (v_from - v_to),
scattered back to both ends, is two gathers, one batched 7x7 product and
two scatter-adds: O(E) memory instead of O(N^2). The preconditioner is the
diagonal blocks D_i plus the LM damping, inverted once per solve
(`torch.linalg.inv` on the batch, as the JAX package calls
`jnp.linalg.inv`). Fixed vertices are handled by projection: their
residual and search-direction rows are zeroed every iteration and their
preconditioner block is the identity, which equals the dense path's
row/column clearing.

On the card the CG loop stays on the device, as the JAX package's single
`lax.while_loop` does: a fixed budget of `max_iters` iterations with a
device-side mask that freezes x, r, p and rz once |r| / |b| <= tol, which
gives the early stop's result exactly. The host reads nothing inside the
loop: each GN iteration pulls its (chi2, max |delta|, CG iterations,
relative residual) once. Every scatter-add goes through
`ops.scatter.ordered_index_add` (on the card both edge ends are ordered
once per solve, and each pair of adds at `from` and `to` is one call), so
a solve gives the same bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.ops.scatter import ordered_index_add, sort_index


def edge_blocks(poses, efrom, eto, meas_inv, info, huber_delta):
    """Per-edge GN blocks: B_e = J^T W J restricted to the 'to' side
    (J_to = Adj(X_from^-1), J_from = -J_to; g2oTypeSim3Sophus.h:69-85), the
    gradient term A^T W r and the robust chi2."""
    xf_inv = lie.sim3_inverse(poses[efrom])
    r = lie.sim3_log(lie.sim3_mul(lie.sim3_mul(xf_inv, poses[eto]),
                                  meas_inv))
    chi2 = torch.einsum("ei,eij,ej->e", r, info, r)
    w = torch.where(chi2 <= huber_delta * huber_delta, torch.ones_like(chi2),
                    huber_delta / torch.sqrt(torch.clamp_min(chi2, 1e-12)))
    A = lie.sim3_adjoint(xf_inv)
    AtW = A.transpose(-1, -2) @ (info * w[:, None, None])
    return AtW @ A, (AtW @ r.unsqueeze(-1)).squeeze(-1), chi2


def _matvec(blocks, efrom, eto, ends, v):
    """H v without materializing H: per-edge B_e (v_from - v_to) added at
    `from` and subtracted at `to`, in one add over `ends`, the
    `sort_index` of cat([efrom, eto])."""
    t = (blocks @ (v[efrom] - v[eto]).unsqueeze(-1)).squeeze(-1)
    return ordered_index_add(torch.zeros_like(v), ends, torch.cat([t, -t]))


def pcg_solve(poses, fixed_mask, efrom, eto, meas_inv, info, huber_delta,
              lam: float, n_vertices: int, max_iters: int, tol: float = 1e-7):
    """One damped-GN right-hand side solved by block-Jacobi PCG.

    Returns (delta (N, 7), chi2 sum, CG iterations used, relative residual)
    as device tensors."""
    # both edge ends in one order, built once per solve
    ends = sort_index(torch.cat([efrom, eto]), n_vertices)
    blocks, AtWr, chi2 = edge_blocks(poses, efrom, eto, meas_inv, info,
                                     huber_delta)
    free = ~fixed_mask[:, None]                                  # (N, 1)
    zero = torch.zeros((), dtype=torch.float32, device=poses.device)

    g = torch.zeros((n_vertices, 7), dtype=torch.float32,
                    device=poses.device)
    ordered_index_add(g, ends, torch.cat([-AtWr, AtWr]))
    b = torch.where(free, -g, zero)

    # diagonal blocks + LM damping (the dense path's rule)
    D = torch.zeros((n_vertices, 7, 7), dtype=torch.float32,
                    device=poses.device)
    ordered_index_add(D, ends, torch.cat([blocks, blocks]))
    damp = lam * (torch.abs(torch.diagonal(D, dim1=1, dim2=2)) + 1.0)
    D = D + torch.diag_embed(damp)
    eye = torch.eye(7, dtype=torch.float32, device=poses.device).expand_as(D)
    D = torch.where(fixed_mask[:, None, None], eye, D)
    Dinv = torch.linalg.inv(D + 1e-9 * eye)

    def matvec(v):
        v = torch.where(free, v, zero)
        hv = _matvec(blocks, efrom, eto, ends, v) + damp * v
        return torch.where(free, hv, zero)

    def precond(r):
        return torch.where(free, (Dinv @ r.unsqueeze(-1)).squeeze(-1), zero)

    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = torch.sum(r * p)
    bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
    iters = torch.zeros((), dtype=torch.int32, device=poses.device)
    for _ in range(max_iters):
        active = torch.sqrt(torch.sum(r * r)) / bnorm > tol
        hp = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
        r_new = r - alpha * hp
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        iters = iters + active.to(torch.int32)
    rel = torch.sqrt(torch.sum(r * r)) / bnorm
    return x, torch.sum(chi2), iters, rel


def apply_update(poses, delta):
    return lie.sim3_mul(lie.sim3_exp(delta), poses)


def optimize_sparse(graph, num_iterations: int,
                    max_cg_iters: int = 250) -> float:
    """PCG Gauss-Newton iterations over a host-side PoseGraph, with the
    dense path's damping and rollback policy, so callers switch solvers on
    size alone. Returns the max |log| vertex change. Records the CG
    iterations of each GN iteration in `graph.cg_iters` and its host pulls
    in `graph.n_pulls`."""
    # edge count before vertex count: vertices always precede their edges
    e = graph.n_edges
    n = graph.n_vertices
    graph.cg_iters = []
    if n < 2 or e == 0:
        return 0.0
    dev = graph.device
    f32 = torch.float32
    efrom = torch.as_tensor(np.asarray(graph.e_from[:e], np.int64),
                            device=dev)
    eto = torch.as_tensor(np.asarray(graph.e_to[:e], np.int64), device=dev)
    meas_inv = torch.as_tensor(np.stack(graph.e_meas_inv[:e]), dtype=f32,
                               device=dev)
    info = torch.as_tensor(np.stack(graph.e_info[:e]), dtype=f32, device=dev)
    deltas = torch.as_tensor(np.asarray(graph.e_delta[:e]), dtype=f32,
                             device=dev)
    fixed = np.asarray(graph.fixed[:n], bool)
    fixed_d = torch.as_tensor(fixed, device=dev)
    poses_d = torch.as_tensor(np.stack(graph.poses[:n]), dtype=f32,
                              device=dev)

    lam = 1e-6
    last_chi2 = None
    for _ in range(num_iterations):
        delta, chi2, iters, rel = pcg_solve(
            poses_d, fixed_d, efrom, eto, meas_inv, info, deltas,
            float(np.float32(lam)), n, max_cg_iters)
        host = torch.stack([chi2, torch.max(torch.abs(delta)),
                            iters.to(f32), rel]).cpu().numpy()   # one pull
        graph.n_pulls += 1
        graph.cg_iters.append(int(host[2]))
        total_chi2 = float(host[0])
        dmax = float(host[1])
        if not np.isfinite(dmax) or dmax > 10.0:
            lam *= 10
            continue
        poses_d = apply_update(poses_d, delta)
        if last_chi2 is not None and total_chi2 > last_chi2 * 1.5:
            lam *= 10
        else:
            lam = max(lam * 0.3, 1e-8)
        last_chi2 = total_chi2
        if dmax < 1e-9:
            break

    new_poses = poses_d.cpu().numpy().astype(np.float64)
    graph.n_pulls += 1
    new_poses[:, 0:4] /= np.linalg.norm(new_poses[:, 0:4], axis=1,
                                        keepdims=True)
    max_change = 0.0
    for i in range(n):
        if not fixed[i]:
            d = nps.sim3_mul(nps.sim3_inverse(graph.poses[i]), new_poses[i])
            max_change = max(max_change, nps.sim3_log_norm(d))
            graph.poses[i] = new_poses[i]
    return float(max_change)
