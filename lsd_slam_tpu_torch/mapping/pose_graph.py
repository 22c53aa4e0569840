"""Sim(3) pose-graph optimizer, dense path (torch).

Port of lsd_slam_tpu/mapping/pose_graph.py, the g2o replacement
(KeyFrameGraph.cpp:65-80, 324-336; g2oTypeSim3Sophus.h):

  * vertex update:   X <- exp(delta) * X
  * edge error:      r = log(X_from^-1 * X_to * meas^-1)
  * Jacobians:       J_to = Adj(X_from^-1), J_from = -J_to
  * Huber kernel on chi2 with a per-edge delta.

`_assemble` (the 7x7 block products scattered into a dense (7N, 7N)
system) and `_apply_update` run on the device; each iteration pulls H, g
and the total chi2 as one packed tensor, and the damped solve runs in
numpy f64 exactly as in the JAX package: fixed-vertex rows, LM damping,
the `dmax > 10` guard, quaternion renormalisation at the end.

Not ported yet: the matrix-free PCG path above `dense_threshold` vertices
(ROADMAP Queue 1 item 4b, sparse PGO) and the mesh / multi-host paths
(Queue 1 item 8); the port runs on one device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from lsd_slam_tpu_torch import lie, resolve_device
from lsd_slam_tpu_torch.lie import np_sim3 as nps


def _assemble(poses, efrom, eto, meas_inv, info, huber_delta,
              n_vertices: int):
    """GN normal equations: H (7N, 7N), g (7N,) and per-edge chi2."""
    xf = poses[efrom]
    xt = poses[eto]
    xf_inv = lie.sim3_inverse(xf)
    r = lie.sim3_log(lie.sim3_mul(lie.sim3_mul(xf_inv, xt), meas_inv))

    chi2 = torch.einsum("ei,eij,ej->e", r, info, r)
    w = torch.where(chi2 <= huber_delta * huber_delta, torch.ones_like(chi2),
                    huber_delta / torch.sqrt(torch.clamp_min(chi2, 1e-12)))

    A = lie.sim3_adjoint(xf_inv)              # J_to; J_from = -A
    WI = info * w[:, None, None]
    AtW = A.transpose(-1, -2) @ WI
    AtWA = AtW @ A
    AtWr = (AtW @ r.unsqueeze(-1)).squeeze(-1)

    n = n_vertices
    H = torch.zeros((n, n, 7, 7), dtype=torch.float32, device=poses.device)
    H.index_put_((efrom, efrom), AtWA, accumulate=True)
    H.index_put_((eto, eto), AtWA, accumulate=True)
    H.index_put_((efrom, eto), -AtWA, accumulate=True)
    H.index_put_((eto, efrom), -AtWA, accumulate=True)
    g = torch.zeros((n, 7), dtype=torch.float32, device=poses.device)
    g.index_put_((efrom,), -AtWr, accumulate=True)
    g.index_put_((eto,), AtWr, accumulate=True)
    Hd = H.permute(0, 2, 1, 3).reshape(n * 7, n * 7)
    return Hd, g.reshape(-1), chi2


def _apply_update(poses, delta):
    return lie.sim3_mul(lie.sim3_exp(delta), poses)


class PoseGraph:
    """Host-facing graph container with device assembly."""

    dense_threshold = 320

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.poses: List[np.ndarray] = []       # camToWorld Sim3 (8,) f64
        self.fixed: List[bool] = []
        self.e_from: List[int] = []
        self.e_to: List[int] = []
        self.e_meas_inv: List[np.ndarray] = []  # inverse measurement (8,)
        self.e_info: List[np.ndarray] = []      # (7, 7)
        self.e_delta: List[float] = []
        self.chi2_initial = None
        self.chi2_final = None
        self.n_pulls = 0                        # device -> host pulls

    # ------------------------------------------------------------ build

    def add_vertex(self, cam_to_world, fixed: bool = False) -> int:
        self.poses.append(np.asarray(cam_to_world, np.float64))
        self.fixed.append(bool(fixed))
        return len(self.poses) - 1

    def set_vertex(self, idx: int, cam_to_world):
        self.poses[idx] = np.asarray(cam_to_world, np.float64)

    def add_edge(self, first: int, second: int, second_to_first,
                 information, huber_delta: float):
        """EdgeSim3 semantics: from=first, to=second,
        measurement=secondToFirst (KeyFrameGraph.cpp:258-270)."""
        self.e_from.append(first)
        self.e_to.append(second)
        self.e_meas_inv.append(
            nps.sim3_inverse(np.asarray(second_to_first, np.float64)))
        self.e_info.append(np.asarray(information, np.float64))
        self.e_delta.append(float(huber_delta))

    @property
    def n_vertices(self) -> int:
        return len(self.poses)

    @property
    def n_edges(self) -> int:
        return len(self.e_from)

    # ------------------------------------------------------------ optimize

    def optimize(self, num_iterations: int) -> float:
        """Gauss-Newton with diagonal damping; returns the max vertex-pose
        change like optimizationIteration (SlamSystem.cpp:1612-1651)."""
        e = self.n_edges
        n = self.n_vertices
        if n < 2 or e == 0:
            return 0.0
        if n > self.dense_threshold:
            raise NotImplementedError(
                f"pose graphs of more than {self.dense_threshold} vertices "
                "take the sparse PCG solver, which is not ported yet: "
                "ROADMAP Queue 1 item 4b (sparse PGO)")
        dev = self.device
        f32 = torch.float32
        efrom = torch.as_tensor(np.asarray(self.e_from[:e]), device=dev)
        eto = torch.as_tensor(np.asarray(self.e_to[:e]), device=dev)
        meas_inv = torch.as_tensor(np.stack(self.e_meas_inv[:e]), dtype=f32,
                                   device=dev)
        info = torch.as_tensor(np.stack(self.e_info[:e]), dtype=f32,
                               device=dev)
        deltas = torch.as_tensor(np.asarray(self.e_delta[:e]), dtype=f32,
                                 device=dev)
        fixed = np.asarray(self.fixed[:n])
        poses_d = torch.as_tensor(np.stack(self.poses[:n]), dtype=f32,
                                  device=dev)

        lam = 1e-6
        last_chi2 = None
        nn = 7 * n
        for it in range(num_iterations):
            Hd, g, chi2 = _assemble(poses_d, efrom, eto, meas_inv, info,
                                    deltas, n)
            packed = torch.cat([Hd.reshape(-1), g, chi2.sum()[None]])
            host = packed.cpu().numpy().astype(np.float64)  # one pull
            self.n_pulls += 1
            H = host[:nn * nn].reshape(nn, nn)
            gv = host[nn * nn:nn * nn + nn]
            total_chi2 = float(host[-1])
            if it == 0:
                self.chi2_initial = total_chi2
            self.chi2_final = total_chi2

            # fix vertices: zero their rows/cols, identity diagonal
            for i in np.where(fixed)[0]:
                s = slice(7 * i, 7 * i + 7)
                H[s, :] = 0.0
                H[:, s] = 0.0
                H[s, s] = np.eye(7)
                gv[s] = 0.0

            # LM-style diagonal damping for safety on weak connectivity
            H[np.diag_indices_from(H)] += lam * (np.abs(np.diag(H)) + 1.0)
            try:
                delta = np.linalg.solve(H, -gv)
            except np.linalg.LinAlgError:
                lam *= 10
                continue

            dmax = float(np.abs(delta).max())
            if not np.isfinite(dmax) or dmax > 10.0:
                lam *= 10
                continue
            poses_d = _apply_update(poses_d, torch.as_tensor(
                delta.reshape(n, 7), dtype=f32, device=dev))

            if last_chi2 is not None and total_chi2 > last_chi2 * 1.5:
                lam *= 10
            else:
                lam = max(lam * 0.3, 1e-8)
            last_chi2 = total_chi2
            if dmax < 1e-9:
                break

        new_poses = poses_d.cpu().numpy().astype(np.float64)
        self.n_pulls += 1
        new_poses[:, 0:4] /= np.linalg.norm(new_poses[:, 0:4], axis=1,
                                            keepdims=True)
        changes = np.zeros(n)
        for i in range(n):
            if not fixed[i]:
                d = nps.sim3_mul(nps.sim3_inverse(self.poses[i]), new_poses[i])
                changes[i] = nps.sim3_log_norm(d)
                self.poses[i] = new_poses[i]
        return float(changes.max()) if n else 0.0
