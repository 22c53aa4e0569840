"""Sim(3) pose-graph optimizer (torch).

Port of lsd_slam_tpu/mapping/pose_graph.py, the g2o replacement
(KeyFrameGraph.cpp:65-80, 324-336; g2oTypeSim3Sophus.h):

  * vertex update:   X <- exp(delta) * X
  * edge error:      r = log(X_from^-1 * X_to * meas^-1)
  * Jacobians:       J_to = Adj(X_from^-1), J_from = -J_to
  * Huber kernel on chi2 with a per-edge delta.

Up to `dense_threshold` vertices, `_assemble` (the 7x7 edge blocks of
`sparse_pgo.edge_blocks` scattered into a dense (7N, 7N) system through
the order-fixed `ordered_index_add`) and `apply_update` run on the device;
each iteration pulls H, g and the total chi2 as one packed tensor, and the
damped solve runs in numpy f64 exactly as in the JAX package: fixed-vertex
rows, LM damping, the `dmax > 10` guard, quaternion renormalisation at the
end. Above it, `sparse_pgo.optimize_sparse` solves by block-Jacobi PCG on
the device, as the JAX package does.

With a device mesh (`parallel.distributed.Mesh`) and at least
`mesh_min_edges` edges, both paths switch to the edge-sharded programs of
parallel/distributed.py (the dense step at up to 64 padded vertices, the
PCG step above). The gate is closed by default: the port's shards run one
after another, so the mesh is slower than one device at every size
measured (PERF.md), and only a caller that sets `mesh_min_edges` takes
it. With a multi-process frontend (parallel/multihost_engine) and at
least `multihost_min_edges` edges, the graph is shipped to every rank and
solved as one SPMD CG program. Those paths pad vertices to a power of two
of at least 16 (fixed identities) and edges to a power of two of at least
max(16, shard count), rounded up to a multiple of the shard count
(zero-information self-loops on vertex 0); at a power-of-two shard count
that is the JAX package's padding.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.mapping.sparse_pgo import (apply_update, edge_blocks,
                                                   optimize_sparse)
from lsd_slam_tpu_torch.ops.scatter import ordered_index_add
from lsd_slam_tpu_torch.utils.stats import NULL_TIMERS


def assemble_blocks(AtWA, AtWr, efrom, eto, n_vertices: int):
    """The dense H (7N, 7N) and g (7N,) from per-edge blocks, in edge
    order."""
    n = n_vertices
    dev = AtWA.device
    # each add merges the JAX package's consecutive adds, in their order
    H = torch.zeros((n * n, 7, 7), dtype=torch.float32, device=dev)
    ordered_index_add(H, torch.cat([efrom * n + efrom, eto * n + eto,
                                    efrom * n + eto, eto * n + efrom]),
                      torch.cat([AtWA, AtWA, -AtWA, -AtWA]))
    g = torch.zeros((n, 7), dtype=torch.float32, device=dev)
    ordered_index_add(g, torch.cat([efrom, eto]), torch.cat([-AtWr, AtWr]))
    Hd = H.reshape(n, n, 7, 7).permute(0, 2, 1, 3).reshape(n * 7, n * 7)
    return Hd, g.reshape(-1)


def _assemble(poses, efrom, eto, meas_inv, info, huber_delta,
              n_vertices: int):
    """GN normal equations: H (7N, 7N), g (7N,) and per-edge chi2."""
    AtWA, AtWr, chi2 = edge_blocks(poses, efrom, eto, meas_inv, info,
                                   huber_delta)
    Hd, g = assemble_blocks(AtWA, AtWr, efrom, eto, n_vertices)
    return Hd, g, chi2


def poses_to_host(poses: torch.Tensor) -> np.ndarray:
    """(N, 8) f64 numpy poses with the quaternions renormalised in f64."""
    out = poses.cpu().numpy().astype(np.float64)
    out[:, 0:4] /= np.linalg.norm(out[:, 0:4], axis=1, keepdims=True)
    return out


class PoseGraph:
    """Host-facing graph container with device assembly."""

    dense_threshold = 320
    # the edge count from which a mesh step pays. The JAX package's
    # shards run in parallel and cross over at 1024 edges; the port's run
    # one after another and lost to one device at every size measured, so
    # the gate stays closed until they run concurrently. Instance-settable
    # (tests set 0 to reach the collective paths at toy sizes)
    mesh_min_edges = math.inf
    # the JAX package's crossover for the multi-process SPMD PGO, which
    # runs only when the caller started a multi-process run
    multihost_min_edges = 1024

    def __init__(self, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.multihost = None   # MultihostFrontend on multi-process runs
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
        # the engine's StageTimers (KeyFrameGraph sets it): pulls are spans
        self.timers = NULL_TIMERS
        self.cg_iters: List[int] = []           # per GN iteration (sparse)

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

    def _padded_arrays(self, shards: int = 1):
        """Bucket-padded numpy (poses, fixed, efrom, eto, meas_inv, info,
        delta) and nb, the padded vertex count, the edges divisible over
        `shards` shards. Padding vertices are fixed identities; padding
        edges are zero-information self-loops on vertex 0 (their residual,
        blocks and matvec terms are exactly zero)."""
        # the edge count before the vertex count: vertices always precede
        # the edges naming them, so every edge in [:e] points into [:n]
        # even while the constraint thread appends
        e = self.n_edges
        n = self.n_vertices
        nb = 16
        while nb < n:
            nb *= 2
        eb = max(16, shards)
        while eb < e:
            eb *= 2
        eb = -(-eb // shards) * shards
        ident = nps.sim3_identity()
        poses = np.tile(ident, (nb, 1)).astype(np.float32)
        poses[:n] = np.stack(self.poses[:n]).astype(np.float32)
        fixed = np.ones(nb, bool)
        fixed[:n] = self.fixed[:n]
        efrom = np.zeros(eb, np.int64)
        efrom[:e] = self.e_from[:e]
        eto = np.zeros(eb, np.int64)
        eto[:e] = self.e_to[:e]
        meas_inv = np.tile(ident, (eb, 1)).astype(np.float32)
        meas_inv[:e] = np.stack(self.e_meas_inv[:e]).astype(np.float32)
        info = np.zeros((eb, 7, 7), np.float32)
        info[:e] = np.stack(self.e_info[:e]).astype(np.float32)
        delta = np.full(eb, 1e6, np.float32)
        delta[:e] = self.e_delta[:e]
        return nb, dict(poses=poses, fixed=fixed, efrom=efrom, eto=eto,
                        meas_inv=meas_inv, info=info, delta=delta)

    def _take_poses(self, new_poses: np.ndarray) -> float:
        """Store the optimised poses of the free vertices; returns the max
        |log| change."""
        max_change = 0.0
        for i in range(len(new_poses)):
            if not self.fixed[i]:
                d = nps.sim3_mul(nps.sim3_inverse(self.poses[i]),
                                 new_poses[i])
                max_change = max(max_change, nps.sim3_log_norm(d))
                self.poses[i] = new_poses[i]
        return float(max_change)

    def _optimize_multihost(self, num_iterations: int) -> float:
        """Cross-process SPMD PGO: the padded graph is shipped over the
        host channel and every rank runs the edge-sharded CG step on the
        global mesh (parallel/multihost_engine)."""
        n = self.n_vertices
        _, payload = self._padded_arrays(self.multihost.mesh.size)
        return self._take_poses(self.multihost.pgo(payload,
                                                   num_iterations)[:n])

    def _optimize_mesh(self, num_iterations: int) -> float:
        """The damped-GN loop over the edge-sharded distributed step: the
        dense step (replicated f32 solve) up to 64 padded vertices, since
        its assembly scatters the whole (N, N, 7, 7) H on `main`; the
        matrix-free PCG step above."""
        from lsd_slam_tpu_torch.parallel.distributed import (
            distributed_pgo_cg_step, distributed_pgo_step, run_lm)

        n = self.n_vertices
        nb, a = self._padded_arrays(self.mesh.size)
        make = (distributed_pgo_step if nb <= min(64, self.dense_threshold)
                else distributed_pgo_cg_step)
        dev = self.mesh.main
        args = [torch.as_tensor(a[k], device=dev)
                for k in ("fixed", "efrom", "eto", "meas_inv", "info",
                          "delta")]
        poses = run_lm(make(self.mesh, nb),
                       torch.as_tensor(a["poses"], device=dev), args,
                       num_iterations, self.mesh)
        self.n_pulls += 1
        return self._take_poses(poses_to_host(poses)[:n])

    def optimize(self, num_iterations: int) -> float:
        """Gauss-Newton with diagonal damping; returns the max vertex-pose
        change like optimizationIteration (SlamSystem.cpp:1612-1651)."""
        e = self.n_edges
        n = self.n_vertices
        if n < 2 or e == 0:
            return 0.0
        if self.multihost is not None and e >= self.multihost_min_edges:
            return self._optimize_multihost(num_iterations)
        if self.mesh is not None and e >= self.mesh_min_edges:
            return self._optimize_mesh(num_iterations)
        if n > self.dense_threshold:
            return optimize_sparse(self, num_iterations)
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
            with self.timers.span("pull.pgo"):
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
            poses_d = apply_update(poses_d, torch.as_tensor(
                delta.reshape(n, 7), dtype=f32, device=dev))

            if last_chi2 is not None and total_chi2 > last_chi2 * 1.5:
                lam *= 10
            else:
                lam = max(lam * 0.3, 1e-8)
            last_chi2 = total_chi2
            if dmax < 1e-9:
                break

        self.n_pulls += 1
        with self.timers.span("pull.pgo"):
            poses = poses_to_host(poses_d)
        return self._take_poses(poses)
