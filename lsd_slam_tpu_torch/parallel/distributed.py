"""Device-mesh primitives for multi-device SLAM (torch).

Port of lsd_slam_tpu/parallel/distributed.py. The JAX package writes its
sharded programs with `shard_map` over a 1-D device mesh on axis "kf":
keyframes and constraint candidates are the data-parallel axis, and the
pose-graph normal equations reduce with `all_gather` / `psum`. Here a
`Mesh` is a tuple of torch devices (the shards of this process, repeats
allowed: `make_mesh(8, "cpu")` stands for JAX's 8 virtual CPU devices,
`make_mesh(4, "cuda")` for four shards on one card), optionally spread
over the ranks of a `torch.distributed` process group (`multihost.
global_mesh`): the global shards are ranks x local shards, rank-major.

The sharded programs are loops over the shards, each running on its own
device, and the collectives are explicit:

  * all_gather: the shards' outputs concatenated in global shard order on
    the first local device (`Mesh.gather`); across ranks one
    `all_gather`, staged through pinned host memory under gloo;
  * psum: the shards' partials summed in global shard order on the first
    local device (`Mesh.reduce`, a left fold of the gathered partials), so
    every rank holds the same bits; the caller copies the sum back to each
    shard's device where a shard needs it.

Every float scatter-add inside a shard goes through
`ops.scatter.ordered_index_add`, whose kernels launch on the shard's own
card (`_on_its_card`).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.mapping.pose_graph import assemble_blocks
from lsd_slam_tpu_torch.mapping.sparse_pgo import (apply_update, edge_blocks,
                                                   pcg_solve)
from lsd_slam_tpu_torch.tracking.quick_tracker import (
    QuickTrackResult, points_to, slice_points)

class Mesh:
    """The port's 1-D mesh over axis "kf".

    `devices` are this process's shards, in order (repeats allowed). Under
    `torch.distributed` (`world` > 1) every rank holds as many shards, and
    global shard `rank * len(devices) + j` is local shard j of `rank`.
    `staged_bytes` counts the bytes the cross-rank collectives copied
    through host memory (gloo), `collectives` the collectives run and
    `collective_secs` the host time spent inside them (the staging copies,
    the device work they wait for and the wait for the other ranks)."""

    def __init__(self, devices: Sequence, rank: int = 0, world: int = 1,
                 backend: Optional[str] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank = int(rank)
        self.world = int(world)
        self.backend = backend
        self.staged_bytes = 0
        self.collectives = 0
        self.collective_secs = 0.0

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count (JAX's `mesh.devices.size`)."""
        return self.world * len(self.devices)

    @property
    def main(self) -> torch.device:
        """Where replicated values live on this rank."""
        return self.devices[0]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, rank={self.rank}, "
                f"world={self.world})")

    # ------------------------------------------------------------ shards

    def shard_rows(self, total: int) -> int:
        if total % self.size:
            raise ValueError(f"{total} rows do not divide over {self.size} "
                             "shards: pad first (pad_to_mesh)")
        return total // self.size

    def local_shards(self, x: torch.Tensor) -> List[torch.Tensor]:
        """This rank's shards of `x` (the whole array, identical on every
        rank) along axis 0, each on its own device (JAX's `P(AXIS)`)."""
        k = self.shard_rows(x.shape[0])
        base = self.rank * self.local_size
        return [x[(base + j) * k:(base + j + 1) * k].to(dev)
                for j, dev in enumerate(self.devices)]

    # ------------------------------------------------------- collectives

    def _all_gather_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """`t` (on `main`, equal shape on every rank) from every rank,
        concatenated along axis 0 in rank order."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        self.collectives += 1
        t0 = time.perf_counter()
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            # gloo moves host memory; stage explicitly, one copy each way
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            outs = [torch.empty_like(host) for _ in range(self.world)]
            dist.all_gather(outs, host)
            self.staged_bytes += host.numel() * host.element_size() * (
                1 + self.world)
            out = torch.cat(outs).to(t.device)
        else:
            outs = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(outs, t)
            out = torch.cat(outs)
        self.collective_secs += time.perf_counter() - t0
        return out

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """all_gather(tiled): this rank's per-shard outputs, and every other
        rank's, concatenated along axis 0 in global shard order on `main`."""
        return self._all_gather_ranks(torch.cat([p.to(self.main)
                                                 for p in parts]))

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """psum: the per-shard partials (of equal shape) summed in global
        shard order, ((s0 + s1) + s2) + ..., on `main`; every rank gets the
        same bits."""
        stacked = self.gather([p.unsqueeze(0) for p in parts])
        acc = stacked[0]
        for s in stacked[1:]:
            acc = acc + s
        return acc

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`src`'s `t` on every rank (staged through host memory under
        gloo)."""
        if self.world == 1:
            return t
        import torch.distributed as dist

        self.collectives += 1
        t0 = time.perf_counter()
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            dist.broadcast(host, src)
            self.staged_bytes += 2 * host.numel() * host.element_size()
            t = host.to(t.device)
        else:
            t = t.clone()
            dist.broadcast(t, src)
        self.collective_secs += time.perf_counter() - t0
        return t


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A one-process mesh of `n_devices` shards on `device` (default the
    card). A CUDA device without an index spreads the shards over the
    local cards in turn (all of them when `n_devices` is None); on one card
    every shard is that card. A CPU mesh repeats the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        n_cards = torch.cuda.device_count()
        n = n_cards if n_devices is None else int(n_devices)
        return Mesh([torch.device("cuda", i % n_cards) for i in range(n)])
    return Mesh([dev] * (1 if n_devices is None else int(n_devices)))


def default_mesh(device=None) -> Optional[Mesh]:
    """The engine's mesh: every local card when there is more than one,
    else None (callers take the single-device paths). It never builds a
    virtual mesh, so a one-card run and every CPU run keep the
    single-device paths. Local only: cross-process programs go through
    parallel/multihost_engine."""
    dev = resolve_device(device)
    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return Mesh([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())])


def pad_to_mesh(n: int, mesh: Optional[Mesh], minimum: int = 4) -> int:
    """Smallest power-of-two multiple of max(minimum, mesh size) >= n: the
    batch bucket, divisible by the mesh."""
    base = max(minimum, mesh.size if mesh is not None else 1)
    b = base
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# distributed pose-graph normal equations
# ---------------------------------------------------------------------------

def _edge_parts(mesh: Mesh, poses, efrom, eto, meas_inv, info, huber_delta):
    """Per local shard: (poses, efrom, eto, meas_inv, info, delta) on the
    shard's device, the edges cut contiguously in global shard order."""
    cols = [mesh.local_shards(a) for a in (efrom, eto, meas_inv, info,
                                           huber_delta)]
    return [(poses.to(dev),) + tuple(c[j] for c in cols)
            for j, dev in enumerate(mesh.devices)]


def distributed_pgo_normal_equations(mesh: Mesh, n_vertices: int):
    """A function assembling H (7N, 7N), g (7N,) and the chi2 sum with the
    edges sharded over the mesh.

    Inputs: poses (N, 8) replicated; edge arrays (E, ...) whole on every
    rank, E divisible by the mesh size (pad with zero-information
    self-loops). Each shard computes the 7x7 blocks of its edges on its own
    device (`sparse_pgo.edge_blocks`); the blocks are gathered in shard
    order, which is the original edge order, and assembled on `main` with
    `pose_graph`'s ordered adds: the result equals the one-device
    `_assemble` of the same graph bit for bit. Gathering O(E * 49) blocks
    rather than reducing the O(N^2 * 49) H is the JAX package's choice."""

    def assemble(poses, efrom, eto, meas_inv, info, huber_delta):
        blocks = [edge_blocks(*p) for p in _edge_parts(
            mesh, poses, efrom, eto, meas_inv, info, huber_delta)]
        AtWA, AtWr, chi2 = (mesh.gather([b[i] for b in blocks])
                            for i in range(3))
        Hd, g = assemble_blocks(AtWA, AtWr, efrom.to(mesh.main),
                                eto.to(mesh.main), n_vertices)
        return Hd, g, torch.sum(chi2)

    return assemble


def distributed_pgo_step(mesh: Mesh, n_vertices: int):
    """One damped GN step on the devices: the sharded assembly, then the
    fixed-vertex mask, the LM damping and an f32 `torch.linalg.solve` on
    `main` (JAX: `jnp.linalg.solve`, replicated), X <- exp(delta) X.
    Returns (new poses, chi2, max |delta|) on `main`."""
    assemble = distributed_pgo_normal_equations(mesh, n_vertices)

    def step(poses, fixed_mask, efrom, eto, meas_inv, info, huber_delta,
             lam: float):
        H, g, chi2 = assemble(poses, efrom, eto, meas_inv, info,
                              huber_delta)
        fixed7 = fixed_mask.to(mesh.main).repeat_interleave(7)
        keep = ~fixed7
        zero = torch.zeros((), dtype=torch.float32, device=mesh.main)
        H = (torch.where(keep[:, None] & keep[None, :], H, zero)
             + torch.diag(fixed7.to(torch.float32)))
        g = torch.where(keep, g, zero)
        H = H + torch.diag(lam * (torch.abs(torch.diagonal(H)) + 1.0))
        delta = torch.linalg.solve(H, -g)
        new_poses = apply_update(poses.to(mesh.main),
                                 delta.reshape(n_vertices, 7))
        return new_poses, chi2, torch.max(torch.abs(delta))

    return step


class _ShardedEdges:
    """`sparse_pgo.pcg_solve`'s cross-shard hook: the edges cut over the
    mesh, and the psum of the per-shard partials (`Mesh.reduce`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def split(self, poses, efrom, eto, meas_inv, info, huber_delta):
        return _edge_parts(self.mesh, poses, efrom, eto, meas_inv, info,
                           huber_delta)

    def reduce(self, partials):
        return self.mesh.reduce(partials)


def distributed_pgo_cg_step(mesh: Mesh, n_vertices: int,
                            max_cg_iters: int = 250):
    """One damped GN step solved matrix-free by block-Jacobi PCG with the
    edges sharded over the mesh: `sparse_pgo.pcg_solve` with a hook that
    splits the edges and sums each shard's g, D, chi2 and matvec partials
    in shard order (the psum). The CG state stays on `main`; each matvec
    copies the search direction to the shards. Fixed budget of
    `max_cg_iters` with the device-side converged mask: no host pull inside
    the loop, and the frozen state equals JAX's early stop. Returns (new
    poses, chi2, max |delta|) on `main`."""
    sharded = _ShardedEdges(mesh)

    def step(poses, fixed_mask, efrom, eto, meas_inv, info, huber_delta,
             lam: float):
        poses = poses.to(mesh.main)
        delta, chi2, _, _ = pcg_solve(
            poses, fixed_mask.to(mesh.main), efrom, eto, meas_inv, info,
            huber_delta, lam, n_vertices, max_cg_iters, shards=sharded)
        return (apply_update(poses, delta), chi2,
                torch.max(torch.abs(delta)))

    return step


def run_lm(step, poses, args, num_iterations: int,
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The host LM loop of the mesh and multi-process PGO (JAX
    `_optimize_mesh`, `multihost_pgo_optimize`, `_spmd_pgo`): reject steps
    with max |delta| > 10 or non-finite, raise lambda when chi2 grows 1.5x,
    stop below 1e-9. Under torch.distributed every rank must run the same
    collectives, so rank 0's step (poses, chi2, dmax) is broadcast and
    every rank decides on it. Returns the poses on the mesh's `main`."""
    lam = 1e-6
    last_chi2 = None
    for _ in range(num_iterations):
        new_poses, chi2, dmax = step(poses, *args, float(np.float32(lam)))
        pack = torch.cat([new_poses.reshape(-1), chi2.reshape(1),
                          dmax.reshape(1)])
        if mesh is not None:
            pack = mesh.broadcast(pack)
        total_chi2, dmax = (float(v) for v in pack[-2:].cpu())  # one pull
        if not math.isfinite(dmax) or dmax > 10.0:
            lam *= 10
            continue
        poses = pack[:-2].reshape(new_poses.shape)
        if last_chi2 is not None and total_chi2 > last_chi2 * 1.5:
            lam *= 10
        else:
            lam = max(lam * 0.3, 1e-8)
        last_chi2 = total_chi2
        if dmax < 1e-9:
            break
    return poses


# ---------------------------------------------------------------------------
# sharded batched coarse tracking (candidate scoring / relocalization)
# ---------------------------------------------------------------------------

def _concat_results(mesh: Mesh, results) -> QuickTrackResult:
    """The shards' results concatenated in shard order on `main`; the host
    pulls of every shard's LM loop are summed into `n_syncs`."""
    fields = ("ref_to_frame", "tracking_good", "diverged", "point_usage",
              "good_count", "bad_count", "residual")
    out = {f: torch.cat([getattr(r, f).to(mesh.main) for r in results])
           for f in fields}
    return QuickTrackResult(**out, n_syncs=sum(r.n_syncs for r in results))


def _check_local(mesh: Mesh):
    if mesh.world != 1:
        raise ValueError("sharded quick tracks run on this process's "
                         "shards: cross-process batches go through "
                         "parallel/multihost_engine")


def sharded_quick_track(mesh: Mesh, quick_tracker):
    """The quick tracker's batched track with the candidate axis split over
    the mesh: shard j tracks its slice of keyframe point sets against the
    same query frame on its own device (`track_batch_pts`), and the lanes
    come back in order."""
    _check_local(mesh)

    def track(refs, frame_quad, inits) -> QuickTrackResult:
        k = mesh.shard_rows(inits.shape[0])
        return _concat_results(mesh, [
            quick_tracker.track_batch_pts(
                points_to(slice_points(refs, j * k, (j + 1) * k), dev),
                frame_quad.to(dev), inits[j * k:(j + 1) * k].to(dev))
            for j, dev in enumerate(mesh.devices)])

    return track


def sharded_quick_track_frames(mesh: Mesh, quick_tracker):
    """The reciprocal direction: one reference point set tracked against a
    mesh-sharded batch of frame quad layouts (`track_batch_frames`)."""
    _check_local(mesh)

    def track(ref_pts, quads, inits) -> QuickTrackResult:
        k = mesh.shard_rows(inits.shape[0])
        return _concat_results(mesh, [
            quick_tracker.track_batch_frames(
                points_to(ref_pts, dev),
                quads[j * k:(j + 1) * k].to(dev),
                inits[j * k:(j + 1) * k].to(dev))
            for j, dev in enumerate(mesh.devices)])

    return track
