"""Multi-process engine: keyframe-partitioned candidate search and
cross-process PGO driven by the live SlamSystem (torch).

Port of lsd_slam_tpu/parallel/multihost_engine.py. The multi-process build
partitions the permaRef store and the quick-track candidate batches across
processes (each rank tracks a slice of keyframes on its own device), and
runs pose-graph optimisation as one SPMD program over the global mesh.
Graph topology and the small permaRef clouds ride the HostChannel as
numpy; only the PGO state touches `torch.distributed` collectives.

Roles:
  * rank 0 — the FRONTEND: runs the full SlamSystem; its KeyFrameGraph
    calls `quick_refs` / `quick_frames`, which fan candidate slices out to
    every rank (tracking its own slice locally) and gather the results;
    `pgo` runs the SPMD CG step with every rank taking part.
  * ranks 1..N-1 — WORKERS: `serve()` loops on broadcast commands,
    mirrors finished keyframes' permaRefs, answers quick-track slices on
    their own device, and joins the SPMD PGO.

All commands are strictly ordered on the channel; the frontend issues each
under one lock (the constraint and optimisation threads both issue
commands when the engine is threaded).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.mapping.pose_graph import poses_to_host
from lsd_slam_tpu_torch.parallel.distributed import (
    Mesh, distributed_pgo_cg_step, pad_to_mesh, run_lm)
from lsd_slam_tpu_torch.parallel.multihost import (
    HostChannel, global_mesh, payload_args, replicated, shutdown_multihost)
from lsd_slam_tpu_torch.tracking import quick_tracker as qt
from lsd_slam_tpu_torch.tracking.reference import PointSet


def _to_host(x):
    """A tensor or PointSet as numpy, for the channel."""
    if isinstance(x, PointSet):
        return {f: getattr(x, f).cpu().numpy() for f in qt.POINT_FIELDS}
    return x.cpu().numpy()


def _to_device(x, device):
    if isinstance(x, dict):
        return PointSet(**{f: torch.as_tensor(v, device=device)
                           for f, v in x.items()})
    return torch.as_tensor(x, device=device)


def _round_robin(n: int, world: int) -> List[List[int]]:
    """Deterministic candidate partition: index i -> rank i % world."""
    out: List[List[int]] = [[] for _ in range(world)]
    for i in range(n):
        out[i % world].append(i)
    return out


class _QuickBackend:
    """Per-process quick-track executor over a mirrored permaRef store."""

    def __init__(self, cam, cfg, device):
        self.device = torch.device(device)
        self.qt = qt.QuickTracker(cam, cfg.tracker,
                                  sigma2=cfg.mapping.camera_pixel_noise2)
        self.permaref: Dict[int, tuple] = {}  # kf_id -> (pts, quad)

    def add_kf(self, kf_id: int, pts_host, quad_host):
        self.permaref[kf_id] = (_to_device(pts_host, self.device),
                                _to_device(quad_host, self.device))

    def _inits(self, inits, n, b):
        ident = nps.se3_identity().astype(np.float32)
        return torch.as_tensor(np.concatenate(
            [np.asarray(inits, np.float32).reshape(n, 7),
             np.tile(ident, (b - n, 1))]), device=self.device)

    def _reply(self, res, n):
        """One packed pull: (ref_to_frame, good, usage, good_count,
        bad_count) as numpy, cut to the n real lanes, and the LM loop's
        host syncs."""
        arr = qt.pack_result(res).cpu().numpy()[:n]
        return ((arr[:, 0:7], arr[:, 7] > 0.5, arr[:, 8], arr[:, 9],
                 arr[:, 10]), res.n_syncs + 1)

    def quick_refs(self, frame_quad_host, ids: List[int], inits):
        """Track the shipped frame against this rank's slice of keyframe
        point sets; returns (host arrays ordered like ids, syncs)."""
        if not ids:
            return None
        n = len(ids)
        b = pad_to_mesh(n, None)
        pts = [self.permaref[i][0] for i in ids]
        refs = qt.stack_points(pts + [qt.zeros_like_points(pts[0])]
                               * (b - n))
        res = self.qt.track_batch_pts(
            refs, _to_device(frame_quad_host, self.device),
            self._inits(inits, n, b))
        return self._reply(res, n)

    def quick_frames(self, ref_pts_host, ids: List[int], inits):
        """Reciprocal direction: ONE shipped reference point set tracked
        against this rank's slice of keyframe frame quads."""
        if not ids:
            return None
        n = len(ids)
        b = pad_to_mesh(n, None)
        quads = [self.permaref[i][1] for i in ids]
        res = self.qt.track_batch_frames(
            _to_device(ref_pts_host, self.device),
            torch.stack(quads + [torch.zeros_like(quads[0])] * (b - n)),
            self._inits(inits, n, b))
        return self._reply(res, n)


def _spmd_pgo(payload, num_iterations: int, mesh: Mesh) -> np.ndarray:
    """The SPMD body every rank runs for a `pgo` command: the edge-sharded
    CG step over the global mesh, rank 0's steps broadcast."""
    n = int(payload["poses"].shape[0])
    poses = run_lm(distributed_pgo_cg_step(mesh, n),
                   replicated(mesh, payload["poses"].astype(np.float32)),
                   payload_args(mesh, payload), num_iterations, mesh)
    return poses_to_host(poses)


class MultihostFrontend:
    """Rank-0 handle the engine talks to (None on single-process runs).
    `fanouts` counts the quick-track batches sent to every rank,
    `pgo_calls` the SPMD PGO programs and `pgo_secs` their host time on
    this rank."""

    # a fan-out only pays once every rank gets a couple of lanes
    min_candidates = 4

    def __init__(self, channel: HostChannel, cam, cfg,
                 mesh: Optional[Mesh] = None):
        self.channel = channel
        self.world = channel.world
        self.mesh = mesh or global_mesh()
        self.backend = _QuickBackend(cam, cfg, self.mesh.main)
        self.fanouts = 0
        self.pgo_calls = 0
        self.pgo_secs = 0.0
        self._lock = threading.Lock()
        # workers build their QuickTracker from the same (cam, cfg)
        with self._lock:
            self.channel.broadcast(("hello", cam, cfg))

    # ---------------------------------------------------------- commands

    def add_kf(self, kf_id: int, pts, quad):
        """Mirror a finished keyframe's permaRef on every rank."""
        pts_h, quad_h = _to_host(pts), _to_host(quad)
        with self._lock:
            self.channel.broadcast(("add_kf", kf_id, pts_h, quad_h))
            self.backend.add_kf(kf_id, pts_h, quad_h)

    def has_kf(self, kf_id: int) -> bool:
        return kf_id in self.backend.permaref

    def quick_refs(self, frame_quad, kf_ids: List[int], inits: np.ndarray):
        """Keyframe-partitioned quick track: the frame against kf_ids'
        point sets. Returns ((ref_to_frame, good, usage, good_count,
        bad_count), host syncs of every rank)."""
        return self._fanout("quick_refs", _to_host(frame_quad), kf_ids,
                            inits)

    def quick_frames(self, ref_pts, kf_ids: List[int], inits: np.ndarray):
        return self._fanout("quick_frames", _to_host(ref_pts), kf_ids,
                            inits)

    def _fanout(self, cmd: str, shipped, kf_ids: List[int], inits):
        n = len(kf_ids)
        inits = np.asarray(inits, np.float32)
        parts = _round_robin(n, self.world)
        with self._lock:
            self.channel.broadcast((
                cmd, shipped, [[kf_ids[i] for i in p] for p in parts],
                [inits[p] for p in parts]))
            mine = getattr(self.backend, cmd)(
                shipped, [kf_ids[i] for i in parts[0]], inits[parts[0]])
            replies = self.channel.gather(mine)
            self.fanouts += 1
        # reassemble into the original candidate order
        outs = [None] * n
        syncs = 0
        for part, reply in zip(parts, replies):
            if not part:
                continue
            arrays, s = reply
            syncs += s
            for j, i in enumerate(part):
                outs[i] = tuple(a[j] for a in arrays)
        return tuple(np.stack([o[k] for o in outs])
                     for k in range(len(outs[0]))), syncs

    def pgo(self, payload, num_iterations: int = 10) -> np.ndarray:
        """Pose-graph optimisation as ONE SPMD program over the global
        mesh: every rank takes part."""
        with self._lock:
            self.channel.broadcast(("pgo", payload, num_iterations))
            self.pgo_calls += 1
            t0 = time.perf_counter()
            poses = _spmd_pgo(payload, num_iterations, self.mesh)
            self.pgo_secs += time.perf_counter() - t0
            return poses

    def stop(self):
        with self._lock:
            self.channel.broadcast(("stop",))
            self.channel.barrier()
            self.channel.close()
        shutdown_multihost()


def serve(channel: HostChannel, mesh: Optional[Mesh] = None) -> dict:
    """Worker loop for ranks >= 1: answer engine commands until 'stop'.
    Returns how many of each command it served."""
    mesh = mesh or global_mesh()
    backend: Optional[_QuickBackend] = None
    served: Dict[str, int] = {}
    while True:
        msg = channel.broadcast(None)
        cmd = msg[0]
        served[cmd] = served.get(cmd, 0) + 1
        if cmd == "stop":
            channel.barrier()
            channel.close()
            shutdown_multihost()
            return served
        if cmd == "hello":
            backend = _QuickBackend(msg[1], msg[2], mesh.main)
        elif cmd == "add_kf":
            backend.add_kf(msg[1], msg[2], msg[3])
        elif cmd in ("quick_refs", "quick_frames"):
            _, shipped, id_parts, init_parts = msg
            rank = channel.rank
            channel.gather(getattr(backend, cmd)(shipped, id_parts[rank],
                                                 init_parts[rank]))
        elif cmd == "pgo":
            _spmd_pgo(msg[1], msg[2], mesh)
        else:
            raise RuntimeError(f"unknown multihost command {cmd!r}")
