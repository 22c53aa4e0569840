"""Multi-process runtime: torch.distributed bring-up and the host channel
(torch).

Port of lsd_slam_tpu/parallel/multihost.py. The numeric state of a
multi-process run reduces through `torch.distributed` collectives (the
JAX package's `jax.distributed` runtime), and the irregular graph
bookkeeping (keyframe metadata, edge topology, permaRef clouds) rides a
plain TCP socket channel, `HostChannel`: graph structure is
data-dependent and small.

Components:
  * `init_multihost`  — `torch.distributed.init_process_group` over
                        `tcp://` (idempotent), with the backend picked by a
                        rule (`pick_backend`) and logged;
  * `HostChannel`     — rank-0-rooted broadcast / gather of pickled
                        objects over TCP;
  * `global_mesh`     — the 1-D mesh over every rank's shards, rank-major;
  * `replicated` / `edge_sharded` — a rank's copy of host data that every
                        rank holds, and its shards of it;
  * `multihost_pgo_optimize` — damped-GN pose-graph optimisation over the
                        global mesh: rank 0 broadcasts the edge set, every
                        rank runs the same edge-sharded steps, and rank 0's
                        step is broadcast so that every rank takes the same
                        LM decisions and holds the same poses.

Everything sent over the channel is numpy or plain Python (tensors go to
the host first). Importing this module starts no process group and opens
no socket.
"""

from __future__ import annotations

import datetime
import pickle
import socket
import struct
import time
from typing import Any, List, Optional

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.mapping.pose_graph import poses_to_host
from lsd_slam_tpu_torch.parallel.distributed import (
    Mesh, distributed_pgo_step, run_lm)


# --------------------------------------------------------------------------
# torch.distributed bring-up
# --------------------------------------------------------------------------

# what init_multihost set up: rank, world, backend and this rank's shards
_RUNTIME: dict = {}


def pick_backend(device: torch.device, num_processes: int) -> tuple:
    """(backend, reason): NCCL when every rank has a card of its own, gloo
    on the CPU and when ranks share a card (NCCL refuses two ranks on one
    device). The rule reads the device and the card count; it never tries
    one backend and catches its failure."""
    if device.type != "cuda":
        return "gloo", f"{device.type} tensors"
    n_cards = torch.cuda.device_count()
    if n_cards >= num_processes:
        return "nccl", f"{n_cards} cards for {num_processes} ranks: one each"
    return "gloo", (f"{num_processes} ranks share {n_cards} card(s); NCCL "
                    "refuses two ranks on one device")


# how long a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 600.0


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, local_device_count: Optional[int] = None,
                   backend: Optional[str] = None, device=None) -> Mesh:
    """Join the process group at `coordinator_address` ("host:port", rank 0
    listens there) as rank `process_id` of `num_processes` (idempotent);
    returns the global mesh.

    `device` (default the card) is this rank's device; under NCCL rank r
    takes card r. `local_device_count` gives each rank that many shards of
    its device (virtual shards, for the CPU tests); default one.
    `backend` overrides `pick_backend`."""
    import torch.distributed as dist

    if _RUNTIME:
        return global_mesh()
    dev = resolve_device(device)
    reason = "asked for"
    if backend is None:
        backend, reason = pick_backend(dev, num_processes)
    if backend == "nccl" and dev.index is None:
        dev = torch.device("cuda", process_id)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    _RUNTIME.update(rank=process_id, world=num_processes, backend=backend,
                    devices=[dev] * (local_device_count or 1))
    print(f"[multihost] rank {process_id} of {num_processes}: backend "
          f"{backend} ({reason}), {local_device_count or 1} shard(s) on "
          f"{dev}", flush=True)
    return global_mesh()


def shutdown_multihost() -> None:
    """Leave the process group `init_multihost` joined (no-op without
    one)."""
    import torch.distributed as dist

    if _RUNTIME:
        dist.destroy_process_group()
        _RUNTIME.clear()


# --------------------------------------------------------------------------
# host RPC channel (graph topology / keyframe metadata)
# --------------------------------------------------------------------------

def _send_obj(conn: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(struct.pack("!Q", len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("host channel closed")
        buf += chunk
    return bytes(buf)


def _recv_obj(conn: socket.socket) -> Any:
    (n,) = struct.unpack("!Q", _recv_exact(conn, 8))
    # only the ranks of this run write to the channel
    return pickle.loads(_recv_exact(conn, n))


class HostChannel:
    """Rank-0-rooted TCP object channel between the SLAM processes.

    Rank 0 listens on `port`; ranks 1..N-1 connect. broadcast() sends one
    object from rank 0 to everyone; gather() collects one object per rank
    at rank 0; allgather() = gather + broadcast. Graph topology is
    kilobytes, not a job for device collectives."""

    def __init__(self, rank: int, world: int, host: str = "127.0.0.1",
                 port: int = 49777, timeout: float = 60.0):
        self.rank = rank
        self.world = world
        self._conns: List[socket.socket] = []
        if world == 1:
            return
        if rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((host, port))
                srv.listen(world - 1)
                srv.settimeout(timeout)
                peers = {}
                for _ in range(world - 1):
                    conn, _ = srv.accept()
                    conn.settimeout(None)
                    peers[_recv_obj(conn)] = conn
            finally:
                srv.close()
            self._conns = [peers[r] for r in range(1, world)]
        else:
            deadline = time.time() + timeout
            while True:
                conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    conn.connect((host, port))
                    break
                except OSError:
                    conn.close()
                    if time.time() > deadline:
                        raise
                    time.sleep(0.1)
            _send_obj(conn, rank)
            self._conns = [conn]

    def broadcast(self, obj: Any = None) -> Any:
        if self.world == 1:
            return obj
        if self.rank == 0:
            for c in self._conns:
                _send_obj(c, obj)
            return obj
        return _recv_obj(self._conns[0])

    def gather(self, obj: Any) -> Optional[List[Any]]:
        if self.world == 1:
            return [obj]
        if self.rank == 0:
            return [obj] + [_recv_obj(c) for c in self._conns]
        _send_obj(self._conns[0], obj)
        return None

    def allgather(self, obj: Any) -> List[Any]:
        return self.broadcast(self.gather(obj))

    def barrier(self) -> None:
        self.allgather(None)

    def close(self) -> None:
        for c in self._conns:
            c.close()
        self._conns = []


# --------------------------------------------------------------------------
# global mesh + array placement
# --------------------------------------------------------------------------

def global_mesh() -> Mesh:
    """The 1-D mesh over every shard of every rank, rank-major (JAX's
    `jax.devices()` order); one process without `init_multihost` is a
    world of one on the card."""
    if not _RUNTIME:
        return Mesh([resolve_device(None)])
    return Mesh(_RUNTIME["devices"], rank=_RUNTIME["rank"],
                world=_RUNTIME["world"], backend=_RUNTIME["backend"])


def replicated(mesh: Mesh, x: np.ndarray) -> torch.Tensor:
    """Host data every rank holds -> this rank's copy on the mesh's main
    device."""
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh.main)


def edge_sharded(mesh: Mesh, x: np.ndarray) -> List[torch.Tensor]:
    """Host data every rank holds (the whole edge set, broadcast over the
    host channel) -> this rank's shards of it along axis 0, each on its
    shard's device."""
    return mesh.local_shards(torch.as_tensor(np.ascontiguousarray(x)))


# --------------------------------------------------------------------------
# multi-process pose-graph optimization
# --------------------------------------------------------------------------

def payload_args(mesh: Mesh, payload) -> list:
    """The step arguments (fixed, efrom, eto, meas_inv, info, delta) of a
    graph payload, on the mesh's main device (the steps cut the edges)."""
    return [replicated(mesh, payload["fixed"].astype(bool)),
            replicated(mesh, payload["efrom"].astype(np.int64)),
            replicated(mesh, payload["eto"].astype(np.int64)),
            replicated(mesh, payload["meas_inv"].astype(np.float32)),
            replicated(mesh, payload["info"].astype(np.float32)),
            replicated(mesh, payload["delta"].astype(np.float32))]


def multihost_pgo_optimize(channel: HostChannel, graph_payload=None,
                           num_iterations: int = 10,
                           mesh: Optional[Mesh] = None) -> np.ndarray:
    """Distributed PGO across all processes with the dense step.

    Rank 0 passes `graph_payload` = dict(poses (N, 8) f32, fixed (N,) bool,
    efrom, eto (E,) int, meas_inv (E, 8) f32, info (E, 7, 7) f32, delta
    (E,) f32) with E divisible by the global shard count (pad with
    zero-information self-loops); other ranks pass None. The graph is
    broadcast over the host channel; every rank then runs the same
    edge-sharded GN steps over `mesh` (default `global_mesh()`). Returns the
    optimised poses (N, 8) float64, identical on every rank."""
    payload = channel.broadcast(graph_payload)
    mesh = mesh or global_mesh()
    n = int(payload["poses"].shape[0])
    poses = run_lm(distributed_pgo_step(mesh, n),
                   replicated(mesh, payload["poses"].astype(np.float32)),
                   payload_args(mesh, payload), num_iterations, mesh)
    return poses_to_host(poses)
