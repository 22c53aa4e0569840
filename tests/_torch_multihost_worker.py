"""Child processes of tests/test_torch_multihost.py.

    python tests/_torch_multihost_worker.py channel RANK WORLD PORT
    python tests/_torch_multihost_worker.py pgo RANK WORLD COORD CHAN PAYLOAD.npz OUT.npy
    python tests/_torch_multihost_worker.py engine RANK WORLD COORD CHAN FRAMES.npz OUT.npz
    python tests/_torch_multihost_worker.py jax-frames FRAMES.npz

`channel`: the port's HostChannel across WORLD processes (broadcast,
gather, allgather, barrier), each rank checking what it received.
`pgo`: `multihost_pgo_optimize` over gloo, two CPU shards a rank; rank 0
holds the graph and writes the poses. `engine`: the port's engine through
`io.runner.bringup_multihost` (two CPU shards a rank), with the fan-out and
SPMD PGO gates lowered as tests/multihost_engine_worker.py lowers them;
rank 0 runs the sequence in FRAMES.npz and writes its trajectory and
counts, then loses tracking by hand and lets the engine relocalise, each
relocaliser call checked against rank 0 alone, and writes the fan-outs and
PGO calls the engine made through the frontend (read before the worker's
own by-hand fan-out check); rank 1 serves. `jax-frames`: the frames
the JAX package renders (tests/multihost_engine_worker.make_sequence),
written to FRAMES.npz; the JAX engine's run on them is recorded in
lsd_slam_tpu_torch/reference_data/multihost_engine_160x128.json
(tests/make_torch_multihost_reference.py). The port's modes import no
JAX.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# tests/test_torch_slam.py's reason: the port's CPU rounding follows the
# torch thread count, so the engine runs pin it
PORT_THREADS = 2


def channel(rank, world, port):
    from lsd_slam_tpu_torch.parallel.multihost import HostChannel

    chan = HostChannel(rank, world, port=port, timeout=60.0)
    got = chan.broadcast({"graph": np.arange(5)} if rank == 0 else None)
    assert np.array_equal(got["graph"], np.arange(5)), got
    gathered = chan.gather((rank, rank * rank))
    if rank == 0:
        assert gathered == [(r, r * r) for r in range(world)], gathered
    else:
        assert gathered is None
    every = chan.allgather(10 * rank)
    assert every == [10 * r for r in range(world)], every
    chan.barrier()
    chan.close()
    print(f"rank {rank} channel ok", flush=True)


def pgo(rank, world, coord, chan_port, payload_path, out_path):
    from lsd_slam_tpu_torch.parallel.multihost import (
        HostChannel, init_multihost, multihost_pgo_optimize,
        shutdown_multihost)

    mesh = init_multihost(f"127.0.0.1:{coord}", world, rank,
                          local_device_count=2, device="cpu")
    assert mesh.size == 2 * world and mesh.backend == "gloo", mesh
    chan = HostChannel(rank, world, port=chan_port, timeout=120.0)
    payload = dict(np.load(payload_path)) if rank == 0 else None
    poses = multihost_pgo_optimize(chan, payload, num_iterations=12)
    # every rank ends with rank 0's poses
    every = chan.allgather(poses)
    assert all(np.array_equal(p, poses) for p in every)
    if rank == 0:
        np.save(out_path, poses)
    chan.barrier()
    chan.close()
    shutdown_multihost()
    print(f"rank {rank} done", flush=True)


def engine_config():
    from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig

    w, h = 160, 128     # tests/multihost_engine_worker.py's W, H
    return LSDConfig(width=w, height=h).replace(
        keyframe=KeyframeConfig(kf_dist_weight=25.0, kf_usage_weight=6.0,
                                initialization_phase_count=1,
                                min_num_mapped=2))


def engine(rank, world, coord, chan_port, frames_path, out_path):
    import torch

    from lsd_slam_tpu_torch.io import runner
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    torch.set_num_threads(PORT_THREADS)
    cfg = engine_config()
    cam = synth.default_camera(cfg.width, cfg.height)
    frontend = runner.bringup_multihost(
        f"{rank}:{world}:{coord}:{chan_port}", cam, cfg, device="cpu",
        local_device_count=2)
    if frontend is None:
        print(f"rank {rank} done", flush=True)
        return
    seq = np.load(frames_path)
    imgs, deps = seq["imgs"], seq["deps"]
    frontend.min_candidates = 2
    sys_ = SlamSystem(cam, cfg, enable_slam=True, device="cpu",
                      multihost=frontend)
    sys_.backend.graph.pose_graph.multihost_min_edges = 1
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, len(imgs)):
        sys_.track_frame(imgs[i], i, i / 30.0)
    traj = sys_.trajectory_array()
    n_kf = len(sys_.keyframes)
    n_edges = sys_.backend.graph.pose_graph.n_edges
    # the engine's own fan-outs: none from the candidate search on this
    # sequence (three keyframes, no candidate batch of two forms), then
    # the relocaliser's after a manual loss; read before the by-hand
    # batches of fan_out_against_local add theirs
    run_fanouts = frontend.fanouts
    reloc = relocalise_after_loss(sys_, imgs)
    counts = (frontend.fanouts, frontend.pgo_calls)
    fanout_gap = fan_out_against_local(sys_)
    sys_.finalize()     # stops the frontend, releasing rank 1
    np.savez(out_path, traj=traj, n_kf=n_kf, n_edges=n_edges,
             run_fanouts=run_fanouts, fanouts=counts[0],
             pgo_calls=counts[1], reloc=reloc, fanout_gap=fanout_gap)
    print(f"rank 0 done: {n_kf} keyframes, {n_edges} edges, {run_fanouts} "
          f"fan-outs in the run, {counts[0]} with the relocaliser's, "
          f"{counts[1]} SPMD PGO calls", flush=True)


def relocalise_after_loss(sys_, imgs):
    """The engine's relocaliser fanning out on its own: a manual tracking
    loss on the last frame, then the frames fed backwards through
    `track_frame` until tracking recovers, as chip_smoke.py's [slam] does.
    Each relocaliser call runs again on rank 0 alone (the frontend
    detached). Returns [calls, their hits, their fan-outs, quick_syncs
    they bumped, max |init difference| of equal choices, choices all
    equal]."""
    graph = sys_.backend.graph
    frontend = graph.multihost
    relocalize = graph.relocalize
    got = dict(calls=0, hits=0, fanouts=0, syncs=0, gap=0.0, same=True)

    def checked(pyr):
        fanouts = frontend.fanouts
        syncs = sys_.stats.snapshot().get("quick_syncs", 0)
        hit = relocalize(pyr)
        got["fanouts"] += frontend.fanouts - fanouts
        got["syncs"] += sys_.stats.snapshot().get("quick_syncs", 0) - syncs
        graph.multihost = None
        try:
            alone = relocalize(pyr)
        finally:
            graph.multihost = frontend
        got["calls"] += 1
        got["hits"] += hit is not None
        if (hit is None) != (alone is None) or (
                hit is not None and hit[0].id != alone[0].id):
            got["same"] = False
        elif hit is not None:
            got["gap"] = max(got["gap"], float(np.abs(
                np.asarray(hit[1]) - np.asarray(alone[1])).max()))
        return hit

    graph.relocalize = checked
    try:
        n = len(imgs)
        sys_.manual_tracking_loss = True
        sys_.track_frame(imgs[n - 1], n, n / 30.0)
        for j, i in enumerate(range(n - 2, n // 2, -1)):
            sys_.track_frame(imgs[i], n + 1 + j, (n + 1 + j) / 30.0)
            if sys_.tracking_is_good:
                break
    finally:
        del graph.relocalize
    return np.array([got["calls"], got["hits"], got["fanouts"],
                     got["syncs"], got["gap"], float(got["same"])])


def fan_out_against_local(sys_):
    """The keyframe graph's quick-track batches of the last keyframe's
    frame against every keyframe, and of its point set against every
    keyframe's frame, fanned out across the ranks (kf_ids given) and on
    this rank alone: returns (max |ref_to_frame difference|, good flags
    equal) over both directions."""
    graph = sys_.backend.graph
    kfs = sys_.keyframes
    ids = [kf.id for kf in kfs]
    lvl = graph.quick_tracker.level
    inits = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                    (len(ids), 1))
    pts = [graph._permaref[i][0] for i in ids]
    quads = [graph._permaref[i][1] for i in ids]
    quad, ref = kfs[-1].pyr.quad[lvl], graph._permaref[ids[-1]][0]
    gap, same = 0.0, True
    for fanned, local in (
            (graph._batch_track_refs(pts, quad, inits, kf_ids=ids),
             graph._batch_track_refs(pts, quad, inits)),
            (graph._batch_track_frames(ref, quads, inits, kf_ids=ids),
             graph._batch_track_frames(ref, quads, inits))):
        gap = max(gap, float(np.abs(fanned[0] - local[0]).max()))
        same = same and np.array_equal(fanned[1], local[1])
    return np.array([gap, float(same)])


def jax_frames(frames_path):
    from tests.multihost_engine_worker import make_sequence

    _, imgs, deps, _ = make_sequence()
    np.savez(frames_path, imgs=np.stack(imgs), deps=np.stack(deps))
    print("frames written", flush=True)


def main(argv):
    mode, rest = argv[0], argv[1:]
    if mode == "channel":
        channel(*map(int, rest))
    elif mode == "pgo":
        pgo(*map(int, rest[:4]), *rest[4:])
    elif mode == "engine":
        engine(*map(int, rest[:4]), *rest[4:])
    elif mode == "jax-frames":
        jax_frames(*rest)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
