"""dataset_slam: run the engine over an image folder.

Port of lsd_slam_tpu/io/runner.py (== main_on_images.cpp):

    python -m lsd_slam_tpu_torch.io.runner files:<dir> calib:<file>
        [hz:0] [out:<dir>] [vo] [dump] [checkpoint:<file>]
        [resume:<file>] [profile:<dir>] [pipeline:<lag>] [device:<dev>]
        [multihost:<rank>:<world>[:<coord_port>[:<chan_port>]]]

The argv grammar, mode selection, outputs and print lines are the JAX
runner's. hz:0 is the deterministic sequential mode (README.md:139);
hz != 0 runs the threaded back-end, pipeline:<lag> the pipelined frame
loop. `device:` (default the CUDA device; `device:cpu` runs on the CPU)
is the port's own; without a CUDA device and without `device:` the runner
stops. `profile:<dir>` synchronises the stage timers and writes a
torch.profiler Chrome trace (`trace.json`) into the directory, where the
JAX runner writes a jax.profiler trace. `multihost:` runs the engine
across processes (`bringup_multihost`): rank 0 runs the dataset with its
candidate search and PGO fanned out, ranks >= 1 serve and print
`multihost worker done`; `device:` applies to every rank. A resumed
system gets no frontend, as in the JAX runner.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time


def parse_args(argv):
    args = {"hz": 0.0, "out": "lsd_out", "vo": False, "dump": False,
            "checkpoint": None, "resume": None, "profile": None,
            "device": None}
    for a in argv:
        if a.startswith("files:"):
            args["files"] = a[6:]
        elif a.startswith("calib:"):
            args["calib"] = a[6:]
        elif a.startswith("hz:"):
            args["hz"] = float(a[3:])
        elif a.startswith("out:"):
            args["out"] = a[4:]
        elif a.startswith("checkpoint:"):
            args["checkpoint"] = a[11:]
        elif a.startswith("resume:"):
            args["resume"] = a[7:]
        elif a.startswith("profile:"):
            # device-truthful profiling: per-stage timers block until the
            # device drains, and a torch.profiler trace lands in the dir
            args["profile"] = a[8:]
        elif a.startswith("multihost:"):
            # multihost:<rank>:<world>[:<coord_port>[:<chan_port>]] — rank
            # 0 runs the dataset with the engine's candidate search and
            # PGO fanned out across processes; ranks >= 1 serve
            args["multihost"] = a[10:]
        elif a.startswith("pipeline:"):
            args["pipeline"] = int(a[9:])
        elif a.startswith("device:"):
            args["device"] = a[7:]
        elif a == "vo":
            args["vo"] = True
        elif a == "dump":
            args["dump"] = True
    return args


def parse_multihost(spec: str):
    """'<rank>:<world>[:<coord_port>[:<chan_port>]]' -> (rank, world,
    coordinator port, channel port); the ports default to 47211 and the
    coordinator's + 1, as in the JAX runner."""
    parts = spec.split(":")
    rank, world = int(parts[0]), int(parts[1])
    coord_port = int(parts[2]) if len(parts) > 2 else 47211
    chan_port = int(parts[3]) if len(parts) > 3 else coord_port + 1
    return rank, world, coord_port, chan_port


def bringup_multihost(spec: str, cam, cfg, device=None,
                      local_device_count=None):
    """Join the process group and the host channel for `spec` (see
    `parse_multihost`) on `device`. Rank 0 returns a MultihostFrontend to
    pass into SlamSystem; the other ranks serve until the frontend stops
    them, then return None (the caller should exit)."""
    from lsd_slam_tpu_torch.parallel import multihost_engine
    from lsd_slam_tpu_torch.parallel.multihost import (HostChannel,
                                                       init_multihost)

    rank, world, coord_port, chan_port = parse_multihost(spec)
    mesh = init_multihost(f"127.0.0.1:{coord_port}", world, rank,
                          local_device_count=local_device_count,
                          device=device)
    channel = HostChannel(rank, world, port=chan_port, timeout=120.0)
    if rank == 0:
        return multihost_engine.MultihostFrontend(channel, cam, cfg, mesh)
    multihost_engine.serve(channel, mesh)
    return None


def run_device(args):
    """The device the run uses: `device:` if given, else the CUDA device;
    without one the runner stops and names `device:cpu`."""
    import torch

    if args["device"] is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass device:cpu to run on "
                         "the CPU explicitly")
    return torch.device(args["device"] or "cuda")


def main(argv=None):
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.io.dataset import ImageFolderSource
    from lsd_slam_tpu_torch.io.trajectory import save_tum_trajectory
    from lsd_slam_tpu_torch.io.output import FileOutput3DWrapper, export_ply

    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = run_device(args)
    src = ImageFolderSource(args["files"], args.get("calib"), device=device)
    cam = src.camera
    if cam is None:
        raise SystemExit("need calib:<file>")

    cfg = LSDConfig(width=cam.width, height=cam.height)
    # hz != 0 selects the async pipeline (tracking thread + mapping thread);
    # hz == 0 is the deterministic sequential mode (README.md:139)
    if args["hz"] != 0.0:
        cfg = cfg.replace(system=dataclasses.replace(cfg.system,
                                                     sequential=False))
    if args["profile"]:
        cfg = cfg.replace(
            system=dataclasses.replace(cfg.system, profile_sync=True))
    if args.get("pipeline"):
        cfg = cfg.replace(system=dataclasses.replace(
            cfg.system, pipeline_lag=args["pipeline"]))
    multihost = None
    if args.get("multihost"):
        multihost = bringup_multihost(args["multihost"], cam, cfg, device)
        if multihost is None:
            print("multihost worker done", flush=True)
            return
    if args["resume"]:
        from lsd_slam_tpu_torch.io.checkpoint import load_system
        system = load_system(args["resume"], cfg,
                             enable_slam=not args["vo"], device=device)
        print(f"resumed from {args['resume']}: "
              f"{len(system.keyframes)} keyframes", flush=True)
    else:
        system = SlamSystem(cam, cfg, enable_slam=not args["vo"],
                            device=device, multihost=multihost)
    out = FileOutput3DWrapper(args["out"], cam=cam)
    system.set_visualization(out)

    profiler = None
    if args["profile"]:
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
        profiler = tp.profile(activities=acts)
        profiler.__enter__()

    t_start = time.time()
    n = 0
    resumed = args["resume"] is not None
    id_offset = (system.trajectory[-1][1] + 1) if resumed else 0
    for i, ts, img in src:
        i = i + id_offset
        if i == 0 and not resumed:
            system.random_init(img, i, ts)
        else:
            pose = system.track_frame(img, i, ts)
            if pose is not None:
                out.publish_tracked_frame(i, ts, pose)
        n += 1
        if n % 30 == 0:
            el = time.time() - t_start
            print(f"frame {n}/{len(src)}  {n/el:.1f} fps  "
                  f"kfs={len(system.keyframes)}", flush=True)

    system.finalize()
    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(args["profile"], exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args["profile"],
                                                  "trace.json"))
        print(f"profiler trace -> {args['profile']}", flush=True)
    if args["checkpoint"]:
        from lsd_slam_tpu_torch.io.checkpoint import save_system
        save_system(args["checkpoint"], system)
        print(f"checkpoint -> {args['checkpoint']}", flush=True)
    if args["dump"]:
        from lsd_slam_tpu_torch.io.dump import dump_map
        dump_map(os.path.join(args["out"], "dump"), system)
    for kf in system.keyframes:
        out.publish_keyframe(kf)
    if system.backend is not None and system.backend._graph is not None:
        out.publish_keyframe_graph(system.keyframes,
                                   system.backend.graph.edges)
    save_tum_trajectory(os.path.join(args["out"], "estimated_poses.txt"),
                        system.trajectory)
    n_pts = export_ply(os.path.join(args["out"], "pointcloud.ply"),
                       system.keyframes, cam)
    out.close()
    el = time.time() - t_start
    print(f"done: {n} frames in {el:.1f}s ({n/el:.1f} fps), "
          f"{len(system.keyframes)} keyframes, {n_pts} points", flush=True)
    print("timing:", system.timers.summary(), flush=True)
    print("stats:", system.stats.format(), flush=True)


if __name__ == "__main__":
    main()
