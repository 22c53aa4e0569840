"""Write the JAX SLAM references that `chip_smoke.py`'s [slam] and
[slam-loop] phases hold the port to.

Two sequences (`--scene`), each at a pipeline lag (`--lag`, default 0):
- `bench`: 640x480, default LSDConfig() (sequential, SLAM on),
  BenchScene(seed=0) rendered along bench_trajectory(N) by the port's
  `render_realistic(noise_sigma=0)`; written to
  lsd_slam_tpu_torch/reference_data/slam_bench_640x480.json.
- `loop`: 160x128, PlaneScene(seed=13) rendered along loop_trajectory(36)
  by the port's `render`, with the aggressive keyframe settings of
  tests/test_slam_e2e.py's `slam_config()` (the sequence of
  tests/test_torch_slam.py); written to slam_loop_160x128.json there.
With `--lag L` (L > 0) the engine keeps L frames in flight
(`SystemConfig.pipeline_lag`) and the file name gains `_lagL`
(slam_bench_640x480_lag3.json, slam_loop_160x128_lag3.json); the ring is
drained (`block_until_mapped`) before the manual loss and after the lost
frame, so every frame up to N-1 is retired and logged and the loss takes
effect at once, as at lag 0.
Both are rendered on the CPU, so the JAX engine and a CPU check of the port
read the same images. The run: gt_depth_init on frame 0, track_frame for
frames 1..N-1, then a manual tracking loss on a repeat of frame N-1 and the
return leg fed backwards (N-2, N-3, ...) until the relocaliser recovers,
then finalize. The JAX engine runs on the CPU with `use_device_mesh=False`
(one device, as the port); the keyframe ids and their tracking parents, the
edge pairs in insertion order, the loop-closure edges among them (neither
keyframe is the other's parent), the counters, both trajectories and their
ATE go to the file.

    env JAX_PLATFORMS=cpu PYTHONPATH=. timeout 1800 \\
        python tests/make_torch_slam_reference.py [--scene bench|loop]

Run one JAX process at a time; at 640x480 it takes minutes. The run must
track every frame before the loss, finish at least 3 keyframes, re-activate
a keyframe and relocalise, and the loop sequence at lag 0 must add a
loop-closure edge (exit 1 otherwise; at lag 3 its keyframes lie further
apart and close no loop). With --check-port (or --check-jax) it instead runs
the port (or the JAX engine) on the CPU over the same sequence and prints
its differences from the stored reference; --threads sets the port's torch
threads (run the JAX engine under `taskset` to change its thread count)
and --noise-seed scales every image by 1 + 1e-6 * N(0, 1) from that seed,
so that the spread of runs which differ only in rounding can be measured.
--threaded (with --check-port or --check-jax) runs the engine with
`sequential=False` (constraint search and PGO on worker threads, and at
lag 0 the mapping thread), whose graph is not deterministic: it prints the
same differences, for the property checks of chip_smoke.py's
[slam-production] and [slam-threads] phases.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from _torch_slam_scenario import KEYFRAME, nonparent_edges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# N = 130 for the bench: the JAX engine tracks every frame, finishes 9
# keyframes, re-activates 2 and relocalises, and runs that differ only in
# rounding build the same graph. Of the N tried (60-180) those whose graph
# holds a loop-closure edge (120, 140, 150, 160) do not (PERF.md section
# 6). The loop sequence carries the loop closure instead.
SCENES = {
    "bench": dict(file="slam_bench_640x480.json", width=640, height=480,
                  frames=130, scene_seed=0, keyframe={},
                  trajectory="bench_trajectory(n_frames)"),
    "loop": dict(file="slam_loop_160x128.json", width=160, height=128,
                 frames=36, scene_seed=13, keyframe=KEYFRAME,
                 trajectory="loop_trajectory(n_frames)"),
}
# At pipeline_lag=3 the bench's keyframes lie 11 frames apart (8 at lag 0)
# and N = 130 builds another graph when only rounding changes (the port
# with 8 threads adds the loop edge (102, 55)); so does N = 150, while
# N = 100 keeps the JAX graph in every rounding variant (PERF.md
# section 6).
LAG_FRAMES = {("bench", 3): 100}
COUNTERS = ("keyframes_created", "keyframes_reactivated", "relocalized",
            "relocalization_rejected")


def out_path(scene: str, lag: int = 0) -> str:
    name = SCENES[scene]["file"]
    if lag:
        name = name.replace(".json", f"_lag{lag}.json")
    return os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data", name)


def rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def frames(scene: str, n_frames: int, noise_seed: int = 0):
    """(gt w2c poses, images, depth of frame 0) from the port's renderer;
    a non-zero noise_seed scales each image by 1 + 1e-6 * N(0, 1)."""
    from lsd_slam_tpu_torch.utils import synth
    s = SCENES[scene]
    cam = synth.default_camera(s["width"], s["height"])
    if scene == "bench":
        world = synth.BenchScene(seed=s["scene_seed"])
        poses = synth.bench_trajectory(n_frames)
    else:
        world = synth.PlaneScene(seed=s["scene_seed"])
        poses = synth.loop_trajectory(n_frames)
    imgs = []
    for i in range(n_frames):
        if scene == "bench":
            img, dep = synth.render_realistic(world, cam, poses[i],
                                              frame_index=i, noise_sigma=0.0,
                                              device="cpu")
        else:
            img, dep = synth.render(world, cam, poses[i], device="cpu")
        imgs.append(img.numpy())
        if i == 0:
            dep0 = dep.numpy()
    if noise_seed:
        rng = np.random.default_rng(noise_seed)
        imgs = [(im * (1 + 1e-6 * rng.standard_normal(im.shape))).astype(
            np.float32) for im in imgs]
    return poses, imgs, dep0


def drive(sys_, imgs, dep0, n):
    """The scenario; returns the frame index the relocaliser recovered at
    (None if it never did)."""
    sys_.gt_depth_init(imgs[0], dep0, 0, 0.0)
    for i in range(1, n):
        sys_.track_frame(imgs[i], i, i / 30.0)
    sys_.block_until_mapped()   # retire the frames in flight (lag > 0)
    assert sys_.tracking_is_good, "tracking lost before the manual loss"
    sys_.manual_tracking_loss = True
    sys_.track_frame(imgs[n - 1], n, n / 30.0)
    sys_.block_until_mapped()   # retire the lost frame
    recovered = None
    for j, i in enumerate(range(n - 2, n // 2, -1)):
        sys_.track_frame(imgs[i], n + 1 + j, (n + 1 + j) / 30.0)
        if sys_.tracking_is_good:
            recovered = i
            break
    sys_.finalize()
    return recovered


def summary(sys_, poses, n, recovered, counters):
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse
    traj = sys_.trajectory_array()
    opt = sys_.optimized_trajectory_array()
    graph = sys_.backend.graph
    ids = [int(kf.id) for kf in sys_.keyframes]
    parents = [-1 if kf.pose.parent is None else int(kf.pose.parent.frame_id)
               for kf in sys_.keyframes]
    edges = [[int(e.first.id), int(e.second.id)] for e in graph.edges]
    nonparent = [list(e) for e in
                 nonparent_edges(dict(zip(ids, parents)), edges)]
    return dict(
        frame_ids=[int(f) for _, f, _ in sys_.trajectory],
        keyframe_ids=ids, parent_ids=parents, edges=edges,
        nonparent_edges=nonparent,
        counters={k: int(counters.get(k, 0)) for k in COUNTERS},
        recovered_at=recovered, tracking_is_good=bool(sys_.tracking_is_good),
        ate=float(ate_rmse(traj[:n], poses)),
        ate_optimized=float(ate_rmse(opt[:n], poses)),
        trajectory_c2w_sim3=np.asarray(traj, np.float64).tolist(),
        optimized_c2w_sim3=np.asarray(opt, np.float64).tolist())


def config(cfg_cls, kf_cls, scene: str, lag: int = 0,
           threaded: bool = False):
    s = SCENES[scene]
    cfg = cfg_cls(width=s["width"], height=s["height"])
    if s["keyframe"]:
        cfg = cfg.replace(keyframe=kf_cls(**s["keyframe"]))
    return cfg.replace(system=dataclasses.replace(
        cfg.system, pipeline_lag=lag, sequential=not threaded))


def jax_system(scene: str, lag: int = 0, threaded: bool = False):
    os.environ.setdefault("LSD_AOT_CACHE", "0")
    from lsd_slam_tpu.config import KeyframeConfig, LSDConfig
    from lsd_slam_tpu.system import SlamSystem
    from lsd_slam_tpu.utils import synth

    s = SCENES[scene]
    cfg = config(LSDConfig, KeyframeConfig, scene, lag, threaded)
    cfg = cfg.replace(system=dataclasses.replace(cfg.system,
                                                 use_device_mesh=False))
    return SlamSystem(synth.default_camera(s["width"], s["height"]), cfg,
                      enable_slam=True)


def run_jax(scene: str, n: int, lag: int = 0):
    s = SCENES[scene]
    poses, imgs, dep0 = frames(scene, n)
    sys_ = jax_system(scene, lag)
    recovered = drive(sys_, imgs, dep0, n)
    out = dict(scene=scene, n_frames=n, width=s["width"], height=s["height"],
               scene_seed=s["scene_seed"], keyframe_config=s["keyframe"],
               noise_sigma=0.0, trajectory=s["trajectory"], pipeline_lag=lag)
    out.update(summary(sys_, poses, n, recovered, dict(sys_.stats.counters)))
    return out


def check(ref: dict, engine: str, threads: int, noise_seed: int,
          threaded: bool = False):
    import torch
    from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    scene, n = ref["scene"], ref["n_frames"]
    lag = ref.get("pipeline_lag", 0)
    poses, imgs, dep0 = frames(scene, n, noise_seed)
    if engine == "jax":
        sys_ = jax_system(scene, lag, threaded)
        counters = lambda: dict(sys_.stats.counters)  # noqa: E731
    else:
        if threads:
            torch.set_num_threads(threads)
        sys_ = SlamSystem(synth.default_camera(ref["width"], ref["height"]),
                          config(LSDConfig, KeyframeConfig, scene, lag,
                                 threaded), device="cpu")
        counters = sys_.stats.snapshot
    t0 = time.time()
    recovered = drive(sys_, imgs, dep0, n)
    got = summary(sys_, poses, n, recovered, counters())
    out = dict(engine=engine, torch_threads=torch.get_num_threads(),
               noise_seed=noise_seed, pipeline_lag=lag, threaded=threaded,
               seconds=time.time() - t0,
               torch=torch.__version__)
    for key in ("keyframe_ids", "parent_ids", "edges", "nonparent_edges",
                "counters", "recovered_at", "ate", "ate_optimized"):
        out[key] = got[key]
        out["ref_" + key] = ref[key]
    for key in ("trajectory_c2w_sim3", "optimized_c2w_sim3"):
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        if a.shape != b.shape:
            out[key] = f"shape {a.shape} vs reference {b.shape}"
            continue
        out[key + "_max_centre_diff"] = float(
            np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1).max())
        out[key + "_max_rot_diff"] = float(max(
            rotation_angle(x[0:4], y[0:4]) for x, y in zip(a, b)))
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="bench")
    ap.add_argument("--frames", type=int, default=0,
                    help="the frame count (default: the scene's)")
    ap.add_argument("--check-port", action="store_true")
    ap.add_argument("--check-jax", action="store_true")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--noise-seed", type=int, default=0)
    ap.add_argument("--lag", type=int, default=0,
                    help="pipeline_lag of the run (and of the file)")
    ap.add_argument("--threaded", action="store_true",
                    help="with --check-*: run with sequential=False")
    ap.add_argument("--out", help="the reference file to write or check "
                    "(default: the scene's file under reference_data/)")
    args = ap.parse_args()
    out = args.out or out_path(args.scene, args.lag)
    if args.check_port or args.check_jax:
        with open(out) as f:
            check(json.load(f), "jax" if args.check_jax else "port",
                  args.threads, args.noise_seed, args.threaded)
        return 0
    if args.threaded:
        ap.error("--threaded needs --check-port or --check-jax")
    n = (args.frames or LAG_FRAMES.get((args.scene, args.lag))
         or SCENES[args.scene]["frames"])
    ref = run_jax(args.scene, n, args.lag)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(ref, f)
    print(json.dumps({k: v for k, v in ref.items()
                      if not k.endswith("c2w_sim3")}))
    c = ref["counters"]
    ok = (len(ref["keyframe_ids"]) >= 3 and c["keyframes_reactivated"] >= 1
          and c["relocalized"] >= 1
          and (args.scene != "loop" or args.lag or ref["nonparent_edges"]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
