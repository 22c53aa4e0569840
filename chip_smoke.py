#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lsd_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (13, 14 and 16 run right after 3, 15 after 10); any failure
raises, so the script exits non-zero and prints no ok line:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel of the port, from the sources in the
               checkout (one nvcc per source, all started together);
  3. kernels — each kernel entry (the stencil's accumulators and the fused
               regularize) against its plain PyTorch version on the card, at
               the main path's shape and at ragged ones, var = 0 at invalid
               pixels, both remove_occlusions values, within the stated
               tolerance; then CUDA-event timings of kernel and plain, with
               the inputs L2-warm and rotated over more than 50 MB (cold),
               and the host microseconds per regularize() call, fused
               against the unfused path (accumulators + torch epilogue);
               the checks run at the config's diff_fac (1) and at 2;
               then [scatter]: the order-fixed scatter-sum
               (`ops.scatter.ordered_index_add`: the `segment_order`
               kernels, then the `segment_sum` fold) at the main path's
               shapes (1e5 sources into 1e3 targets, propagate's pass 2 at
               640x480, the PGO's 7x7 blocks, the appearance descriptor's
               histograms and tile sums for an add and a query), on every
               case twice: the order equals torch.sort(stable=True)'s, the
               sums in both regimes of the fold equal the CPU's
               `index_add_` bit for bit, and both kernels their plain
               versions; CUDA-event times in turns of the order + fold,
               the fold in each regime, the order, torch.sort and the
               atomic `index_add_` at propagate's and the appearance
               shapes, beside their bounds; a target out of range fails
               the count kernel's device-side assert (in a child process);
  4. VO      — the sequential visual-odometry loop at 640x480 (default
               LSDConfig(), PlaneScene(seed=7), the orbit trajectory of the
               stored JAX reference), gt_depth_init, track_frame for N-1
               frames, finalize, on the card through SlamSystem's defaults;
               the kernel launch counters are zeroed just before and read
               just after. Checks: tracking good, >= 1 keyframe switch,
               >= N + switches fused launches, no accumulators launch and
               no plain-version call, ATE < 0.01, and the trajectory within
               TRAJ_BOUND of the JAX reference frame by frame. A second,
               profiled pass (stage timers synchronised) gives the per-stage
               breakdown, and a third runs under torch.profiler. The fused
               entry is also timed on the loop's final state.
  5. SLAM    — sequential SLAM at 640x480 (default LSDConfig(), SLAM on)
               on BenchScene(seed=0) along bench_trajectory(N), rendered on
               the card by render_realistic(noise_sigma=0): gt_depth_init,
               track_frame for N-1 frames, a manual tracking loss and the
               return leg fed backwards until the relocaliser recovers,
               finalize (the scenario of tests/make_torch_slam_reference.py,
               whose JAX run is stored in
               lsd_slam_tpu_torch/reference_data/slam_bench_640x480.json).
               Counters zeroed just before, read just after. Checks: the
               same keyframe ids and tracking parents, edge pairs (in
               order), loop-closure edges, counters and recovery frame as
               the reference, both trajectories within the bounds of
               SLAM_RUNS frame by frame, both ATEs within SLAM_ATE_RATIO of
               the reference's, fused launches on the path and no
               plain-version call. Prints frame p50/p95, the
               keyframe-switch ms, the constraint-search ms per new
               keyframe, PGO ms, host syncs per frame, and, from a second
               pass under torch.profiler, the device busy share and the
               top kernels; the fused entry is checked on its final state.
               The second pass must build the same graph and give the
               first pass's trajectories bit for bit (BIT_EQUAL_RUNS).
  6. SLAM loop — the same scenario and checks at 160x128 on the 36-frame
               out-and-back loop of tests/test_torch_slam.py
               (PlaneScene(seed=13), loop_trajectory(36), the aggressive
               keyframe settings of its reference), whose graph holds a
               loop-closure edge: the 640x480 run's does not (see
               tests/make_torch_slam_reference.py); reference
               lsd_slam_tpu_torch/reference_data/slam_loop_160x128.json.
  7. observe-multi — DepthMap.update_keyframe_multi (the multi-reference
               sweep of the mapping thread) at 640x480 on BenchScene(seed=0):
               a keyframe with its ground-truth depth and a per-pixel
               next_min_id from a seed, K = 1, 3, 8 and 10 tracked frames
               (10 maps as two chunks), on the card and on the CPU port
               from the same inputs. Check (tests/test_observe_multi.py's
               bound): every state field within 1e-5 except where an EPL
               decision or the next_min_id dither flips, on at most
               max(16, 1%) of the pixels, a dither flip by at most a
               step; fused launches in every K.
  8. SLAM pipelined — [slam]'s scenario at pipeline_lag=3 (sequential):
               frames stay in flight, the ring is drained before the loss
               and after the lost frame; held to
               lsd_slam_tpu_torch/reference_data/slam_bench_640x480_lag3.json
               as [slam] is to its reference (bounds in SLAM_RUNS). Frames
               are not synchronised one by one; a profiler pass gives the
               device busy share.
  9. SLAM production — the same at pipeline_lag=3, sequential=False
               (constraint search and PGO on worker threads), not
               deterministic, so held to properties: tracking good, every
               frame retired once, keyframes within 2 of the lag-3
               reference's, n_edges >= keyframes - 1, ATE < max(2x the
               reference's, 0.02) (tests/test_slam_e2e.py:246).
 10. SLAM threads — [slam-loop]'s scenario with sequential=False at lag 0
               (the mapping thread drains tracked frames in multi-reference
               sweeps; constraint search with the idle re-track densifier
               and PGO on their threads), free-running: tracking good,
               n_edges >= keyframes - 1, ATE < 0.03
               (tests/test_slam_e2e.py:134).
 11. undistort — camera/undistort.py at 640x480 in and out, the FOV
               parameters [0.7, 0.9333, 0.5, 0.5, 0.9] (crop and full) and
               the OpenCV ones [0.7, 0.9333, 0.5, 0.5, -0.2, 0.05, 0, 0]
               (crop): the card's remap of a seeded image against the CPU
               port's on the same image and tables, within UNDISTORT_ATOL,
               the valid mask exact; CUDA-event ms per frame and host us
               per call.
 12. cli     — the dataset runner as a user runs it, at 640x480, SLAM on:
               the first CLI_FRAMES frames of [slam]'s sequence
               (bench_trajectory(130), BenchScene(seed=0),
               render_realistic(noise_sigma=0)) written as PNG with
               adaptive row filters (`png_adaptive`, libpng's heuristic:
               nearly every row Paeth), an identity calibration (FOV omega
               0, `none`). The folder is decoded on the host one file at a
               time and as the runner reads it (ms per frame of each; both
               equal the frames written). Then the runner's entry,
               `io.runner.main(["files:...", "calib:...", "out:..."])`
               (hz:0), in a fresh process through `--counted-runner`, which
               zeroes the launch counters just before and prints them just
               after; and the same folder in this process through
               ImageFolderSource + SlamSystem (random_init, track_frame,
               finalize). Checks: every output of the runner exists and
               parses (estimated_poses.txt with a line per frame, a
               kf_*.npz per keyframe with finite idepth, poses.jsonl,
               graph.jsonl, pointcloud.ply whose header count is the number
               of points it holds, > 0); >= 2 keyframes; the runner's
               keyframe ids and edge pairs equal the in-process run's, and
               its TUM rows (estimated_poses.txt, after finalize's PGO) lie
               within 1e-6 (the file's 6 decimals) of the in-process
               trajectory. Then
               `checkpoint:` on frames 0-29 and `resume:` on a folder of
               frames 30-59 (the trajectory grows to every frame, tracked),
               and `hz:30 pipeline:3` on the whole folder (every frame
               once, unique edges >= keyframes - 1). Every runner run
               launches the fused kernel, never the accumulators entry, and
               calls no plain version; its counts are the `cli_launches` of
               the kernels line and part of its `launches`. Prints each
               run's fps from its `done:` line. The hz:0 runner's published
               poses (poses.jsonl, full precision) must equal what
               track_frame returns in the in-process run, bit for bit.
 13. pgo-sparse — PoseGraph.optimize(12) above dense_threshold (the
               block-Jacobi PCG of mapping/sparse_pgo.py) on the circle
               graphs of tests/test_pose_graph.py:171 at 340 and 1000
               vertices, on the card and the CPU port: within 8e-3 of the
               ground truth, within PGO_GAP of the CPU port, one pull per GN
               iteration and one of the poses, none inside the CG loop; ms
               per solve and per GN iteration, CG iterations.
 14. appearance — the appearance descriptor of a 640x480 frame (level 2,
               16 rolls), card against the CPU port within APPEARANCE_ATOL;
               an index of 1000 keyframes on the card: ms per add and per
               query, and a 180-degree-rolled revisit retrieves its place;
               then SlamSystem(use_fabmap=True)'s find_candidates at
               640x480 on six keyframes chained by constraints: a query
               whose pose drifted away gets no Euclidean candidate, and the
               appearance hit plus its two graph neighbours, on the card as
               on the CPU port.
 15. slam-fabmap — [slam]'s scenario with `use_fabmap=True` through
               SlamSystem, against
               lsd_slam_tpu_torch/reference_data/slam_bench_640x480_fabmap.json
               with [slam]'s checks and bounds; the index holds every
               keyframe and the constraint search queried it.
 16. warmup  — two fresh processes (`--warmup-run without|with`): a new
               640x480 engine's gt_depth_init and first frame steps, with
               and without `warmup(cam, cfg)` before it; warm-up's report
               and its kernel launches.
A worker thread's failure is re-raised by the engine (WorkerError), so it
fails the run.
Then a `{"kernels": [...]}` line, the card line, and the ok line last.

    python3 chip_smoke.py --baseline-cu OLD.cu

also builds OLD.cu (an earlier version of csrc/regularize_stencil.cu with
the same `lsd_regularize_accumulators` entry, e.g. from `git show`) and
times it against the current kernel in turns (old, new, new, old),
L2-warm and cold.

    python3 chip_smoke.py --baseline-segment-cu OLD.cu

also builds OLD.cu, the sort-and-walk csrc/segment_sum.cu of commit
7824632 (its `lsd_segment_sum` walks stable-sorted int64 keys and perm,
one thread per segment head; any other file is refused, by its sha256,
before anything is built), and times its route (torch.sort + its kernel)
and its kernel alone in turns with the current ones in [scatter].

    python3 chip_smoke.py --counted-runner files:DIR calib:FILE out:DIR ...

runs `lsd_slam_tpu_torch.io.runner.main` with those arguments and prints
its kernel counts as the last line (what [cli] runs for each runner call).

    python3 chip_smoke.py --warmup-run with|without

times a fresh engine's first calls with or without warm-up first and
prints them as the last line (what [warmup] runs in each process).

    python3 chip_smoke.py --pipeline-turns

runs only the build and `[slam-pipelined]`'s sequence at pipeline_lag 0
and 3 in turns (0, 3, 3, 0), sequential, no per-frame synchronisation,
and prints each run's frames per second, stage medians and syncs: what
the pipelined ring hides on one sequence, one card, one call.

Needs CUDA and the port's package beside it: without either it exits 2
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Per-frame bound of the card's trajectory against the JAX reference, for
# the camera centre (scene units; depths are 1.5-4.5) and the rotation
# (rad). The port on the CPU stays within 4.7e-5 (centre) and 1.2e-5 rad of
# the reference (tests/make_torch_vo_reference.py --check-port); the bound
# adds a 20x margin for the card's other reduction orders.
TRAJ_BOUND = 1e-3

# H100 SXM: HBM3 rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# The lag-3 bench (N = 100): rounding variants of its JAX reference (the
# port with 8, 3 and 4 threads + 1e-6 image noise, JAX + noise) lie up to
# 6.15e-3 / 3.80e-3 rad from it and keep its graph; about twice that
PIPE_C, PIPE_R = 1.25e-2, 8e-3

# The SLAM runs: (stored JAX reference, per-frame bound of the card's
# trajectory against it for the camera centre in scene units, for the
# rotation in rad). TRAJ_BOUND is below what the reference itself
# reproduces with SLAM on: the Sim(3) LM stops on a relative-error test and
# the pose-graph updates on pgo_min_change, so f32 summation order alone
# moves the trajectory while the graph stays the same. Runs of
# tests/make_torch_slam_reference.py on the CPU that differ from the stored
# file only in rounding (--check-port with --threads 8, 3, and 4
# --noise-seed 2; --check-jax --noise-seed 1; for the loop also --threads
# 1) lie up to 4.86e-3 / 2.34e-3 rad from it on the bench and 3.06e-3 /
# 1.16e-3 rad on the loop; each bound is about twice that.
# The fabmap run (use_fabmap=True) is [slam]'s scenario against its own
# JAX reference, which builds [slam]'s graph; its rounding variants (the
# port with 8 and 3 threads, + noise) keep that graph too.
SLAM_RUNS = {
    "slam": ("slam_bench_640x480.json", 1e-2, 5e-3),
    "slam-loop": ("slam_loop_160x128.json", 6e-3, 2.5e-3),
    "slam-pipelined": ("slam_bench_640x480_lag3.json", PIPE_C, PIPE_R),
    "slam-fabmap": ("slam_bench_640x480_fabmap.json", 1e-2, 5e-3),
}
# the runs whose profiled second pass must give the first pass's bits:
# the sequential ones (lag 0 and lag 3), where the port is deterministic on
# the card
BIT_EQUAL_RUNS = ("slam", "slam-pipelined")
# kernel launches of the fold (segment_sum) and of the order step
# (segment_order: its count, scan, place and sort kernels, up to five a
# step) in each path's run (counts zeroed just before)
SEGMENT_LAUNCHES = {}
ORDER_LAUNCHES = {}
# ... and the bound of the card's ATE (raw and after PGO) as a multiple of
# the reference's: the same runs reach 1.05x on the bench, 1.16x on the loop
SLAM_ATE_RATIO = 1.5
# The free-running threaded runs: (the lag-3 or loop reference whose
# sequence they run, the ATE floor: production mode is held to
# max(2 x the reference's, 0.02), tests/test_slam_e2e.py:246; the
# threaded loop to 0.03, tests/test_slam_e2e.py:134; keyframe settings
# over the reference's: the loop's idle re-track densifier starts at 3
# keyframes, as in tests/test_slam_e2e.py:107-110, not 10)
THREADED_RUNS = {
    "slam-production": ("slam_bench_640x480_lag3.json", 0.02, {}),
    "slam-threads": ("slam_loop_160x128.json", 0.03,
                     dict(retrack_min_keyframes=3)),
}
# the multi-reference sweep, card against the CPU port: every state field
# within 1e-5 but on the pixels whose EPL decision or dither flips, at
# most max(16, 1%) of them (tests/test_observe_multi.py:75-85)
MULTI_BOUND = 1e-5

STENCIL_RTOL = STENCIL_ATOL = 1e-6  # tests/test_pallas_stencil.py:36-38

# the undistort remap, card against the CPU port on the same image and
# tables (0-255 values; tests/test_torch_io.py holds the CPU port to JAX
# at the same bound)
UNDISTORT_ATOL = 1e-4
UNDISTORT_CASES = {
    "fov-crop": ([0.7, 0.9333, 0.5, 0.5, 0.9], "crop"),
    "fov-full": ([0.7, 0.9333, 0.5, 0.5, 0.9], "full"),
    "opencv-crop": ([0.7, 0.9333, 0.5, 0.5, -0.2, 0.05, 0.0, 0.0], "crop"),
}
# the sparse PGO, card against the CPU port, max |log| per vertex: both
# run the same f32 CG, whose last iterations creep to tol = 1e-7 at f32's
# floor, so the two stop a few iterations apart (on the CPU the port and
# JAX's solve lie within 1e-4, tests/test_torch_sparse_pgo.py)
PGO_GAP = 1e-4
# the appearance descriptor, card against the CPU port (unit vectors;
# tests/test_torch_appearance.py holds the CPU port to JAX at the same
# bound)
APPEARANCE_ATOL = 1e-5
# the dataset runner's phase: frames of [slam]'s sequence, and where the
# checkpoint run stops and the resumed one starts
CLI_FRAMES, CLI_SPLIT = 60, 30
# what `--counted-runner` prints before its kernel counts
COUNTS_TAG = "[counted-runner] "

# L2 is 50 MB: the cold timings rotate over more input bytes than this
COLD_BYTES = 64 << 20
SHAPES = ((480, 640), (40, 52), (37, 53))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def random_planes(rng, h, w):
    """The stencil test planes of tests/test_pallas_stencil.py:11-18, with
    var = 0 at half the invalid pixels as real states hold it
    (tests/test_torch_regularize.py): the centre tap's ivar is then inf and
    s_id * ivar NaN, which only the mask keeps out of the sums."""
    idepth = rng.uniform(0.2, 2.0, (h, w)).astype(np.float32)
    var = rng.uniform(0.001, 0.3, (h, w)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) < 0.6
    validity = rng.uniform(0, 50, (h, w)).astype(np.float32)
    idepth = np.where(valid, idepth, 0.0).astype(np.float32)
    var[~valid & (rng.uniform(size=(h, w)) < 0.5)] = 0.0
    return idepth, var, valid.astype(np.float32), validity


def random_state(torch, rng, h, w):
    """The planes regularize_fused takes, on the card: random_planes plus
    idepth_smoothed / var_smoothed (-1 where invalid) and a blacklist."""
    idepth, var, valid, validity = random_planes(rng, h, w)
    v = valid > 0
    id_sm = np.where(v, idepth * rng.uniform(0.9, 1.1, (h, w)), -1.0)
    var_sm = np.where(v, var * rng.uniform(0.9, 1.1, (h, w)), -1.0)
    bl = rng.integers(-3, 1, (h, w)).astype(np.int32)
    return [torch.as_tensor(a, device="cuda").contiguous() for a in (
        idepth, var, v, validity, id_sm.astype(np.float32),
        var_sm.astype(np.float32), bl)]


@contextlib.contextmanager
def counted_plain(stencil):
    """Count the calls of the stencil's plain versions while inside; yields
    a one-element list holding the count."""
    calls = [0]
    plains = {name: getattr(stencil, name) for name in (
        "regularize_plain", "regularize_accumulators_plain")}

    def counted(fn):
        def call(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return call
    for name, fn in plains.items():
        setattr(stencil, name, counted(fn))
    try:
        yield calls
    finally:
        for name, fn in plains.items():
            setattr(stencil, name, fn)


def max_err_of(a, b, err):
    both = np.isfinite(a) & np.isfinite(b)
    if both.any():
        err = max(err, float(np.abs(a[both] - b[both]).max()))
    return err


def compare_stencil(torch, stencil, planes, reg_dist_var, diff_fac):
    """Kernel vs plain on the card; returns the max abs error."""
    ins = [torch.as_tensor(p, device="cuda").contiguous() for p in planes]
    got = stencil.regularize_accumulators(*ins, reg_dist_var, diff_fac)
    want = stencil.regularize_accumulators_plain(*ins, reg_dist_var,
                                                 diff_fac)
    torch.cuda.synchronize()
    err = 0.0
    names = ("sum_id", "sum_ivar", "val_sum", "n_occ", "n_not_occ")
    for name, a, b in zip(names, got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name.startswith("n_"):
            if not np.array_equal(a, b):
                raise AssertionError(f"stencil {name}: counts differ at "
                                     f"{int((a != b).sum())} pixels")
        np.testing.assert_allclose(a, b, rtol=STENCIL_RTOL,
                                   atol=STENCIL_ATOL, err_msg=name)
        err = max_err_of(a, b, err)
    return err


def compare_fused(torch, stencil, st, reg_dist_var, diff_fac, validity_th,
                  remove_occlusions):
    """regularize_fused vs regularize_plain on the card; valid and the
    blacklist must match exactly. Returns (max abs error, pixels deleted,
    pixels kept)."""
    args = (*st, reg_dist_var, diff_fac, validity_th, remove_occlusions)
    got = stencil.regularize_fused(*args)
    want = stencil.regularize_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    names = ("valid", "blacklisted", "idepth_smoothed", "var_smoothed")
    for name, a, b in zip(names, got, want):
        if a.dtype != b.dtype:
            raise AssertionError(f"fused {name}: {a.dtype} != {b.dtype}")
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name in ("valid", "blacklisted"):
            if not np.array_equal(a, b):
                raise AssertionError(f"fused {name}: differs at "
                                     f"{int((a != b).sum())} pixels")
            continue
        np.testing.assert_allclose(a, b, rtol=STENCIL_RTOL,
                                   atol=STENCIL_ATOL, err_msg=name)
        err = max_err_of(a, b, err)
    v_in = st[2].cpu().numpy()
    deleted = int((v_in & ~got[0].cpu().numpy()).sum())
    kept = int((got[2] != st[4]).sum().item())
    return err, deleted, kept


def time_gpu(torch, fn, per_batch: int, batches: int) -> float:
    """Median over `batches` of the device time of `per_batch` calls, in ms
    per call. A sleep kernel holds the stream while the host enqueues the
    batch, so the events time the device work, not the launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def time_in_turns(torch, fns, per_batch, batches):
    """Median device ms per call of each of (name, fn) in `fns`, timed in
    turns a, b, ..., b, a (half the batches each time)."""
    half = max(batches // 2, 1)
    out = {name: [] for name, _ in fns}
    for name, fn in list(fns) + list(fns)[::-1]:
        out[name].append(time_gpu(torch, fn, per_batch, half))
    return {k: statistics.median(v) for k, v in out.items()}


def host_us_per_call(torch, fn, calls=200, repeats=7):
    """Median host microseconds to enqueue one call (no sync inside)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def launch_baseline(torch, stencil, fn, planes, reg_dist_var, diff_fac):
    outs = [torch.empty_like(planes[0]) for _ in range(5)]
    h, w = planes[0].shape
    dist = stencil.dist_constants(reg_dist_var)
    rc = fn(*(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs),
            h, w, dist.ctypes.data, float(np.float32(diff_fac)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline launch failed: cudaError {rc}")
    return outs


def rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def run_vo(torch, ref, profile: bool):
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    n = ref["n_frames"]
    cam = synth.default_camera(ref["width"], ref["height"])
    scene = synth.PlaneScene(seed=ref["scene_seed"])
    poses = synth.orbit_trajectory(n, radius=ref["radius"], fwd=ref["fwd"])
    frames = [synth.render(scene, cam, poses[i], device="cuda")
              for i in range(n)]
    cfg = LSDConfig()
    if profile:
        cfg = cfg.replace(system=dataclasses.replace(cfg.system,
                                                     profile_sync=True))
    # device defaults to the card; VO only, as the stored reference
    sys_ = SlamSystem(cam, cfg, enable_slam=False)
    assert sys_.device.type == "cuda", sys_.device
    torch.cuda.synchronize()
    frame_ms = []
    t_all = time.perf_counter()
    sys_.gt_depth_init(frames[0][0], frames[0][1], 0, 0.0)
    for i in range(1, n):
        t0 = time.perf_counter()
        sys_.track_frame(frames[i][0], i, i / 30.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    sys_.finalize()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    return sys_, poses, frame_ms, total_s


def trace_device(torch, tag, run, n_tracked, top):
    """Run `run()` (which returns its wall seconds) under torch.profiler,
    tracing the card only, and print the device busy share of that wall
    time and the kernels that take the device time. Kernel events are
    summed from the raw trace: building the profiler's event tree for a
    SLAM run (millions of events) would take longer than the run. The trace
    is informational: a profiler that cannot trace the card prints a note
    instead of failing the run; a failure of `run` itself propagates.
    Returns the busy share, or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:  # noqa: BLE001 - informational phase
        log(f"[{tag}] profiler unavailable: {exc!r}")
        return None
    total_s = run()
    try:
        prof.stop()
        events = prof.profiler.kineto_results.events()
    except Exception as exc:  # noqa: BLE001 - informational phase
        log(f"[{tag}] profiler unavailable: {exc!r}")
        return None
    by_name = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    if busy_ms == 0:
        log(f"[{tag}] the profiler saw no device time")
        return None
    launches = sum(c for _, c in by_name.values())
    share = busy_ms / (total_s * 1e3)
    log(f"[{tag}] run wall {total_s * 1e3:.1f} ms (profiled), device busy "
        f"{busy_ms:.1f} ms -> busy share {share:.3f}; "
        f"{launches / n_tracked:.0f} device ops per tracked frame")
    for name, (ns, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}]   {ns / 1e6:9.3f} ms {count:7d}x  {name[:90]}")
    return share


SLAM_COUNTERS = ("keyframes_created", "keyframes_reactivated", "relocalized",
                 "relocalization_rejected")
SYNC_KEYS = ("host_syncs", "lm_syncs", "export_syncs", "switch_syncs",
             "quick_syncs", "sim3_syncs", "backend_pulls", "map_pulls")


def load_ref(name):
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           name)) as f:
        return json.load(f)


def run_slam(torch, ref, sequential=True, sync_each=True):
    """The SLAM scenario of a stored reference on the card, at the
    reference's pipeline lag. Returns a namespace: the system `sys`, gt
    `poses`, `fms` (per-frame ms of frames 1..N-1), `sw` (switch flags),
    `recovered` (the frame the relocaliser recovered at), `fin_ms`
    (finalize), `track_s` (frames 1..N-1 with the ring drained) and
    `total_s`. With sync_each the card is synchronised
    after every frame (frame ms is then device-inclusive); without it a
    frame's ms is its track_frame call, and the pipelined ring keeps work
    in flight across calls. The ring is drained before the manual loss and
    after the lost frame (a no-op at lag 0 in sequential mode), as
    tests/make_torch_slam_reference.py does."""
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    n = ref["n_frames"]
    cam = synth.default_camera(ref["width"], ref["height"])
    if ref["scene"] == "bench":
        scene = synth.BenchScene(seed=ref["scene_seed"])
        poses = synth.bench_trajectory(n)
        frames = [synth.render_realistic(scene, cam, poses[i], frame_index=i,
                                         noise_sigma=ref["noise_sigma"],
                                         device="cuda") for i in range(n)]
    else:
        scene = synth.PlaneScene(seed=ref["scene_seed"])
        poses = synth.loop_trajectory(n)
        frames = [synth.render(scene, cam, poses[i], device="cuda")
                  for i in range(n)]
    cfg = LSDConfig(width=ref["width"], height=ref["height"])
    cfg = cfg.replace(
        keyframe=dataclasses.replace(cfg.keyframe, **ref["keyframe_config"]),
        system=dataclasses.replace(
            cfg.system, pipeline_lag=ref.get("pipeline_lag", 0),
            sequential=sequential, use_fabmap=ref.get("use_fabmap", False)))
    sys_ = SlamSystem(cam, cfg)  # SLAM on, on the card
    assert sys_.device.type == "cuda" and sys_.backend is not None
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    sys_.gt_depth_init(frames[0][0], frames[0][1], 0, 0.0)
    frame_ms, switched = [], []
    kf_id = sys_.current_keyframe.id
    for i in range(1, n):
        t0 = time.perf_counter()
        sys_.track_frame(frames[i][0], i, i / 30.0)
        if sync_each:
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        switched.append(sys_.current_keyframe.id != kf_id)
        kf_id = sys_.current_keyframe.id
    sys_.block_until_mapped()
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t_all
    assert sys_.tracking_is_good, "SLAM tracking lost before the manual loss"
    sys_.manual_tracking_loss = True
    sys_.track_frame(frames[n - 1][0], n, n / 30.0)
    sys_.block_until_mapped()
    recovered = None
    for j, i in enumerate(range(n - 2, n // 2, -1)):
        sys_.track_frame(frames[i][0], n + 1 + j, (n + 1 + j) / 30.0)
        if sys_.tracking_is_good:
            recovered = i
            break
    t0 = time.perf_counter()
    sys_.finalize()
    torch.cuda.synchronize()
    fin_ms = (time.perf_counter() - t0) * 1e3
    return types.SimpleNamespace(
        sys=sys_, poses=poses, fms=np.asarray(frame_ms),
        sw=np.asarray(switched), recovered=recovered, fin_ms=fin_ms,
        track_s=track_s, total_s=time.perf_counter() - t_all)


def graph_of(sys_):
    """(keyframe ids, parents, edge pairs, loop-closure edges): a loop
    closure is an edge of which neither keyframe was tracked on the
    other."""
    kfs = [kf.id for kf in sys_.keyframes]
    parents = [-1 if kf.pose.parent is None else kf.pose.parent.frame_id
               for kf in sys_.keyframes]
    edges = [[e.first.id, e.second.id] for e in sys_.backend.graph.edges]
    parent_of = dict(zip(kfs, parents))
    loops = [[a, b] for a, b in edges
             if parent_of.get(a) != b and parent_of.get(b) != a]
    return kfs, parents, edges, loops


def log_run(tag, run, n, fused, acc, plain):
    """The timing, sync and launch lines every SLAM phase prints."""
    sys_, fms, sw = run.sys, run.fms, run.sw
    st = sys_.stats.snapshot()
    n_new = max(int(st.get("sim3_stage0_n", 0)), 1)
    search_ms = sum(st.get(f"sim3_stage{k}_ms", 0.0) for k in range(3))
    syncs = sum(st.get(k, 0) for k in SYNC_KEYS)
    n_frames_run = len(sys_.all_frame_poses) + 1   # + the lost frame
    log(f"[{tag}] frame p50 {np.percentile(fms, 50):.3f} ms, p95 "
        f"{np.percentile(fms, 95):.3f} ms over frames 1..{n - 1}; "
        f"frames 1..{n - 1} in {run.track_s:.2f} s wall "
        f"({(n - 1) / run.track_s:.3f} fps, ring drained); "
        f"keyframe-switch frames {int(sw.sum())}, median "
        f"{np.median(fms[sw]) if sw.any() else float('nan'):.1f} ms, max "
        f"{fms[sw].max() if sw.any() else float('nan'):.1f} ms; total "
        f"{run.total_s:.2f} s")
    log(f"[{tag}] constraint search {search_ms / n_new:.1f} ms per new "
        f"keyframe over {n_new} (stages (4,3) {st.get('sim3_stage0_ms', 0):.1f}"
        f", (2,2) {st.get('sim3_stage1_ms', 0):.1f}, (1,1) "
        f"{st.get('sim3_stage2_ms', 0):.1f} ms in all); PGO "
        f"{st.get('pgo_ms', 0.0):.1f} ms over {int(st.get('pgo_calls', 0))} "
        f"solves, finalize {run.fin_ms:.1f} ms")
    log(f"[{tag}] host syncs per frame {syncs / n_frames_run:.2f} (pack "
        f"pulls {st.get('host_syncs', 0):.0f}, SE3 LM flags "
        f"{st.get('lm_syncs', 0):.0f}, quick LM flags "
        f"{st.get('quick_syncs', 0):.0f}, Sim3 LM flags "
        f"{st.get('sim3_syncs', 0):.0f}, back-end pulls "
        f"{st.get('backend_pulls', 0):.0f}, exports "
        f"{st.get('export_syncs', 0):.0f}, switch rescales "
        f"{st.get('switch_syncs', 0):.0f}, mapping stats pulls "
        f"{st.get('map_pulls', 0):.0f}) over {n_frames_run} frames")
    log(f"[{tag}] stage ms (dispatch windows): {sys_.timers.summary()}")
    log(f"[{tag}] regularize_fused launches {fused}, regularize_accumulators "
        f"launches {acc}, plain-version calls {plain}")
    return st


def slam_phase(torch, stencil, counted_plain, tag, trace):
    """Phase 5 ("slam"), 6 ("slam-loop") or 8 ("slam-pipelined"): the run
    of SLAM_RUNS[tag] against its stored reference, then, if `trace`, a
    second pass under torch.profiler. Returns (fused launches on the path,
    the final state's planes for the kernel check, the busy share or
    None)."""
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    ref_file, traj_bound, rot_bound = SLAM_RUNS[tag]
    ref = load_ref(ref_file)
    n = ref["n_frames"]
    sync_each = ref.get("pipeline_lag", 0) == 0
    with counted_plain() as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        run = run_slam(torch, ref, sync_each=sync_each)
        fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
        SEGMENT_LAUNCHES[tag] = scatter.LAUNCHES
        ORDER_LAUNCHES[tag] = scatter.ORDER_LAUNCHES
    sys_, poses, recovered = run.sys, run.poses, run.recovered
    kfs, parents, edges, loops = graph_of(sys_)
    st = sys_.stats.snapshot()
    counters = {k: int(st.get(k, 0)) for k in SLAM_COUNTERS}
    traj, opt = sys_.trajectory_array(), sys_.optimized_trajectory_array()
    ate = float(ate_rmse(traj[:n], poses))
    ate_opt = float(ate_rmse(opt[:n], poses))
    log(f"[{tag}] N={n} {ref['width']}x{ref['height']} pipeline_lag="
        f"{ref.get('pipeline_lag', 0)} use_fabmap="
        f"{ref.get('use_fabmap', False)} keyframes={kfs} "
        f"(reference {ref['keyframe_ids']})")
    log(f"[{tag}] parents {parents} (reference {ref['parent_ids']}); "
        f"loop-closure edges {loops} (reference {ref['nonparent_edges']})")
    log(f"[{tag}] edges {len(edges)} (reference {len(ref['edges'])}), "
        f"counters {counters} (reference {ref['counters']}), recovered at "
        f"frame {recovered} (reference {ref['recovered_at']})")
    log(f"[{tag}] ATE {ate:.6g} (reference {ref['ate']:.6g}), after PGO "
        f"{ate_opt:.6g} (reference {ref['ate_optimized']:.6g}); bound "
        f"{SLAM_ATE_RATIO:g}x the reference's")
    worst = {}
    for key, got in (("trajectory_c2w_sim3", traj),
                     ("optimized_c2w_sim3", opt)):
        want = np.asarray(ref[key])
        assert got.shape == want.shape, (key, got.shape, want.shape)
        dc = np.linalg.norm(got[:, 4:7] - want[:, 4:7], axis=1)
        da = np.asarray([rotation_angle(a[0:4], b[0:4])
                         for a, b in zip(got, want)])
        worst[key] = (float(dc.max()), float(da.max()))
        log(f"[{tag}] {key}: max |centre - ref| {dc.max():.4g} (frame "
            f"{int(dc.argmax())}), max rot diff {da.max():.4g} rad; bounds "
            f"{traj_bound:g} / {rot_bound:g}")
    log_run(tag, run, n, fused, acc, plain_calls[0])
    index = sys_.backend.graph.appearance
    log(f"[{tag}] segment_sum launches {SEGMENT_LAUNCHES[tag]}, "
        f"segment_order launches {ORDER_LAUNCHES[tag]}"
        + ("" if index is None else
           f"; appearance index holds {len(index)} keyframes, answered "
           f"{index.n_queries} queries of the constraint search with "
           f"{index.n_hits} hits"))
    assert (index is not None) == ref.get("use_fabmap", False)
    if index is not None:
        assert len(index) == len(kfs) and index.n_queries > 0, (
            len(index), len(kfs), index.n_queries)
    assert kfs == ref["keyframe_ids"], (kfs, ref["keyframe_ids"])
    assert parents == ref["parent_ids"], (parents, ref["parent_ids"])
    assert edges == ref["edges"], "edge pairs differ from the reference"
    assert loops == ref["nonparent_edges"], (loops, ref["nonparent_edges"])
    assert loops or tag != "slam-loop", "the loop run closes no loop"
    assert counters == ref["counters"], (counters, ref["counters"])
    assert recovered == ref["recovered_at"], (recovered, ref["recovered_at"])
    assert sys_.tracking_is_good, "SLAM run ends lost"
    assert ate <= SLAM_ATE_RATIO * ref["ate"], (ate, ref["ate"])
    assert ate_opt <= SLAM_ATE_RATIO * ref["ate_optimized"], (
        ate_opt, ref["ate_optimized"])
    for key, (dc, da) in worst.items():
        assert dc <= traj_bound and da <= rot_bound, (
            f"{key} off the JAX reference: centre {dc}, rotation {da}")
    assert fused >= n and acc == 0 and plain_calls[0] == 0, (
        fused, acc, plain_calls)
    assert SEGMENT_LAUNCHES[tag] > 0, "no segment_sum launch on the path"
    assert ORDER_LAUNCHES[tag] > 0, "no segment_order launch on the path"
    share = None
    if trace:
        # the profiled pass runs the scenario again: it must build the same
        # graph and, in sequential mode, the same bits
        again = {}

        def traced():
            again["run"] = run_slam(torch, ref, sync_each=sync_each)
            return again["run"].total_s
        share = trace_device(torch, f"{tag}-trace", traced, n - 1, 12)
        if "run" not in again:
            traced()
        s2 = again["run"].sys
        same_graph = graph_of(s2) == (kfs, parents, edges, loops)
        diffs = [float(np.abs(a - b).max()) if a.shape == b.shape else
                 float("inf") for a, b in (
                     (s2.trajectory_array(), traj),
                     (s2.optimized_trajectory_array(), opt))]
        log(f"[{tag}] second pass (the profiled one) against the first: "
            f"graph equal {same_graph}, max |difference| of the trajectory "
            f"{diffs[0]:g}, of the optimised trajectory {diffs[1]:g}")
        if tag in BIT_EQUAL_RUNS:
            assert same_graph and diffs == [0.0, 0.0], (same_graph, diffs)
    s = sys_.map.state
    return fused, [s.idepth, s.var, s.valid, s.validity, s.idepth_smoothed,
                   s.var_smoothed, s.blacklisted], share


def threaded_phase(torch, stencil, counted_plain, tag):
    """Phase 9 ("slam-production": the lag-3 bench, sequential=False) or
    10 ("slam-threads": the 160x128 loop, sequential=False, lag 0),
    free-running and so held to properties, not to a stored trajectory.
    Returns the fused launches on the path."""
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    ref_file, ate_floor, keyframe = THREADED_RUNS[tag]
    ref = load_ref(ref_file)
    ref["keyframe_config"] = dict(ref["keyframe_config"], **keyframe)
    n = ref["n_frames"]
    from lsd_slam_tpu_torch.ops import scatter

    with counted_plain() as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        run = run_slam(torch, ref, sequential=False, sync_each=False)
        fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
        SEGMENT_LAUNCHES[tag] = scatter.LAUNCHES
        ORDER_LAUNCHES[tag] = scatter.ORDER_LAUNCHES
    sys_, poses, recovered = run.sys, run.poses, run.recovered
    kfs, parents, edges, loops = graph_of(sys_)
    n_edges = sys_.backend.graph.pose_graph.n_edges
    traj = sys_.trajectory_array()
    ate = float(ate_rmse(traj[:n], poses))
    frame_ids = [f for _, f, _ in sys_.trajectory]
    expect_ids = list(range(n)) + ([n + 1 + (n - 2 - recovered)]
                                   if recovered is not None else [])
    ate_bound = (max(2.0 * ref["ate"], ate_floor) if tag == "slam-production"
                 else ate_floor)
    st = log_run(tag, run, n, fused, acc, plain_calls[0])
    mt = sys_.mapping_thread
    log(f"[{tag}] N={n} {ref['width']}x{ref['height']} sequential=False "
        f"pipeline_lag={sys_._lag}: keyframes {kfs} (lag-{sys_._lag} "
        f"reference run, sequential: {ref['keyframe_ids']}), parents "
        f"{parents}, {n_edges} edges, loop-closure edges {loops}, "
        f"recovered at {recovered}")
    log(f"[{tag}] ATE {ate:.6g} (bound {ate_bound:.6g}); mapping batches "
        f"{st.get('mapping_batches', 0):.0f}, mapping_batch_max "
        f"{st.get('mapping_batch_max', 0):.0f}, frames consumed "
        f"{st.get('mapping_frames_consumed', 0):.0f}, dropped for a wrong "
        f"parent {st.get('mapping_dropped_wrong_parent', 0):.0f}, queue "
        f"dropped {mt.queue.dropped if mt is not None else 'n/a'}; "
        f"constraint searches {st.get('constraint_searches', 0):.0f}, "
        f"retrack_attempts {st.get('retrack_attempts', 0):.0f} (found "
        f"{st.get('retrack_constraints_found', 0):.0f}), PGO solves "
        f"{st.get('pgo_calls', 0):.0f}")
    assert sys_.tracking_is_good, f"{tag} ends lost"
    assert frame_ids == expect_ids, "a frame was not retired exactly once"
    assert n_edges >= len(kfs) - 1, (n_edges, kfs)
    assert ate < ate_bound, (ate, ate_bound)
    if tag == "slam-production":
        assert abs(len(kfs) - len(ref["keyframe_ids"])) <= 2, (
            kfs, ref["keyframe_ids"])
    assert not any(w.alive() for w in sys_.workers()), "a worker outlived " \
        "finalize"
    assert fused > 0 and acc == 0 and plain_calls[0] == 0, (
        fused, acc, plain_calls)
    return fused


def observe_multi_phase(torch, stencil, counted_plain, reg_bound):
    """Phase 7: DepthMap.update_keyframe_multi at 640x480 on the card and on
    the CPU port from the same inputs, K = 1, 3, 8, 10. Returns (fused
    launches on the card, the max abs error of the state fields off the
    flipped pixels, the most pixels flipped in one K)."""
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.depth.depth_map import DepthMap
    from lsd_slam_tpu_torch.frames import build_frame
    from lsd_slam_tpu_torch.lie import np_sim3 as nps
    from lsd_slam_tpu_torch.utils import synth

    w, h, n_frames = 640, 480, 130
    cam = synth.default_camera(w, h)
    cfg = LSDConfig(width=w, height=h)
    scene = synth.BenchScene(seed=0)
    poses = synth.bench_trajectory(n_frames)
    rng = np.random.default_rng(0)
    renders = [synth.render_realistic(scene, cam, poses[i], frame_index=i,
                                      noise_sigma=0.0, device="cuda")
               for i in range(11)]
    kf_img, kf_dep = renders[0]
    gt = torch.where(kf_dep > 0, 1.0 / torch.clamp_min(kf_dep, 1e-6),
                     torch.zeros_like(kf_dep))
    # frame k's ref->keyframe pose (gt poses are world->camera)
    r2k = [nps.se3_mul(poses[0].astype(np.float64),
                       nps.se3_inverse(poses[k].astype(np.float64)))
           for k in range(11)]
    nmi = rng.integers(0, 17, (h, w)).astype(np.float32)
    gms = [rng.uniform(size=(h // 2, w // 2)) < 0.9 for _ in range(11)]
    res = [float(x) for x in rng.uniform(0.5, 2.0, 11)]

    def run(dev, k):
        pyr = build_frame(kf_img.to(dev), 5)
        dm = DepthMap(cam, cfg, dev)
        dm.initialize_from_gt(gt.to(dev), pyr.max_grad[0])
        dm.state = dm.state.replace(next_min_id=torch.as_tensor(nmi,
                                                                device=dev))
        frames = range(1, k + 1)
        t0 = time.perf_counter()
        stats = dm.update_keyframe_multi(
            pyr, [renders[i][0].to(dev) for i in frames],
            [r2k[i] for i in frames], [float(4 + i) for i in frames],
            [torch.as_tensor(gms[i], device=dev) for i in frames],
            [res[i] for i in frames])
        if dev == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return dm, stats, ms

    launches, worst_err, worst_flips = 0, 0.0, 0
    fields = ("valid", "idepth", "var", "validity", "blacklisted",
              "idepth_smoothed", "var_smoothed")
    for k in (1, 3, 8, 10):
        with counted_plain() as plain_calls:
            stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
            dm, stats, ms = run("cuda", k)
            fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
        assert fused > 0 and acc == 0 and plain_calls[0] == 0, (
            k, fused, acc, plain_calls)
        launches += fused
        warm_ms = run("cuda", k)[2]
        cpu_dm, cpu_stats, cpu_ms = run("cpu", k)
        # an EPL decision that flips (a best step, an update's success)
        # moves every field of its pixel; elsewhere the fields agree
        decided = np.zeros((h, w), bool)
        diffs = {}
        for f in fields:
            a = getattr(dm.state, f).cpu().numpy().astype(np.float64)
            b = getattr(cpu_dm.state, f).numpy().astype(np.float64)
            diffs[f] = np.abs(a - b)
            decided |= diffs[f] > (0 if f in ("valid", "blacklisted")
                                   else reg_bound)
        err = max(float(d[~decided].max(initial=0.0))
                  for d in diffs.values())
        per_field = ", ".join(
            f"{f} {float(d.max()):.3g} ({int((d > reg_bound).sum())} px)"
            for f, d in diffs.items())
        a = dm.state.next_min_id.cpu().numpy()
        b = cpu_dm.state.next_min_id.numpy()
        dither = (a != b) & ~decided
        flips = int((decided | dither).sum())
        step = float(np.abs(a - b)[dither].max(initial=0.0))
        upd = float(stats["updated"])
        log(f"[observe-multi] K={k} ({-(-k // 8)} chunk(s)): card "
            f"{ms:.2f} ms (first call), {warm_ms:.2f} ms (second), CPU port "
            f"{cpu_ms:.1f} ms; updated {upd:.0f} (CPU "
            f"{float(cpu_stats['updated']):.0f}); EPL decisions flipped at "
            f"{int(decided.sum())} pixels, the next_min_id dither alone at "
            f"{int(dither.sum())} (by <= {step:g}); max abs err elsewhere "
            f"{err:.3g}; regularize_fused launches {fused}")
        log(f"[observe-multi] K={k} max abs diff per field (pixels over "
            f"{reg_bound:g}): {per_field}")
        assert upd > 1000, upd
        assert flips <= max(16, 0.01 * h * w) and step <= 10.0, (flips, step)
        worst_err, worst_flips = max(worst_err, err), max(worst_flips, flips)
    return launches, worst_err, worst_flips


def undistort_phase(torch, card):
    """Phase 11: the undistort remap on the card against the CPU port, and
    its time per frame."""
    from lsd_slam_tpu_torch.camera import undistorter_for_params

    img = np.random.default_rng(0).uniform(0, 255, (480, 640)).astype(
        np.float32)
    for name, (params, spec) in UNDISTORT_CASES.items():
        gpu = undistorter_for_params(params, (640, 480), spec, (640, 480),
                                     device="cuda")
        cpu = undistorter_for_params(params, (640, 480), spec, (640, 480),
                                     device="cpu")
        assert not gpu._identity and gpu.camera == cpu.camera
        for t in ("_rx", "_ry", "_valid"):
            assert torch.equal(getattr(gpu, t).cpu(), getattr(cpu, t)), t
        frame = torch.as_tensor(img, device="cuda")
        got = gpu(frame).cpu().numpy()
        want = cpu(img).numpy()
        valid = cpu._valid.numpy()
        err = float(np.abs(got - want).max())
        # the valid masks are equal (the tables above); off them both are 0
        assert (got[~valid] == 0).all() and err <= UNDISTORT_ATOL, (name,
                                                                    err)
        ms = time_gpu(torch, lambda: gpu(frame), 50, 30)
        host_us = host_us_per_call(torch, lambda: gpu(frame))
        log(f"[undistort] {name} 640x480: max abs err vs the CPU port "
            f"{err:.3g} (bound {UNDISTORT_ATOL:g}), valid "
            f"{valid.mean():.4f} (mask exact); {ms:.5f} ms per frame "
            f"(CUDA events), host {host_us:.1f} us per call; {card}")


def _runner(args, timeout=900):
    """`lsd_slam_tpu_torch.io.runner.main(ARGS)` in a fresh process
    (`chip_smoke.py --counted-runner ARGS`, see `counted_runner`); returns
    (stdout, frames per second from its `done:` line, its kernel counts).
    Fails unless the run launched the fused kernel, never the accumulators
    entry, and called no plain version."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--counted-runner", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"runner {args} exit {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    done = [ln for ln in lines if ln.startswith("done:")]
    assert len(done) == 1, proc.stdout[-3000:]
    assert lines[-1].startswith(COUNTS_TAG), proc.stdout[-3000:]
    counts = json.loads(lines[-1][len(COUNTS_TAG):])
    assert (counts["fused"] > 0 and counts["accumulators"] == 0
            and counts["plain"] == 0), (args, counts)
    return (proc.stdout, float(done[0].split("(")[1].split(" fps")[0]),
            counts)


def counted_runner(argv) -> int:
    """`chip_smoke.py --counted-runner ARGS`: the dataset runner's own
    entry, `io.runner.main(ARGS)`, as `python -m lsd_slam_tpu_torch.io.runner
    ARGS` calls it, with the kernel launch counters zeroed just before and
    the plain versions counted; the counts read just after are the last
    line, behind COUNTS_TAG."""
    from lsd_slam_tpu_torch.io import runner
    from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
    from lsd_slam_tpu_torch.ops import scatter

    with counted_plain(stencil) as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        runner.main(argv)
        counts = dict(fused=stencil.FUSED_LAUNCHES,
                      accumulators=stencil.LAUNCHES, plain=plain_calls[0],
                      segment_sum=scatter.LAUNCHES,
                      segment_order=scatter.ORDER_LAUNCHES)
    log(COUNTS_TAG + json.dumps(counts))
    return 0


def _runner_outputs(out, n_frames, need_graph=True):
    """Parse what the runner wrote into `out`: the TUM rows, the keyframe
    ids and edge pairs of the last graph message (of the kf_*.npz files
    where a run has no graph: a resumed run whose checkpoint held no edge
    and which finished no keyframe), the PLY's point count. Checks that
    every file exists and parses."""
    from lsd_slam_tpu_torch.io.trajectory import load_tum_trajectory

    traj = load_tum_trajectory(os.path.join(out, "estimated_poses.txt"))
    assert traj.shape == (n_frames, 8), traj.shape
    with open(os.path.join(out, "poses.jsonl")) as f:
        poses = [json.loads(line) for line in f]
    assert poses and all(len(p["cam_to_world"]) == 8 for p in poses)
    with open(os.path.join(out, "graph.jsonl")) as f:
        graph = [json.loads(line) for line in f]
    assert graph or not need_graph, "no graph message"
    kf_files = sorted(f for f in os.listdir(out) if f.startswith("kf_"))
    assert kf_files, "no keyframe file"
    kfs = ([f["id"] for f in graph[-1]["frames"]] if graph
           else [int(f[3:9]) for f in kf_files])
    assert kf_files == [f"kf_{i:06d}.npz" for i in sorted(kfs)], kf_files
    for name in kf_files:
        d = np.load(os.path.join(out, name))
        assert d["idepth"].shape == (480, 640)
        assert np.isfinite(d["idepth"]).all(), name
    with open(os.path.join(out, "pointcloud.ply"), "rb") as f:
        head, body = f.read().split(b"end_header\n", 1)
    n_pts = int(head.split(b"element vertex ")[1].split()[0])
    assert n_pts > 0 and len(body) == 15 * n_pts, (n_pts, len(body))
    edges = ([(c["from"], c["to"]) for c in graph[-1]["constraints"]]
             if graph else [])
    return traj, kfs, edges, n_pts, len(poses)


def png_adaptive(img: np.ndarray) -> tuple:
    """(PNG bytes, rows per filter type) of a (h, w) uint8 image, each row
    with the filter whose bytes, read as signed, sum smallest in magnitude:
    the heuristic of libpng and Pillow, which write the PNGs of public
    datasets; the port's own `write_png` writes filter 0 only."""
    h, w = img.shape
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filt = np.stack([(x - p) & 0xFF for p in (0, a, b, (a + b) >> 1,
                                               paeth)]).astype(np.uint8)
    cost = np.minimum(filt, 256 - filt.astype(np.int32)).sum(axis=2)
    pick = cost.argmin(axis=0)
    rows = np.concatenate([pick[:, None].astype(np.uint8),
                           filt[pick, np.arange(h)]], axis=1)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    return data, np.bincount(pick, minlength=5)


def write_cli_dataset(torch, root):
    """[slam]'s first CLI_FRAMES frames as PNG (uint8, as a camera would
    deliver them; adaptive row filters, as libpng writes them) and the
    identity calibration; returns (frames dir, calibration file, gt
    poses, the frames, rows per filter type over all frames)."""
    from lsd_slam_tpu_torch.utils import synth

    w, h = 640, 480
    cam = synth.default_camera(w, h)
    scene = synth.BenchScene(seed=0)
    poses = synth.bench_trajectory(130)[:CLI_FRAMES]
    frames = os.path.join(root, "frames")
    os.makedirs(frames)
    images, n_filter = [], np.zeros(5, np.int64)
    for i in range(CLI_FRAMES):
        img, _ = synth.render_realistic(scene, cam, poses[i], frame_index=i,
                                        noise_sigma=0.0, device="cuda")
        images.append(img.clamp(0, 255).to(torch.uint8).cpu().numpy())
        data, per_filter = png_adaptive(images[-1])
        n_filter += per_filter
        with open(os.path.join(frames, f"{i:05d}.png"), "wb") as f:
            f.write(data)
    calib = os.path.join(root, "calib.cfg")
    with open(calib, "w") as f:
        f.write(f"0.7 {0.7 * w / h} {((w - 1) / 2 + 0.5) / w} "
                f"{((h - 1) / 2 + 0.5) / h} 0\n{w} {h}\nnone\n{w} {h}\n")
    return frames, calib, poses, images, n_filter


def time_decode(frames, images):
    """Decode the folder on this host one file at a time (`read_gray`) and
    as the runner reads it (`read_gray_many`, ImageFolderSource.read_ahead
    files at a time); both must give the written frames exactly. Returns
    the ms per frame of each."""
    from lsd_slam_tpu_torch.io.dataset import ImageFolderSource
    from lsd_slam_tpu_torch.utils import image_io

    files = ImageFolderSource(frames).files
    step = ImageFolderSource.read_ahead
    t0 = time.perf_counter()
    one = [image_io.read_gray(f) for f in files]
    t1 = time.perf_counter()
    many = [g for k in range(0, len(files), step)
            for g in image_io.read_gray_many(files[k:k + step])]
    t2 = time.perf_counter()
    for a, b, want in zip(one, many, images):
        assert np.array_equal(a, want) and np.array_equal(b, want)
    return (t1 - t0) * 1e3 / len(files), (t2 - t1) * 1e3 / len(files)


def cli_phase(torch, card):
    """Phase 12: the dataset runner on the card; returns each runner run's
    fused launches."""
    import shutil
    import tempfile

    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.io import ImageFolderSource
    from lsd_slam_tpu_torch.io.trajectory import save_tum_trajectory
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    root = tempfile.mkdtemp(prefix="lsd_cli_")
    try:
        t0 = time.perf_counter()
        frames, calib, gt, images, n_filter = write_cli_dataset(torch, root)
        log(f"[cli] wrote {CLI_FRAMES} 640x480 PNG frames in "
            f"{time.perf_counter() - t0:.2f} s; rows by filter (None, Sub, "
            f"Up, Average, Paeth): {n_filter.tolist()}")
        one_ms, many_ms = time_decode(frames, images)
        log(f"[cli] decode on the host: {one_ms:.2f} ms per frame one file "
            f"at a time, {many_ms:.2f} ms per frame "
            f"{ImageFolderSource.read_ahead} at a time (the runner's way); "
            f"both equal the written frames")
        out = os.path.join(root, "out")
        stdout, fps, counts = _runner([f"files:{frames}", f"calib:{calib}",
                                       f"out:{out}"])
        traj, kfs, edges, n_pts, n_poses = _runner_outputs(out, CLI_FRAMES)
        launches = {"hz0": counts["fused"]}
        seg = {"hz0": (counts["segment_sum"], counts["segment_order"])}
        with open(os.path.join(out, "poses.jsonl")) as f:
            published = {p["id"]: p["cam_to_world"]
                         for p in map(json.loads, f)}
        log(f"[cli] runner hz:0: {fps:g} fps ({CLI_FRAMES} frames, decode "
            f"{many_ms:.2f} ms per frame on this host), keyframes {kfs}, "
            f"{len(edges)} edges, {n_pts} points, {n_poses} tracked poses "
            f"published; regularize_fused launches {counts['fused']}, "
            f"regularize_accumulators launches {counts['accumulators']}, "
            f"plain-version calls {counts['plain']}")
        log("[cli] runner " + next(ln for ln in stdout.splitlines()
                                   if ln.startswith("timing:")))

        # the same folder in this process: the graph and trajectory the
        # runner's must equal
        src = ImageFolderSource(frames, calib, device="cuda")
        t0 = time.perf_counter()
        sys_ = SlamSystem(src.camera, LSDConfig(width=640, height=480))
        returned = {}    # what track_frame returns: what the runner publishes
        for i, ts, img in src:
            if i == 0:
                sys_.random_init(img, i, ts)
            else:
                returned[i] = sys_.track_frame(img, i, ts)
        sys_.finalize()
        torch.cuda.synchronize()
        in_s = time.perf_counter() - t0
        ikfs = [kf.id for kf in sys_.keyframes]
        iedges = [(e.first.id, e.second.id) for e in sys_.backend.graph.edges]
        # the runner's TUM rows (written after finalize's PGO, 6 decimals)
        # against the in-process trajectory in the same columns: equal bits
        # differ by at most the file's rounding, 5e-7
        mine = np.asarray([[ts, *p[4:7], *p[1:4], p[0]]
                           for ts, _, p in sys_.trajectory])
        tum_gap = (float(np.abs(traj - mine).max())
                   if traj.shape == mine.shape else float("inf"))
        mine_txt = os.path.join(root, "in_process_poses.txt")
        save_tum_trajectory(mine_txt, sys_.trajectory)
        with open(mine_txt) as f_mine, open(os.path.join(
                out, "estimated_poses.txt")) as f_run:
            same_text = f_mine.read() == f_run.read()
        # the runner publishes what track_frame returns for each tracked
        # frame at full precision (poses.jsonl); the same folder in this
        # process must give the same bits (TUM rows hold 6 decimals)
        assert sorted(published) == sorted(
            fid for fid, p in returned.items() if p is not None)
        exact = np.asarray([np.abs(np.asarray(published[fid]) - p).max()
                            for fid, p in returned.items() if p is not None])
        ate = float(ate_rmse(sys_.trajectory_array(), gt))
        log(f"[cli] in-process: {CLI_FRAMES / in_s:.3f} fps, keyframes "
            f"{ikfs}, {len(iedges)} edges, tracking good "
            f"{sys_.tracking_is_good}, ATE {ate:.6g} (scale-aligned); "
            f"runner vs in-process: max |difference| of the "
            f"{len(traj)} TUM rows {tum_gap:.3g} (bound 1e-6, the file's "
            f"6 decimals), the file byte-identical to the in-process "
            f"trajectory written the same way {same_text}; max "
            f"|difference| of the {len(exact)} published poses "
            f"{exact.max():g} (bound 0)")
        assert sys_.tracking_is_good, "the in-process run ends lost"
        assert len(kfs) >= 2, kfs
        assert kfs == ikfs, (kfs, ikfs)
        assert edges == iedges, (edges, iedges)
        assert len(exact) == CLI_FRAMES - 1 and exact.max() == 0.0, (
            len(exact), exact.max())
        assert tum_gap <= 1e-6, tum_gap

        # checkpoint on frames 0..CLI_SPLIT-1, resume on the rest
        halves = [os.path.join(root, n) for n in ("first", "second")]
        for k, d in enumerate(halves):
            os.makedirs(d)
            for i in (range(CLI_SPLIT) if k == 0
                      else range(CLI_SPLIT, CLI_FRAMES)):
                shutil.copy(os.path.join(frames, f"{i:05d}.png"), d)
        ckpt = os.path.join(root, "ckpt.npz")
        _, fps_a, counts = _runner([f"files:{halves[0]}", f"calib:{calib}",
                                    f"out:{os.path.join(root, 'out_a')}",
                                    f"checkpoint:{ckpt}"])
        launches["checkpoint"] = counts["fused"]
        seg["checkpoint"] = (counts["segment_sum"], counts["segment_order"])
        stdout, fps_b, counts = _runner([f"files:{halves[1]}",
                                         f"calib:{calib}",
                                         f"out:{os.path.join(root, 'out_b')}",
                                         f"resume:{ckpt}"])
        launches["resume"] = counts["fused"]
        seg["resume"] = (counts["segment_sum"], counts["segment_order"])
        traj_b, kfs_b, _, _, n_b = _runner_outputs(
            os.path.join(root, "out_b"), CLI_FRAMES, need_graph=False)
        assert "resumed from" in stdout
        assert np.array_equal(traj_b[:, 0], np.arange(CLI_FRAMES))
        assert n_b == CLI_FRAMES - CLI_SPLIT, n_b
        log(f"[cli] checkpoint: frames 0..{CLI_SPLIT - 1} at {fps_a:g} fps "
            f"({launches['checkpoint']} fused launches); resume: frames "
            f"{CLI_SPLIT}..{CLI_FRAMES - 1} at {fps_b:g} fps "
            f"({launches['resume']} fused launches), trajectory of "
            f"{len(traj_b)} frames, every one tracked, keyframes {kfs_b}")

        # the production mode: threaded back-end, pipelined loop
        stdout, fps_p, counts = _runner([f"files:{frames}", f"calib:{calib}",
                                         f"out:{os.path.join(root, 'out_p')}",
                                         "hz:30", "pipeline:3"])
        launches["hz30_pipeline3"] = counts["fused"]
        seg["hz30_pipeline3"] = (counts["segment_sum"], counts["segment_order"])
        traj_p, kfs_p, edges_p, n_pts_p, _ = _runner_outputs(
            os.path.join(root, "out_p"), CLI_FRAMES)
        pairs = {tuple(sorted(e)) for e in edges_p}
        assert np.array_equal(np.sort(traj_p[:, 0]), np.arange(CLI_FRAMES))
        assert len(pairs) >= len(kfs_p) - 1, (pairs, kfs_p)
        log(f"[cli] hz:30 pipeline:3: {fps_p:g} fps, keyframes {kfs_p}, "
            f"{len(pairs)} edges, {n_pts_p} points, every frame once, "
            f"{launches['hz30_pipeline3']} fused launches; {card}")
        log(f"[cli] regularize_fused launches per runner run {launches}, "
            f"{sum(launches.values())} in all; no regularize_accumulators "
            f"launch, no plain-version call; (segment_sum, segment_order) "
            f"launches {seg}")
        for run, (fold, order) in seg.items():
            SEGMENT_LAUNCHES[f"cli-{run}"] = fold
            ORDER_LAUNCHES[f"cli-{run}"] = order
        assert all(min(n) > 0 for n in seg.values()), seg
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the order-fixed scatter-sum, the sparse PGO, the appearance index,
# ---- warm-up

def scatter_cases(torch, rng):
    """(name, buf, idx, vals) on the CPU, at the shapes the main path gives
    `ordered_index_add`: many sources per target (1e5 into 1e3, signed,
    magnitudes over six decades); propagate's pass 2 at 640x480 (one source
    per pixel, sent to a pixel within 2 of it when compatible, else +0.0 to
    its own pixel; non-negative terms as id/var, 1/var, validity, count),
    each 1-D as four calls, then the four as the one (M, 4) call the
    path makes; the dense PGO's 7x7 blocks of a 10-vertex graph into its
    100 (i, j) targets (the four blocks of each edge in one call), the
    sparse PGO's diagonal blocks at 1000 vertices (both ends of each edge),
    and the appearance descriptor's scatters at 640x480 (level 2: 160x120
    pixels) for one roll (an `add`) and for 16 (a query): the soft-binned
    histograms (lower bins, then upper bins, into tiles x 8 bins per roll)
    and the tile sums of weights and intensities, one (M, 2) call (every
    pixel into its tile, about 1,200 sources per target, the longest
    segments of the port)."""
    def signed(*shape):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    cases = []
    idx = rng.integers(0, 1000, 100_000)
    cases.append(("dup-1e5-into-1e3", np.zeros(1000, np.float32), idx,
                  signed(100_000)))
    h, w = 480, 640
    ys, xs = np.divmod(np.arange(h * w), w)
    keep = rng.uniform(size=h * w) < 0.6
    ty = np.clip(ys + rng.integers(-2, 3, h * w), 0, h - 1)
    tx = np.clip(xs + rng.integers(-2, 3, h * w), 0, w - 1)
    idx = np.where(keep, ty * w + tx, np.arange(h * w))
    terms = []
    for k, hi in enumerate((1e3, 1e2, 50.0, 1.0)):
        vals = np.where(keep, rng.uniform(0, hi, h * w), 0.0) if k < 3 \
            else keep.astype(np.float64)
        terms.append(vals.astype(np.float32))
        cases.append((f"propagate-640x480-{k}", np.zeros(h * w, np.float32),
                      idx, terms[-1]))
    cases.append(("propagate-640x480", np.zeros((h * w, 4), np.float32), idx,
                  np.stack(terms, 1)))
    n, e = 10, 24
    a, b = rng.integers(0, n, e), rng.integers(0, n, e)
    blocks = signed(e, 7, 7)
    cases.append(("pgo-dense-H", np.zeros((n * n, 7, 7), np.float32),
                  np.concatenate([a * n + a, b * n + b, a * n + b,
                                  b * n + a]),
                  np.concatenate([blocks, blocks, -blocks, -blocks])))
    n, e = 1000, 1058
    blocks = signed(e, 7, 7)
    cases.append(("pgo-sparse-D", np.zeros((n, 7, 7), np.float32),
                  rng.integers(0, n, 2 * e),
                  np.concatenate([blocks, blocks])))
    h, w = 120, 160
    ys, xs = np.mgrid[0:h, 0:w]
    tile = ((ys * 4 // h) * 4 + xs * 4 // w).reshape(-1)
    disc = (((xs - (w - 1) / 2) ** 2 + (ys - (h - 1) / 2) ** 2)
            <= ((h - 1) / 2) ** 2).reshape(-1)
    for what, n_rot in (("add", 1), ("query", 16)):
        cell = (np.arange(n_rot)[:, None] * 16 + tile).reshape(-1)
        inb = np.tile(disc, n_rot)
        mag = np.where(inb, rng.exponential(20.0, cell.size), 0.0)
        fb = rng.uniform(size=cell.size)
        b0 = rng.integers(0, 8, cell.size)
        cases.append((f"appearance-{what}-hist",
                      np.zeros(n_rot * 16 * 8, np.float32),
                      np.concatenate([cell * 8 + b0,
                                      cell * 8 + (b0 + 1) % 8]),
                      np.concatenate([mag * (1 - fb), mag * fb])
                      .astype(np.float32)))
        cases.append((f"appearance-{what}-tiles",
                      np.zeros((n_rot * 16, 2), np.float32), cell,
                      np.stack([inb.astype(np.float64),
                                np.where(inb, rng.uniform(0, 255, cell.size),
                                         0.0)], 1).astype(np.float32)))
    return cases


# the shapes [scatter] times in turns: one of propagate's four 1-D sums,
# its (M, 4) call, and the appearance descriptor's four calls
SCATTER_TIMED = ("propagate-640x480-0", "propagate-640x480",
                 "appearance-add-hist", "appearance-add-tiles",
                 "appearance-query-hist", "appearance-query-tiles")
FADD_CYCLES = 4  # the dependent f32 add's latency on Hopper


def sm_clocks_mhz():
    """(the most, the current) SM clock in MHz, as nvidia-smi reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    most, now = (float(x) for x in out.split(","))
    return most, now


def fold_bounds(idx, n_targets, cols, clock_mhz):
    """The fold's two bounds in ms on this index: bytes (offsets, perm and
    values read once, each target that gets a source read and written
    once) at HBM_BYTES_PER_S, and the chain (the longest segment's
    dependent adds at FADD_CYCLES each, at `clock_mhz`)."""
    counts = np.bincount(idx, minlength=n_targets)
    m = idx.shape[0]
    nbytes = (4 * (n_targets + 1) + m * (4 + 4 * cols)
              + int((counts > 0).sum()) * 8 * cols)
    chain = int(counts.max(initial=0)) * FADD_CYCLES / (clock_mhz * 1e3)
    return nbytes / HBM_BYTES_PER_S * 1e3, chain


def order_bound(m, n_targets):
    """The order step's bytes bound in ms: each int64 key read once, the
    int32 perm and offsets written once."""
    return (12 * m + 4 * (n_targets + 1)) / HBM_BYTES_PER_S * 1e3


def kernel_breakdown(torch, fn, calls=20):
    """Device microseconds per call of `fn` by kernel (torch.profiler's
    `key_averages`, the card's activity only; a kernel's name cut to its
    function's name). PERF.md reads it, so a profiler that sees no kernel
    fails the phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.device_time_total:
            continue
        name = e.key.replace("void ", "").replace(
            "(anonymous namespace)::", "")
        name = "torch fill" if "FillFunctor" in name else name.split("(")[0]
        out[name] = out.get(name, 0.0) + e.device_time_total / calls
    assert out, "[scatter] torch.profiler saw no kernel on the card"
    return {k: round(v, 3) for k, v in out.items()}


# sha256 of the one source --baseline-segment-cu takes: csrc/segment_sum.cu
# of commit 7824632, whose `lsd_segment_sum` has the ABI bound below
SORT_AND_WALK_SHA256 = ("e68cf89817422a1fb83f4a879f78b9c6"
                        "a751fb62e11f8725b46808015c4355e3")


def bind_walk_segment_sum(lib):
    """The sort-and-walk `lsd_segment_sum` of the source SORT_AND_WALK_SHA256
    names (stable-sorted int64 keys and perm, one thread per sorted
    position and column, the segment's head walking it)."""
    fn = lib.lsd_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_void_p]

    def launch(torch, keys, perm, vals2, buf2):
        rc = fn(keys.data_ptr(), perm.data_ptr(), vals2.data_ptr(),
                buf2.data_ptr(), keys.numel(), buf2.shape[1], buf2.shape[0],
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"sort-and-walk segment_sum launch: cudaError {rc}"
    return launch


def scatter_phase(torch, card, walk=None):
    """Phase [scatter]. On every case, twice (so run to run): the order
    step's offsets and perm equal bincount + cumsum and torch.sort(stable=
    True)'s permutation, and the card's sums in both regimes of the fold
    and through `ordered_index_add` equal the CPU's `index_add_` bit for
    bit; the kernels equal their plain versions on the card; the atomic
    `index_add_` on the card is compared too (how many values differ).
    Then CUDA-event times in turns at SCATTER_TIMED's shapes: the order
    step and the fold, the fold alone in the regime the shapes pick and in
    each regime, the order alone, `torch.sort` and the atomic `index_add_`,
    and with `walk` (`--baseline-segment-cu`) the sort-and-walk route
    (stable torch.sort + that kernel) and its kernel alone; the plain
    versions at propagate's shape; the device time of the order step and
    the fold by kernel (torch.profiler); each shape's bounds. Last, a
    target out of range fails the count kernel's device-side assert, in a
    process of its own (the assert ends that process's CUDA context).
    Returns the kernel lines' numbers."""
    from lsd_slam_tpu_torch.ops import scatter

    rng = np.random.default_rng(0)
    cases = scatter_cases(torch, rng)
    err = order_err = 0.0
    for name, buf, idx, vals in cases:
        b, i, v = (torch.as_tensor(x) for x in (buf, idx, vals))
        t_len, m = b.shape[0], i.shape[0]
        want = b.clone().index_add_(0, i, v)
        want_perm = torch.sort(i, stable=True).indices.to(torch.int32)
        want_off = torch.zeros(t_len + 1, dtype=torch.int32)
        want_off[1:] = torch.cumsum(torch.bincount(i, minlength=t_len), 0)
        bc, ic, vc = b.cuda(), i.cuda(), v.cuda()
        v2 = vc.reshape(m, -1)
        checks = []
        for _ in range(2):
            order = scatter.sort_index(ic, t_len)
            sums = {r: scatter.segment_sum(bc.clone().view(t_len, -1), order,
                                           v2, r).cpu().reshape(b.shape)
                    for r in ("short", "long")}
            sums["auto"] = scatter.ordered_index_add(bc.clone(), ic, vc).cpu()
            checks.append(dict(
                order=(torch.equal(order.offsets.cpu(), want_off)
                       and torch.equal(order.perm.cpu(), want_perm)),
                **{r: torch.equal(got, want) for r, got in sums.items()}))
        plain_order = scatter.segment_order_plain(ic, t_len)
        plain = scatter.segment_sum_plain(bc.clone().view(t_len, -1), order,
                                          v2).cpu().reshape(b.shape)
        atomic = bc.clone().index_add_(0, ic, vc).cpu()
        torch.cuda.synchronize()
        same_plain_order = (torch.equal(plain_order.offsets, order.offsets)
                            and torch.equal(plain_order.perm, order.perm))
        log(f"[scatter] {name}: {tuple(v.shape)} into {tuple(b.shape)} "
            f"(longest segment {int(np.bincount(idx).max())}, regime "
            f"{scatter.regime_for(m, t_len)}): order == torch.sort, card == "
            f"CPU index_add_ per regime, twice: {checks}; kernels == plain "
            f"{same_plain_order and torch.equal(sums['auto'], plain)}; "
            f"atomic index_add_ on the card differs from the CPU at "
            f"{int((atomic != want).sum())} values")
        assert all(all(c.values()) for c in checks), (name, checks)
        assert same_plain_order and torch.equal(sums["auto"], plain), name
        err = max(err, float((sums["auto"] - plain).abs().max()))
        order_err = max(order_err, *(
            float((a.cpu() - p.cpu()).abs().max()) if a.numel() else 0.0
            for a, p in ((order.offsets, plain_order.offsets),
                         (order.perm, plain_order.perm))))

    clock_max, clock_now = sm_clocks_mhz()
    timed = {}
    for name, buf, idx, vals in cases:
        if name not in SCATTER_TIMED:
            continue
        bc, ic, vc = (torch.as_tensor(x, device="cuda")
                      for x in (buf, idx, vals))
        t_len, m = bc.shape[0], ic.shape[0]
        cols = vc.numel() // max(m, 1)
        b2, v2 = bc.view(t_len, cols), vc.view(m, cols)
        order = scatter.sort_index(ic, t_len)
        fns = [("order_and_fold",
                lambda: scatter.ordered_index_add(bc, ic, vc)),
               ("fold", lambda: scatter.segment_sum(b2, order, v2)),
               ("fold_short",
                lambda: scatter.segment_sum(b2, order, v2, "short")),
               ("fold_long",
                lambda: scatter.segment_sum(b2, order, v2, "long")),
               ("order", lambda: scatter.sort_index(ic, t_len)),
               ("torch_sort", lambda: torch.sort(ic, stable=True)),
               ("atomic_index_add", lambda: bc.index_add_(0, ic, vc))]
        if walk is not None:
            keys, perm64 = torch.sort(ic, stable=True)

            def walk_route():
                k, p = torch.sort(ic, stable=True)
                walk(torch, k, p, v2, b2)
            fns += [("sort_and_walk", walk_route),
                    ("walk_kernel",
                     lambda: walk(torch, keys, perm64, v2, b2))]
        big = name.startswith("propagate")
        t = time_in_turns(torch, fns, 20 if big else 10, 20)
        if big:
            t["fold_plain"] = time_gpu(torch, lambda: scatter.segment_sum_plain(
                b2, order, v2), 2, 6)
            t["order_plain"] = time_gpu(
                torch, lambda: scatter.segment_order_plain(ic, t_len), 2, 10)
        t["kernels_us"] = kernel_breakdown(
            torch, lambda: (scatter.sort_index(ic, t_len),
                            scatter.segment_sum(b2, order, v2)))
        t["bound_bytes"], t["bound_chain"] = fold_bounds(idx, t_len, cols,
                                                         clock_max)
        t["order_bound_bytes"] = order_bound(m, t_len)
        t["longest_segment"] = int(np.bincount(idx).max())
        t["regime"] = scatter.regime_for(m, t_len)
        timed[name] = t
        log(f"[scatter] {name} times in turns (CUDA events, ms per call; "
            f"bounds: bytes at {HBM_BYTES_PER_S:g} B/s, chain at "
            f"{FADD_CYCLES} cycles per add at {clock_max:g} MHz, now "
            f"{clock_now:g} MHz): {json.dumps(t)}; {card}")

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch\n"
         "from lsd_slam_tpu_torch.ops import scatter\n"
         "buf = torch.zeros(4, device='cuda')\n"
         "idx = torch.tensor([0, 4, 2], device='cuda')\n"
         "scatter.ordered_index_add(buf, idx, torch.ones(3, device='cuda'))\n"
         "torch.cuda.synchronize()\n"
         "print('no error')\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    tail = (proc.stdout + proc.stderr)[-600:]
    log(f"[scatter] target 4 into 4 rows on the card: exit "
        f"{proc.returncode}, device-side assert "
        f"{'device-side assert' in proc.stderr}")
    assert proc.returncode != 0 and "no error" not in proc.stdout, tail
    assert "device-side assert" in proc.stderr, tail
    return err, order_err, timed, clock_max


def circle_graph(n, seed=7, sigma=0.01):
    """tests/test_pose_graph.py's large graph at n vertices: a circle of
    radius 2, every vertex but the first perturbed by exp(N(0, sigma)) on
    its motion coordinates, the chain, the loop closure and a closure
    every 17 vertices to the vertex 11 ahead; info 100 I. Returns
    (vertices, edges, ground truth)."""
    import torch
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.lie import np_sim3 as nps

    gt = []
    for i in range(n):
        a = 2 * np.pi * i / n
        gt.append(np.concatenate([[np.cos(a / 2), 0, np.sin(a / 2), 0],
                                  [2 * np.sin(a), 0, 2 * (1 - np.cos(a))],
                                  [1.0]]))
    rng = np.random.default_rng(seed)
    verts = [gt[0]]
    for p in gt[1:]:
        noise = np.concatenate([rng.normal(0, sigma, 6), [0.0]])
        pert = lie.sim3_exp(torch.as_tensor(noise, dtype=torch.float32))
        verts.append(nps.sim3_mul(pert.numpy().astype(np.float64), p))
    pairs = ([(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
             + [(a, a + 11) for a in range(0, n - 20, 17)])
    rel = [nps.sim3_mul(nps.sim3_inverse(gt[a]), gt[b]) for a, b in pairs]
    return verts, [(a, b, r, np.eye(7) * 100, 1e6)
                   for (a, b), r in zip(pairs, rel)], gt


def pgo_sparse_phase(torch, card):
    """Phase [pgo-sparse]: PoseGraph.optimize(12) on the circle graphs of
    tests/test_pose_graph.py:171 at 340 and 1000 vertices (above
    dense_threshold: the block-Jacobi PCG path), on the card and on the CPU
    port. Checks: every vertex within 8e-3 of the ground truth (JAX's bound
    at 340), the card within PGO_GAP of the CPU port, and host pulls = one
    per GN iteration + the final poses: no pull inside the CG loop.
    Records the scatter launches of the card's solves."""
    from lsd_slam_tpu_torch.lie import np_sim3 as nps
    from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
    from lsd_slam_tpu_torch.ops import scatter

    launches = [0, 0]
    for n in (340, 1000):
        verts, edges, gt = circle_graph(n)
        graphs = {}
        for dev in ("cuda", "cpu"):
            g = PoseGraph(device=dev)
            for i, p in enumerate(verts):
                g.add_vertex(p, fixed=(i == 0))
            for e in edges:
                g.add_edge(*e)
            if dev == "cuda":
                torch.cuda.synchronize()
                scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
            t0 = time.perf_counter()
            g.optimize(12)
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = scatter.LAUNCHES, scatter.ORDER_LAUNCHES
                launches = [a + b for a, b in zip(launches, counts)]
            graphs[dev] = (g, time.perf_counter() - t0)
        g, secs = graphs["cuda"]
        cg = g.cg_iters
        err = max(nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(p), q))
                  for p, q in zip(g.poses, gt))
        gap = max(nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(p), q))
                  for p, q in zip(g.poses, graphs["cpu"][0].poses))
        log(f"[pgo-sparse] {n} vertices, {len(edges)} edges: max |log| to "
            f"the ground truth {err:.4g} (bound 8e-3), to the CPU port "
            f"{gap:.4g} (bound {PGO_GAP:g}); {len(cg)} GN iterations, CG "
            f"iterations {cg}; {secs * 1e3:.1f} ms per solve, "
            f"{secs * 1e3 / len(cg):.1f} ms per GN iteration (CPU port "
            f"{graphs['cpu'][1] * 1e3:.1f} ms per solve); host pulls "
            f"{g.n_pulls} = {len(cg)} GN + 1, {g.n_pulls / len(cg):.2f} per "
            f"GN iteration; segment_sum launches {counts[0]}, "
            f"segment_order launches {counts[1]}; {card}")
        assert err < 8e-3, (n, err)
        assert gap < PGO_GAP, (n, gap)
        assert g.n_pulls == len(cg) + 1, (g.n_pulls, cg)
    SEGMENT_LAUNCHES["pgo-sparse"], ORDER_LAUNCHES["pgo-sparse"] = launches
    assert min(launches) > 0, launches


def appearance_phase(torch, card):
    """Phase [appearance]: the descriptor of a 640x480 frame of [slam]'s
    sequence at level 2 under all 16 rolls, card against the CPU port
    (within APPEARANCE_ATOL); then an index of 1000 keyframes on the card
    (160x120 level-2 images of six random plane waves each; the smoothed
    noise of tests/test_appearance.py's 200-keyframe test is too alike at
    1000 for the ratio test): ms per `add` and per `query`, and a noisy
    revisit of keyframe 300 rolled by 180 degrees must retrieve it (on
    the CPU port: best 0.9995, second 0.913, ratio 1.095 > 1.08). Records
    the scatter launches of the card's runs."""
    from lsd_slam_tpu_torch.frames import build_frame
    from lsd_slam_tpu_torch.mapping import appearance as app
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.utils import synth

    cam = synth.default_camera(640, 480)
    img, _ = synth.render_realistic(synth.BenchScene(seed=0), cam,
                                    synth.bench_trajectory(130)[40],
                                    frame_index=40, noise_sigma=0.0,
                                    device="cuda")
    pyr = build_frame(img, 5)
    planes = [pyr.images[2], pyr.gx[2], pyr.gy[2]]
    thetas = torch.as_tensor(np.linspace(0, 2 * np.pi, app.N_ROTATIONS,
                                         endpoint=False), dtype=torch.float32)
    scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
    got = app._descriptor_rotations(*planes, thetas.cuda())
    torch.cuda.synchronize()
    launches = [scatter.LAUNCHES, scatter.ORDER_LAUNCHES]
    want = app._descriptor_rotations(*(p.cpu() for p in planes), thetas)
    err = float((got.cpu() - want).abs().max())
    desc_ms = time_gpu(torch, lambda: app._descriptor_rotations(
        *planes, thetas.cuda()), 10, 20)
    log(f"[appearance] 640x480 level-2 descriptors ({tuple(got.shape)}), "
        f"card vs CPU port: max abs err {err:.3g} (bound "
        f"{APPEARANCE_ATOL:g}); {desc_ms:.4f} ms for the 16 rolls (CUDA "
        f"events)")
    assert err <= APPEARANCE_ATOL, err

    rng = np.random.default_rng(0)
    h, w = 120, 160
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

    def place():
        """Six plane waves of random direction, frequency and phase: each
        place has its own gradient-orientation histogram."""
        img = np.full((h, w), 128.0)
        for _ in range(6):
            th, f = rng.uniform(0, np.pi), rng.uniform(0.02, 0.12)
            img += rng.uniform(10, 30) * np.sin(
                2 * np.pi * f * (np.cos(th) * xs + np.sin(th) * ys)
                + rng.uniform(0, 2 * np.pi))
        return img

    def fake_pyr(im):
        g = np.gradient(im)
        return types.SimpleNamespace(**{
            key: {2: torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.float32, device="cuda")}
            for key, a in (("images", im), ("gx", g[1] * 2),
                           ("gy", g[0] * 2))})

    base = [place() for _ in range(1000)]
    pyrs = [fake_pyr(b) for b in base]
    index = app.AppearanceIndex(device="cuda")
    torch.cuda.synchronize()
    scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
    t0 = time.perf_counter()
    for k, p in enumerate(pyrs):
        index.add(k * 10, p)
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t0) * 1e3 / len(pyrs)
    q = fake_pyr(np.rot90(base[300], 2) + rng.normal(0, 2.0, (h, w)))
    q_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        hit = index.query(q, query_id=1_000_000)
        q_ms.append((time.perf_counter() - t0) * 1e3)
        assert hit == 3000, hit
    launches = [launches[0] + scatter.LAUNCHES,
                launches[1] + scatter.ORDER_LAUNCHES]
    log(f"[appearance] index of {len(index)} keyframes (capacity "
        f"{index._capacity}): {add_ms:.3f} ms per add, query "
        f"{statistics.median(q_ms):.3f} ms median of 5 (one (N,) pull); a "
        f"180-degree roll of keyframe 3000 retrieves {hit}; (segment_sum, "
        f"segment_order) launches {launches}; {card}")

    # the engine's merge path at full width, card against the CPU port
    scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
    got = appearance_merge(torch, "cuda")
    launches = [launches[0] + scatter.LAUNCHES,
                launches[1] + scatter.ORDER_LAUNCHES]
    want = appearance_merge(torch, "cpu")
    log(f"[appearance] find_candidates at 640x480 (use_fabmap=True, six "
        f"keyframes chained by constraints, a query rolled by 0.3 rad "
        f"whose pose drifted away): card {got}, CPU port {want}")
    assert got == want, (got, want)
    euclid, cands, fabmap_id, n_queries, n_hits = got
    assert euclid == [] and fabmap_id == 200, got
    assert cands == [100, 200, 300], got
    assert (n_queries, n_hits) == (1, 1), got
    SEGMENT_LAUNCHES["appearance"], ORDER_LAUNCHES["appearance"] = launches
    assert min(launches) > 0, launches


def appearance_merge(torch, dev):
    """tests/test_torch_appearance.py's integration case at 640x480 on
    `dev`, through SlamSystem(use_fabmap=True)'s KeyFrameGraph: six
    keyframes of PlaneScene(seed=3) along a track, each constrained to the
    one before it, then a query keyframe that sees place 2 rolled by 0.3
    rad while its pose has drifted so far that the Euclidean overlap
    search finds nothing. Returns (the Euclidean set, the candidate ids
    find_candidates returns, its appearance hit, the index's queries and
    hits): the hit and its graph neighbours are the candidates."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
    from lsd_slam_tpu_torch.frames import build_frame
    from lsd_slam_tpu_torch.mapping.keyframe_graph import Constraint
    from lsd_slam_tpu_torch.system import Keyframe, PoseNode, SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    cam = synth.default_camera(640, 480)
    scene = synth.PlaneScene(seed=3)

    def view(x, roll=0.0):
        c2w = lie.se3_mul(lie.se3_exp(torch.tensor([x, 0, 0, 0, 0, 0.0])),
                          lie.se3_exp(torch.tensor([0, 0, 0, 0, 0, roll])))
        img, dep = synth.render(scene, cam, lie.se3_inverse(c2w), device=dev)
        return build_frame(img, 5), dep

    cfg = LSDConfig(width=640, height=480).replace(
        system=SystemConfig(use_fabmap=True))
    sys_ = SlamSystem(cam, cfg, enable_slam=True, device=dev)
    graph = sys_.backend.graph
    prev = None
    for k, x in enumerate((0.0, 0.35, 0.7, 1.05, 1.4, 1.75)):
        pyr, dep = view(x)
        node = PoseNode(k * 100, sys_.registry)
        node.this_to_parent = np.array([1, 0, 0, 0, x, 0, 0, 1.0])
        kf = Keyframe(k * 100, 0.0, pyr, node, 5)
        sys_.map.initialize_from_gt(1.0 / torch.clamp_min(dep, 1e-6),
                                    pyr.max_grad[0])
        sys_._export_depth_to(kf)
        kf.idx_in_keyframes = k
        sys_.keyframes.append(kf)
        sys_.id_to_keyframe[kf.id] = kf
        if prev is None:
            graph.add_keyframe(kf)
        else:
            graph.insert_constraint(Constraint(
                prev, kf, np.array([1, 0, 0, 0, 0.35, 0, 0, 1.0]),
                np.eye(7) * 100, 1.0))
        prev = kf
    pyr, _ = view(0.7, roll=0.3)
    node = PoseNode(9999, sys_.registry)
    node.this_to_parent = np.array([1, 0, 0, 0, 100.0, 100.0, 0, 1.0])
    query = Keyframe(9999, 0.0, pyr, node, 5)
    query.mean_idepth = 1.0
    euclid = graph.find_euclidean_overlap_frames(
        node.this_to_parent, 1.0, 15.0 / 16.0, 0.75, True)
    cands, fabmap_id = graph.find_candidates(query, 1.0)
    return ([f.id for f, _, _ in euclid], sorted(cands), fabmap_id,
            graph.appearance.n_queries, graph.appearance.n_hits)


WARMUP_TAG = "[warmup-run] "


def warmup_run(mode: str) -> int:
    """`chip_smoke.py --warmup-run with|without`, in a fresh process: the
    first frames of [slam]'s sequence (rendered on the host) into a new
    640x480 engine on the card, with or without `warmup(cam, cfg)` first;
    prints the ms of the engine's first calls, and warm-up's own report
    and kernel launches, as the last line."""
    import torch
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.system import SlamSystem, warmup
    from lsd_slam_tpu_torch.utils import synth

    cam = synth.default_camera(640, 480)
    cfg = LSDConfig()
    scene = synth.BenchScene(seed=0)
    poses = synth.bench_trajectory(130)
    frames = [[a.numpy() for a in synth.render_realistic(
        scene, cam, poses[i], frame_index=i, noise_sigma=0.0, device="cpu")]
        for i in range(4)]
    out = dict(mode=mode)
    if mode == "with":
        stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        out["warmup"] = warmup(cam, cfg)
        out["warmup_fused"] = stencil.FUSED_LAUNCHES
        out["warmup_segment_sum"] = scatter.LAUNCHES
        out["warmup_segment_order"] = scatter.ORDER_LAUNCHES
    t0 = time.perf_counter()
    sys_ = SlamSystem(cam, cfg)
    sys_.gt_depth_init(frames[0][0], frames[0][1], 0, 0.0)
    torch.cuda.synchronize()
    out["init_ms"] = (time.perf_counter() - t0) * 1e3
    out["frame_ms"] = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        sys_.track_frame(frames[i][0], i, i / 30.0)
        torch.cuda.synchronize()
        out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
    log(WARMUP_TAG + json.dumps(out))
    return 0


def warmup_phase(card):
    """Phase [warmup]: `--warmup-run` without, then with warm-up, each in a
    fresh process; returns warm-up's fused launches and records its
    scatter launches."""
    got = {}
    for mode in ("without", "with"):
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--warmup-run", mode], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"--warmup-run {mode} exit "
                               f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        last = proc.stdout.splitlines()[-1]
        assert last.startswith(WARMUP_TAG), proc.stdout[-3000:]
        got[mode] = json.loads(last[len(WARMUP_TAG):])
    w = got["with"]
    log(f"[warmup] a fresh process, 640x480: without warm-up gt_depth_init "
        f"{got['without']['init_ms']:.1f} ms, first frame steps "
        f"{[round(x, 1) for x in got['without']['frame_ms']]} ms; after "
        f"warmup(cam, cfg) ({w['warmup']}, {w['warmup_fused']} fused and "
        f"{w['warmup_segment_sum']} segment_sum and "
        f"{w['warmup_segment_order']} segment_order launches) gt_depth_init "
        f"{w['init_ms']:.1f} ms, first frame steps "
        f"{[round(x, 1) for x in w['frame_ms']]} ms; {card}")
    assert w["warmup"]["keyframes"] >= 2 and w["warmup"]["reloc_warmed"]
    assert w["warmup_fused"] > 0 and w["warmup_segment_sum"] > 0
    assert w["warmup_segment_order"] > 0
    SEGMENT_LAUNCHES["warmup"] = w["warmup_segment_sum"]
    ORDER_LAUNCHES["warmup"] = w["warmup_segment_order"]
    return w["warmup_fused"]


def check_kernels(torch, stencil, reg_dist_var, diff_facs, validity_th):
    """Both entries against their plain versions at every shape and each
    of `diff_facs`; returns the max abs error of each."""
    rng = np.random.default_rng(0)
    err_acc = err_fused = 0.0
    for (h, w), diff_fac in itertools.product(SHAPES, diff_facs):
        e = compare_stencil(torch, stencil, random_planes(rng, h, w),
                            reg_dist_var, diff_fac)
        err_acc = max(err_acc, e)
        log(f"[kernel] regularize_accumulators {h}x{w} diff_fac={diff_fac}: "
            f"ok, max abs err {e:g}")
        st = random_state(torch, rng, h, w)
        for occ in (False, True):
            e, deleted, kept = compare_fused(torch, stencil, st, reg_dist_var,
                                             diff_fac, validity_th, occ)
            err_fused = max(err_fused, e)
            log(f"[kernel] regularize_fused {h}x{w} diff_fac={diff_fac} "
                f"remove_occlusions={occ}: ok, max abs err {e:g} ({deleted} "
                f"deleted, {kept} kept)")
    return err_acc, err_fused


def time_kernels(torch, stencil, reg_dist_var, diff_fac, validity_th,
                 baseline):
    """CUDA-event ms per call at 480x640 of both entries and their plain
    versions, L2-warm and cold, the host us per regularize() call, fused
    and unfused, and `baseline` (another build of the accumulators entry,
    or None) in turns with the current one."""
    h, w = 480, 640
    rng = np.random.default_rng(1)
    acc_sets = [[torch.as_tensor(p, device="cuda")
                 for p in random_planes(rng, h, w)]
                for _ in range(-(-COLD_BYTES // (16 * h * w)))]
    fused_sets = [random_state(torch, rng, h, w)
                  for _ in range(-(-COLD_BYTES // (25 * h * w)))]
    planes, st = acc_sets[0], fused_sets[0]
    # one set per call, in turn: with more bytes in all than L2 holds, each
    # call finds its inputs in device memory (cold)
    next_acc = functools.partial(next, itertools.cycle(acc_sets))
    next_fused = functools.partial(next, itertools.cycle(fused_sets))

    def acc(p):
        return stencil.regularize_accumulators(*p, reg_dist_var, diff_fac)

    def fused(x):
        return stencil.regularize_fused(*x, reg_dist_var, diff_fac,
                                        validity_th, False)

    def unfused(x):
        """regularize() unfused: valid to f32, the accumulators kernel, the
        torch epilogue."""
        sums = stencil.regularize_accumulators(
            x[0], x[1], x[2].to(torch.float32), x[3], reg_dist_var, diff_fac)
        return stencil.regularize_epilogue(*sums, x[2], x[4], x[5], x[6],
                                           validity_th, False)

    t = {}
    t["acc_warm"] = time_gpu(torch, lambda: acc(planes), 50, 60)
    t["acc_cold"] = time_gpu(torch, lambda: acc(next_acc()), 50, 60)
    # no pixel valid: no reciprocals staged and no tap adds, the same grid
    none_valid = [*planes[:2], torch.zeros_like(planes[2]), planes[3]]
    t["acc_warm_none_valid"] = time_gpu(torch, lambda: acc(none_valid), 50,
                                        60)
    t["fused_warm"] = time_gpu(torch, lambda: fused(st), 50, 60)
    t["fused_cold"] = time_gpu(torch, lambda: fused(next_fused()), 50, 60)
    t["acc_plain"] = time_gpu(
        torch, lambda: stencil.regularize_accumulators_plain(
            *planes, reg_dist_var, diff_fac), 5, 30)
    t["fused_plain"] = time_gpu(
        torch, lambda: stencil.regularize_plain(
            *st, reg_dist_var, diff_fac, validity_th, False), 5, 30)
    t["unfused_warm"] = time_gpu(torch, lambda: unfused(st), 20, 30)
    t["host_us_fused"] = host_us_per_call(torch, lambda: fused(st))
    t["host_us_unfused"] = host_us_per_call(torch, lambda: unfused(st))
    for k, v in t.items():
        log(f"[kernel] 480x640 {k}: {v:.5f}"
            + (" us" if k.startswith("host") else " ms"))
    if baseline is not None:
        old = {}
        for tag, pick in (("warm", lambda: planes), ("cold", next_acc)):
            res = time_in_turns(torch, (
                ("old", lambda: launch_baseline(torch, stencil, baseline,
                                                pick(), reg_dist_var,
                                                diff_fac)),
                ("new", lambda: acc(pick()))), 50, 60)
            old[f"old_{tag}"], old[f"new_{tag}"] = res["old"], res["new"]
        got = launch_baseline(torch, stencil, baseline, planes, reg_dist_var,
                              diff_fac)
        old["bit_identical"] = all(torch.equal(a, b)
                                   for a, b in zip(got, acc(planes)))
        log(f"[kernel] baseline vs current, in turns old,new,new,old: "
            f"{json.dumps(old)}")
        t["baseline"] = old
    return t


def bound(bytes_per_px, flops_per_px, h=480, w=640):
    t_bytes = bytes_per_px * h * w / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_px * h * w / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pipeline_turns(torch, card):
    """The lag-3 bench sequence at lag 0 and lag 3 in turns (0, 3, 3, 0):
    frames per second over frames 1..N-1 (ring drained), the frame step's
    and the tracker's median dispatch ms, the pack pull's, syncs per
    frame."""
    ref = load_ref(SLAM_RUNS["slam-pipelined"][0])
    n = ref["n_frames"]
    for lag in (0, 3, 3, 0):
        run = run_slam(torch, dict(ref, pipeline_lag=lag), sync_each=False)
        st, tm = run.sys.stats.snapshot(), run.sys.timers
        syncs = sum(st.get(k, 0) for k in SYNC_KEYS)
        log(f"[pipeline-turns] lag {lag}: frames 1..{n - 1} in "
            f"{run.track_s:.3f} s ({(n - 1) / run.track_s:.3f} fps); "
            f"medians frame_step {tm.median('frame_step'):.1f} ms, track "
            f"{tm.median('track'):.1f}, observe {tm.median('observe'):.1f}, "
            f"retire_pull {tm.median('retire_pull'):.2f}, switch "
            f"{tm.median('switch'):.1f}; keyframes "
            f"{[kf.id for kf in run.sys.keyframes]}; syncs per frame "
            f"{syncs / (len(run.sys.all_frame_poses) + 1):.2f}; {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-cu",
                    help="an earlier stencil source to time against")
    ap.add_argument("--baseline-segment-cu",
                    help="the sort-and-walk segment_sum.cu of commit "
                    "7824632 (checked by its sha256), to time its route "
                    "(stable torch.sort + its kernel) in turns in "
                    "[scatter]")
    ap.add_argument("--pipeline-turns", action="store_true",
                    help="only time lag 0 against lag 3, in turns")
    ap.add_argument("--counted-runner", nargs=argparse.REMAINDER,
                    metavar="ARG", help="run io.runner.main(ARG...) with "
                    "the kernel counts as the last line ([cli] uses it)")
    ap.add_argument("--warmup-run", choices=("with", "without"),
                    help="time a fresh engine's first frames with or "
                    "without warm-up ([warmup] uses it)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "lsd_slam_tpu_torch")):
        # never fall back to a copy of the port installed elsewhere
        print(f"chip_smoke: no lsd_slam_tpu_torch/ beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.counted_runner is not None:
        return counted_runner(args.counted_runner)
    if args.warmup_run:
        return warmup_run(args.warmup_run)
    from lsd_slam_tpu_torch.ops import build
    from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    t_start = time.perf_counter()

    def phase_done(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    # ---- 1. device ----
    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    extra = {}
    if args.baseline_cu:
        extra["baseline"] = os.path.abspath(args.baseline_cu)
    if args.baseline_segment_cu:
        with open(args.baseline_segment_cu, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != SORT_AND_WALK_SHA256:
            print(f"chip_smoke: {args.baseline_segment_cu} (sha256 {digest}) "
                  "is not the sort-and-walk segment_sum.cu of commit "
                  "7824632, the only source whose ABI --baseline-segment-cu "
                  "binds", file=sys.stderr)
            return 2
        extra["segment_sum_walk"] = os.path.abspath(args.baseline_segment_cu)
    secs = build.build(verbose=True, sources=extra)
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s")
    if args.pipeline_turns:
        pipeline_turns(torch, card)
        return 0
    baseline = walk = None
    if "segment_sum_walk" in extra:
        walk = bind_walk_segment_sum(ctypes.CDLL(str(build.library_path(
            "segment_sum_walk", extra["segment_sum_walk"]))))
    if "baseline" in extra:
        lib = build.library_path("baseline", extra["baseline"])
        baseline = stencil.bind(ctypes.CDLL(str(lib)),
                                "lsd_regularize_accumulators")

    # ---- 3. kernel check and timings ----
    from lsd_slam_tpu_torch.config import LSDConfig
    dcfg = LSDConfig().depth
    reg_dist_var = float(dcfg.reg_dist_var_base)
    diff_fac = float(dcfg.diff_fac_smoothing)
    # raised from val_sum_min_for_keep so that the random states also
    # delete hypotheses (tests/test_torch_regularize.py does the same)
    check_th = 10.0 * dcfg.val_sum_min_for_keep
    err_acc, err_fused = check_kernels(torch, stencil, reg_dist_var,
                                       (diff_fac, 2.0), check_th)
    t = time_kernels(torch, stencil, reg_dist_var, diff_fac,
                     float(dcfg.val_sum_min_for_keep), baseline)
    acc_bound, acc_by = bound(36, 25 * 12)
    fused_bound, fused_by = bound(38, 25 * 12 + 10)
    log(f"[kernel] 480x640 bounds: accumulators {acc_bound:.5f} ms "
        f"({acc_by}), fused {fused_bound:.5f} ms ({fused_by})")
    seg_err, order_err, seg_t, sm_clock = scatter_phase(torch, card, walk)

    phase_done("build, kernels and scatter")

    # ---- 13., 14., 16. sparse PGO, appearance index, warm-up ----
    pgo_sparse_phase(torch, card)
    phase_done("pgo-sparse")
    appearance_phase(torch, card)
    phase_done("appearance")
    warm_fused = warmup_phase(card)
    phase_done("warmup")

    # ---- 4. VO at full width ----
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "vo_orbit_640x480.json")) as f:
        ref = json.load(f)
    with counted_plain(stencil) as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        sys_, poses, frame_ms, total_s = run_vo(torch, ref, profile=False)
        launches, fused_launches = stencil.LAUNCHES, stencil.FUSED_LAUNCHES
        SEGMENT_LAUNCHES["vo"] = scatter.LAUNCHES
        ORDER_LAUNCHES["vo"] = scatter.ORDER_LAUNCHES
    st = sys_.stats.snapshot()
    n = ref["n_frames"]
    traj = sys_.trajectory_array()
    ate = float(ate_rmse(traj, poses))
    jref = np.asarray(ref["trajectory_c2w_sim3"])
    assert traj.shape == jref.shape, (traj.shape, jref.shape)
    dc = np.linalg.norm(traj[:, 4:7] - jref[:, 4:7], axis=1)
    da = np.asarray([rotation_angle(a[0:4], b[0:4])
                     for a, b in zip(traj, jref)])
    kfs = [kf.id for kf in sys_.keyframes]
    created = int(st.get("keyframes_created", 0))
    syncs = (st.get("host_syncs", 0) + st.get("lm_syncs", 0)
             + st.get("export_syncs", 0) + st.get("switch_syncs", 0))
    steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
    log(f"[vo] N={n} {ref['width']}x{ref['height']} keyframes={kfs} "
        f"(reference {ref['keyframe_ids']}) created={created} "
        f"ATE={ate:.6g} (reference {ref['ate']:.6g})")
    log(f"[vo] max |centre - ref| {dc.max():.3g}, max rot diff "
        f"{da.max():.3g} rad, bound {TRAJ_BOUND:g}")
    log(f"[vo] fps {len(steady) / (sum(steady) / 1e3):.3f} (frames 2..N-1), "
        f"p50 {np.percentile(frame_ms, 50):.3f} ms, p95 "
        f"{np.percentile(frame_ms, 95):.3f} ms, first "
        f"{frame_ms[0]:.1f} ms, total {total_s:.2f} s")
    log(f"[vo] host syncs per tracked frame {syncs / max(n - 1, 1):.2f} "
        f"(pack pulls {st.get('host_syncs', 0):.0f}, LM trial flags "
        f"{st.get('lm_syncs', 0):.0f}, exports "
        f"{st.get('export_syncs', 0):.0f}, switch rescales "
        f"{st.get('switch_syncs', 0):.0f})")
    log(f"[vo] regularize_fused launches {fused_launches}, "
        f"regularize_accumulators launches {launches}, plain-version calls "
        f"{plain_calls[0]}, segment_sum launches {SEGMENT_LAUNCHES['vo']}, "
        f"segment_order launches {ORDER_LAUNCHES['vo']}, "
        f"over {n - 1} tracked frames")
    log(f"[vo] stage ms (dispatch windows): {sys_.timers.summary()}")
    assert sys_.tracking_is_good, "tracking lost"
    assert created >= 1, "no keyframe switch"
    # one per tracked frame, two per switch frame instead of one, one at
    # finalize
    assert fused_launches >= n + created, (
        f"regularize_fused launched {fused_launches} < {n + created}")
    assert launches == 0 and plain_calls[0] == 0, (launches, plain_calls)
    assert ate < 0.01, f"ATE {ate}"
    assert dc.max() <= TRAJ_BOUND and da.max() <= TRAJ_BOUND, (
        f"trajectory off the JAX reference: centre {dc.max()}, "
        f"rotation {da.max()}")

    # both entries once more on the main path's own final state
    s = sys_.map.state
    vo_state = [s.idepth, s.var, s.valid, s.validity, s.idepth_smoothed,
                s.var_smoothed, s.blacklisted]
    err_acc = max(err_acc, compare_stencil(
        torch, stencil, [s.idepth, s.var, s.valid.float(), s.validity],
        reg_dist_var, diff_fac))
    for occ in (False, True):
        e, deleted, kept = compare_fused(
            torch, stencil, vo_state, reg_dist_var, diff_fac,
            float(dcfg.val_sum_min_for_keep), occ)
        err_fused = max(err_fused, e)
        log(f"[kernel] regularize_fused on the final VO state, "
            f"remove_occlusions={occ}: ok, max abs err {e:g} ({deleted} "
            f"deleted, {kept} kept)")
    vo_state_ms = time_gpu(torch, lambda: stencil.regularize_fused(
        *vo_state, reg_dist_var, diff_fac, float(dcfg.val_sum_min_for_keep),
        False), 50, 60)
    log(f"[kernel] regularize_fused on the final VO state "
        f"({s.valid.float().mean().item():.4f} valid): {vo_state_ms:.5f} ms")

    # profiled pass: stage timers synchronise, so each stage is device time
    psys, _, pframe_ms, _ = run_vo(torch, ref, profile=True)
    log(f"[vo-profiled] p50 {np.percentile(pframe_ms, 50):.3f} ms; stages: "
        f"{psys.timers.summary()}")
    trace_device(torch, "vo-trace",
                 lambda: run_vo(torch, ref, profile=False)[-1],
                 ref["n_frames"] - 1, 10)

    phase_done("VO")

    # ---- 5. SLAM at full width ----
    log(f"[slam] card: {card}")
    slam_fused, slam_state, busy_share = slam_phase(
        torch, stencil, functools.partial(counted_plain, stencil), "slam",
        trace=True)
    for occ in (False, True):
        e, deleted, kept = compare_fused(
            torch, stencil, slam_state, reg_dist_var, diff_fac,
            float(dcfg.val_sum_min_for_keep), occ)
        err_fused = max(err_fused, e)
        log(f"[kernel] regularize_fused on the final SLAM state, "
            f"remove_occlusions={occ}: ok, max abs err {e:g} ({deleted} "
            f"deleted, {kept} kept)")

    phase_done("SLAM")

    # ---- 6. SLAM with a loop closure, 160x128 ----
    loop_fused, _, _ = slam_phase(
        torch, stencil, functools.partial(counted_plain, stencil),
        "slam-loop", trace=False)

    phase_done("SLAM loop")

    # ---- 7. the multi-reference sweep, card against the CPU port ----
    multi_fused, multi_err, multi_flips = observe_multi_phase(
        torch, stencil, functools.partial(counted_plain, stencil),
        MULTI_BOUND)
    phase_done("observe-multi")

    # ---- 8. pipelined SLAM (lag 3), against its JAX reference ----
    log(f"[slam-pipelined] card: {card}")
    pipe_fused, _, pipe_share = slam_phase(
        torch, stencil, functools.partial(counted_plain, stencil),
        "slam-pipelined", trace=True)
    phase_done("SLAM pipelined")

    # ---- 9. and 10. the threaded modes, held to properties ----
    prod_fused = threaded_phase(torch, stencil,
                                functools.partial(counted_plain, stencil),
                                "slam-production")
    phase_done("SLAM production")
    threads_fused = threaded_phase(torch, stencil,
                                   functools.partial(counted_plain, stencil),
                                   "slam-threads")
    phase_done("SLAM threads")

    # ---- 15. SLAM with the appearance index ----
    log(f"[slam-fabmap] card: {card}")
    fab_fused, _, _ = slam_phase(
        torch, stencil, functools.partial(counted_plain, stencil),
        "slam-fabmap", trace=False)
    phase_done("slam-fabmap")

    # ---- 11. and 12. the product surface: undistortion, the runner ----
    undistort_phase(torch, card)
    phase_done("undistort")
    cli_fused = cli_phase(torch, card)
    phase_done("cli")


    prop = seg_t["propagate-640x480"]
    seg_common = dict(
        source="lsd_slam_tpu_torch/csrc/segment_sum.cu",
        replaces="lsd_slam_tpu/depth/regularize.py:239-244 (XLA's "
                 "scatter-add in propagate; no Pallas counterpart)",
        also_replaces=["lsd_slam_tpu/mapping/pose_graph.py:57-63",
                       "lsd_slam_tpu/mapping/sparse_pgo.py:69-93",
                       "lsd_slam_tpu/mapping/appearance.py:93-105"],
        shape="propagate 640x480, pass 2's (M, 4) call",
        sm_clock_mhz=sm_clock)
    common = dict(route="cuda",
                  source="lsd_slam_tpu_torch/csrc/regularize_stencil.cu",
                  replaces="lsd_slam_tpu/ops/pallas_stencil.py:94",
                  library_ms=None)
    log(json.dumps({"kernels": [
        dict(name="regularize_fused", **common,
             launches=(fused_launches + slam_fused + loop_fused
                       + multi_fused + pipe_fused + prod_fused
                       + threads_fused + sum(cli_fused.values())
                       + fab_fused + warm_fused),
             vo_launches=fused_launches, slam_launches=slam_fused,
             slam_loop_launches=loop_fused,
             observe_multi_launches=multi_fused,
             slam_pipelined_launches=pipe_fused,
             slam_production_launches=prod_fused,
             slam_threads_launches=threads_fused,
             cli_launches=cli_fused,
             slam_fabmap_launches=fab_fused, warmup_launches=warm_fused,
             slam_busy_share=busy_share,
             slam_pipelined_busy_share=pipe_share,
             observe_multi_max_abs_err=multi_err,
             observe_multi_dither_flips=multi_flips,
             max_abs_err=err_fused,
             ms=t["fused_warm"], kernel_ms=t["fused_warm"],
             cold_ms=t["fused_cold"], plain_ms=t["fused_plain"],
             bound_ms=fused_bound, bound_by=fused_by,
             host_us_per_call=t["host_us_fused"],
             unfused_host_us_per_call=t["host_us_unfused"],
             unfused_ms=t["unfused_warm"], vo_state_ms=vo_state_ms,
             library_note="no single PyTorch call computes regularize()",
             also_replaces="lsd_slam_tpu/depth/regularize.py:99-118"),
        dict(name="regularize_accumulators", **common,
             launches=launches, max_abs_err=err_acc,
             ms=t["acc_warm"], kernel_ms=t["acc_warm"],
             cold_ms=t["acc_cold"], plain_ms=t["acc_plain"],
             bound_ms=acc_bound, bound_by=acc_by,
             none_valid_ms=t["acc_warm_none_valid"],
             baseline=t.get("baseline"),
             library_note="no single PyTorch call computes the five "
                          "accumulators; off the main path since "
                          "regularize() calls the fused entry"),
        dict(name="segment_sum", route="cuda", **seg_common,
             launches=sum(SEGMENT_LAUNCHES.values()),
             path_launches=SEGMENT_LAUNCHES, max_abs_err=seg_err,
             ms=prop["fold"], plain_ms=prop["fold_plain"],
             bound_ms=prop["bound_bytes"], bound_by="bytes",
             chain_bound_ms=prop["bound_chain"],
             library_ms=prop["atomic_index_add"],
             library_note="index_add_ (atomic adds, order not fixed)",
             order_and_fold_ms=prop["order_and_fold"],
             sort_and_walk_ms=prop.get("sort_and_walk"),
             walk_kernel_ms=prop.get("walk_kernel"), shapes=seg_t),
        dict(name="segment_order", route="cuda", **seg_common,
             entry="lsd_segment_order (count, scan, place and sort kernels)",
             launches=sum(ORDER_LAUNCHES.values()),
             path_launches=ORDER_LAUNCHES, max_abs_err=order_err,
             ms=prop["order"], plain_ms=prop["order_plain"],
             bound_ms=prop["order_bound_bytes"], bound_by="bytes",
             library_ms=prop["torch_sort"],
             library_note="torch.sort(idx, stable=True)"),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
