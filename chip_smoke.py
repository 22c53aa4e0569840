#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lsd_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (21, 13, 17, 14 and 16 run right after 3, 19 and 20 after 4, 15
after 10, 18 inside 12); any failure
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
               TRAJ_BOUND of the JAX reference frame by frame; every
               track's final pass inside its last `lm_level` launch
               (`track_final_fused` equals `frames_tracked`, and the plain
               `final_pass_plain` is counted as a plain version). On the
               last track (`track_final_phase`): its launches and host us
               against `track_plain`'s, the last level's ms with and
               without the epilogue, and the fused pass against the plain
               one run on the CPU at the kernel's pose (good mask bit for
               bit, counts exact). A second,
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
 17. mesh    — parallel/distributed.py in this process on
               `make_mesh(4, device="cuda")`, four shards of one card (no
               NCCL collective runs): the gathered dense assembly of a
               64-vertex circle graph equals `_assemble` bit for bit;
               `PoseGraph(mesh)` (mesh_min_edges = 0, the sharded PCG step)
               on [pgo-sparse]'s 1000-vertex circle within 8e-3 of the
               ground truth and PGO_GAP of the one-device sparse solve; the
               sharded quick track of 64 lanes at 640x480 in both
               directions against the unsharded batch (flags equal,
               ref_to_frame within QUICK_BOUND); every second pass bit for
               bit; segment kernels launched, no plain version; ms per
               assembly, solve and quick batch, mesh against one device.
               On a host with more than one card the shards spread over
               the cards in turn (cross-card copies, each shard's kernels
               on its own card), and [multihost-nccl] follows: one process
               per card (NCCL by `pick_backend`'s rule, `--pgo-rank`) runs
               the SPMD CG PGO of [pgo-sparse]'s 1000-vertex circle, whose
               poses must equal the same program on the one-process mesh
               of one shard per card bit for bit. One card skips it.
 18. multihost — inside [cli], after its hz:0 runs: the runner on the same
               folder in two fresh processes started together on the card
               (`--multihost-gates --counted-runner ... multihost:R:2:P:Q`,
               gloo: the two ranks share the card), both exit 0, rank 1
               prints `multihost worker done`; rank 0's keyframe ids and
               edge pairs equal [cli]'s in-process run's and its TUM rows
               lie within 5e-3 of them; the frontend fanned out and ran the
               SPMD PGO; rank 0 launches regularize_fused, both ranks the
               segment kernels, neither a plain version; the backend each
               rank logged, the pair's fps beside [cli]'s hz:0 fps.
 19. lm      — the trackers' LM level kernel `lm_level` against its plain
               version (`tracking.lm.level_plain`) on the card: the four
               levels of [vo]'s last tracked frame, on the inputs the main
               path gave the kernel (B = 1), and the quick schedule over 64
               lanes on [vo]'s level-4 inputs from disturbed inits, both
               batch directions; the bounds of tests/test_torch_lm.py (pose
               2e-5, error 1e-4 relative, affine 1e-3, flags and trial and
               accept counts equal) hold on every level and lane, and a
               second launch gives the same bits; on [mesh]'s 64 lanes
               (a point set or layout of their own per lane) the same
               bounds against the plain loop on the CPU, on every lane
               its f64-summing and reordered runs agree with it
               (`mesh_witness`); every case launched again at every
               power-of-two cluster size the card schedules gives the same
               bits, with the chosen cluster size, the sum tree's chunks and
               each block's staged points and shared memory logged;
               CUDA-event ms of kernel and plain loop per level and batch
               (and of the kernel at each cluster size), beside the bound
               (`lm_bound`: each input read once, the passes the inputs
               needed in operations), and at [vo]'s levels
               the kernel's own clock stamps: the median sweep, fold and
               tail of a pass. Every card path
               ([vo], the SLAM phases, [cli], [multihost], [warmup],
               [mesh]) launches `lm_level` and calls no plain LM loop, its
               launches by cluster size are logged, [vo] and the SLAM
               phases launch clusters of more than one block, and pull no
               SE(3) or quick LM flag. Then the Sim(3) cases
               (`sim3_phase`): every `sim3_level` launch of [slam]'s first
               constraint search that runs all three stages (its scenario
               replayed up to there; four launches, one a level, each over
               both directions with the lanes as the engine padded them,
               each stage's last with the final pass after its loop), each
               direction against its plain version run on the CPU (the
               bounds in SIM3_POSE_ATOL..., on the lanes the CPU's plain
               loop settles), the fused final pass giving the bits of the
               final pass launched alone, a second launch and every
               cluster size giving the same bits (the card's active
               clusters at each size logged, every launch's clusters all
               resident), CUDA-event ms per launch, per stage and per
               search beside `sim3_bound`, and the kernel's clock stamps
               (sweep, fold, tail per pass). The SLAM phases, [cli]'s
               runner runs, [multihost] and [warmup] count `sim3_level`
               launches (one a level of every stage a search reached) and
               pull no Sim(3) LM flag.
 20. epl     — the observe sweep's three kernels (csrc/epl_stereo.cu:
               `epl_prepare`, the per-pixel set-up; `epl_stereo`, the EPL
               search of the compacted points; `observe_fuse`, the EKF
               fusion and its counts) on [vo]'s sweep of the most active
               points as the engine passed it and on [observe-multi]'s
               inputs at K = 1, 3 and 8 and at K = 3 on a mixed state
               (invalidated pixels, blacklist counters and high variances,
               so creation, blacklisting and kills run): each kernel
               against its plain version run on the CPU from the same
               inputs (the card's set-up, compaction and results; the
               fusion on every pixel, its counts equal), and the whole
               sweep (`observe` / `observe_multi`) on the card against the
               CPU port, under tests/test_torch_observe.py's bounds
               (EPL_SHARE, EPL_RTOL, EPL_COUNTER_RTOL) on every pixel but
               those whose fusion inputs differ in bits (`inputs_apart`);
               the share of bit-equal points logged, also against the
               plain versions with a correctly rounded sqrt
               (`rounded_sqrt`); a second launch of each and a second
               sweep bit for bit; CUDA-event ms of each kernel and of its plain version on
               the card beside its bound (`epl_bounds`), the whole sweep's
               device ms and host us per sweep against the plain route;
               `epl_stereo` with no code apart from the plain version and
               every point bit-equal with a correctly rounded sqrt, no
               host wait in the sweep; the sweep again with the CPU's
               frame terms copied to the card, its pixels off each
               reference logged. On every case's set-up and compaction
               the search at every group size (EPL_GROUPS: the source
               built at each other kGroup) gives the package kernel's
               bits on every slot, their ms in turns and each one's clock
               stamps (the median cycles of a slot's gathers, endpoints,
               lattice, scans and tail). Then [vo]'s sweep built to tie
               and to hold NaNs (`ties_case`), and K = 10's two chunks:
               chunk 1 on the card and on the CPU port, chunk 2 from the
               CPU's chunk-1 state on both, every group size on each of
               the card's three chunk sweeps. Every
               card path ([vo], the SLAM phases, [observe-multi], [cli],
               [multihost], [warmup]) launches the three kernels, once a
               sweep each, and calls no plain version of the sweep
               (OBSERVE_PLAIN).
 21. fill-holes — the hole fill's kernel (csrc/fill_holes.cu, entry
               `lsd_fill_holes`: a launch over bands of 16 rows, then one
               over 32x32 tiles) against its plain version
               (`fill_holes_plain`, ~400 torch operations) on the card at
               640x480, 752x480 and 160x128: all six planes bit for bit;
               CUDA-event ms of both beside the bound (FILL_BYTES_PER_PX),
               host us per call, and torch.profiler's count of the kernel
               launches and device operations inside one call of each, with
               the kernel's device us by pass. [vo] counts its launches: one
               an observe sweep, one or two a keyframe switch, at most one
               at finalize (`check_fill_launches`); `counted_plain` counts
               `fill_holes_plain` with the other plain versions, so no card
               path calls it.
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
its kernel counts as the last line (what [cli] runs for each runner call);
`--multihost-gates` before it lowers the multi-process gates
([multihost]).

    python3 chip_smoke.py --warmup-run with|without

times a fresh engine's first calls with or without warm-up first and
prints them as the last line (what [warmup] runs in each process).

    python3 chip_smoke.py --lm-only [--baseline-lm-cu BASELINE.cu]
                                   [--baseline-sim3-cu BASELINE.cu]

runs only the build, [vo] (its LM level inputs recorded) and [lm], its
Sim(3) cases included: one short call. `--baseline-lm-cu baselines/lm_track_04f70d1_stamped.cu`
(here or in the full run) also builds that file, commit 04f70d1's
csrc/lm_track.cu (one block per lane) with the stamp buffer added
(`lsd_lm_level(17 pointers, lanes, params, stream)`; any other file is
refused, by its sha256, before anything is built), and at [vo]'s levels
prints its phase split, whether it gives the current kernel's bits, and
its ms in turns with the current kernel.

`--baseline-sim3-cu baselines/sim3_track_681971f_stamped.cu` (here or in
the full run) also builds that file, commit 681971f's csrc/sim3_track.cu
(a launch per direction and level, the final pass a launch of its own)
with the stamp buffer added (any other file is refused, by its sha256),
and at every launch of [lm]'s Sim(3) cases checks that it gives the same
bits on every lane at every cluster size, prints its phase split per
direction and its ms in turns with the current kernel (and the search's).

    python3 chip_smoke.py --epl-only [--baseline-epl-cu BASELINE.cu]

runs only the build, [vo] (its sweeps recorded) and [epl]: one short
call. `--baseline-epl-cu baselines/epl_stereo_2bd7213.cu` (here or in the
full run) also builds that file, commit 2bd7213's csrc/epl_stereo.cu (the
search one thread a slot) with the search's clock stamps added (any other
file is refused, by its sha256), and runs its search beside the others on
every [epl] case: the same bits on every slot, its stamp split, its ms in
turns.

    python3 chip_smoke.py --epl-turns

runs only the build and --lm-turns' sequences with the observe sweep on
its kernels and on its plain torch route, in turns (kernel, plain, plain,
kernel): fps, frame ms, the track and observe stages, switch frames.

    python3 chip_smoke.py --fill-only

runs only the build, [fill-holes] and [vo]'s run with the hole fill's
launches counted and no plain version called: one short call.

    python3 chip_smoke.py --threads-repeat N

runs only [slam-threads] and [slam-production], N times each (the
threaded modes are not deterministic), and prints whether each run holds
its phase's bars; it exits non-zero if one does not.

    python3 chip_smoke.py --lm-turns

runs only the build and [vo]'s, [slam]'s and [slam-pipelined]'s sequences
with the LM loops on the kernels, with only the Sim(3) loop on its plain
version, and with every LM loop (SE(3), quick and Sim(3)) on its plain
version, in turns (kernel, sim3-plain, plain, plain, sim3-plain, kernel):
fps, frame p50 / p95,
the track stage, the switch frames, the constraint search, syncs per
frame; the plain route stands for the earlier host loops (a flag pull per
trial).

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
import math
import re
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
# launches of the trackers' LM level kernel (`lm_level`) in each path's run,
# and those launches by cluster size (blocks per lane)
LM_LAUNCHES = {}
LM_CLUSTERS = {}
# launches of the Sim(3) tracker's level kernel (`sim3_level`: its LM loops
# and final passes) in each path's run, and by cluster size
SIM3_LAUNCHES = {}
SIM3_CLUSTERS = {}
# launches of the observe sweep's kernels (`epl_prepare`, `epl_stereo`,
# `observe_fuse`: ops.epl_stereo.counts()) in each path's run
EPL_LAUNCHES = {}
# [epl], each kernel and each whole sweep against its plain version run on
# the CPU from the same inputs: the bounds of tests/test_torch_observe.py
# (codes and masks off on at most 0.2% of the points, inverse depths,
# variances and EPL lengths to rtol 1e-4 where the codes agree, validity
# counters and next-id fields to rtol 1e-6). The fusion's new state is held
# on every pixel, its counts equal; in the whole sweep every pixel is held
# but those whose fusion inputs differ in bits (`inputs_apart`), of which at
# most 0.2% of the active points may be off (`check_state`)
EPL_SHARE, EPL_RTOL, EPL_COUNTER_RTOL = 0.002, 1e-4, 1e-6
# the f32 operations of one searched slot, counted from csrc/epl_stereo.cu:
# 43 bilinear samples (clamps, group base, weights: ~24 each), the 34 x 5
# SSD terms of each of the two scans (3 each), the endpoints, crop, pad and
# clamp (~90), subpixel refinement (~60), triangulation and variance (~50)
EPL_OPS_PER_SLOT = 43 * 24 + 2 * 34 * 5 * 3 + 90 + 60 + 50
# [lm], the kernel against its plain version on the card: the bounds of
# tests/test_torch_lm.py (pose, the level's error relative, the affine
# pair; flags and trial and accept counts equal)
LM_POSE_ATOL, LM_ERR_RTOL, LM_AFF_ATOL = 2e-5, 1e-4, 1e-3
# the arithmetic of one LM pass per point, counted from csrc/lm_track.cu
# (warp, bilinear sample, residual and moments, weight, Jacobian, 27
# products into A and g; f32 ops and the 33 f64 adds)
LM_OPS_PER_POINT = 175 + 33
# [lm]'s Sim(3) cases, the kernel against the plain loop on the card: the
# pose (8 entries, the scale included) and the affine pair as LM's, the
# level's error and the final pass's residual means and usage relative,
# the final pass's Hessian relative to its largest entry; flags and trial
# and accept counts equal on every lane the CPU witnesses settle
SIM3_POSE_ATOL, SIM3_ERR_RTOL, SIM3_HESS_RTOL = LM_POSE_ATOL, LM_ERR_RTOL, 1e-4
# the arithmetic of one Sim(3) pass per point, counted from
# csrc/sim3_track.cu (warp, bilinear sample and nearest tap, ESM gradient,
# residual and moments, depth residual and usage, the coupled weights, J6
# and J4, the 50 products and adds into LGS7; f32 ops and the 43 f64 adds)
SIM3_OPS_PER_POINT = 276 + 43
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


# the observe sweep's plain versions (depth/observe.py): none runs on a
# card path
OBSERVE_PLAIN = ("epl_setup_plain", "epl_search_plain", "fuse_plain",
                 "make_epl", "make_epl_multi", "line_stereo",
                 "line_stereo_points", "_fuse_results")


def assert_epl_on_path(tag, counts, sweeps=None):
    """The observe sweeps of a card run went through the three kernels:
    each launched, once a sweep each (`sweeps`, when the caller knows
    it)."""
    EPL_LAUNCHES[tag] = dict(counts)
    log(f"[{tag}] epl launches {counts}"
        + ("" if sweeps is None else f" over {sweeps} sweeps"))
    assert min(counts.values()) > 0, (tag, counts)
    assert len(set(counts.values())) == 1, (tag, counts)
    if sweeps is not None:
        assert counts["epl_prepare"] == sweeps, (tag, counts, sweeps)


@contextlib.contextmanager
def counted_plain(stencil):
    """Count the calls of the stencil's and the hole fill's plain
    versions, of the LM
    loops' (`tracking.lm.level_plain`, the SE(3) track's
    `final_pass_plain`, the Sim(3) tracker's `level_plain` and
    `final_pass_plain`) and of the observe sweep's (OBSERVE_PLAIN) while
    inside; yields [all of them, the LM loops']."""
    from lsd_slam_tpu_torch.depth import observe
    from lsd_slam_tpu_torch.tracking import lm
    from lsd_slam_tpu_torch.tracking import se3_tracker as se3
    from lsd_slam_tpu_torch.tracking import sim3_tracker as sim3

    calls = [0, 0]
    plains = {(stencil, name): getattr(stencil, name) for name in (
        "regularize_plain", "regularize_accumulators_plain",
        "fill_holes_plain")}
    plains[(lm, "level_plain")] = lm.level_plain
    plains[(se3, "final_pass_plain")] = se3.final_pass_plain
    for name in ("level_plain", "final_pass_plain"):
        plains[(sim3, name)] = getattr(sim3, name)
    for name in OBSERVE_PLAIN:
        plains[(observe, name)] = getattr(observe, name)

    def counted(fn, of_lm):
        def call(*a, **k):
            calls[0] += 1
            calls[1] += of_lm
            return fn(*a, **k)
        return call
    for (mod, name), fn in plains.items():
        setattr(mod, name, counted(fn, mod in (lm, se3, sim3)))
    try:
        yield calls
    finally:
        for (mod, name), fn in plains.items():
            setattr(mod, name, fn)


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


def slam_setup(torch, ref, sequential=True):
    """The engine and frames of a stored reference's SLAM scenario on the
    card, at the reference's pipeline lag: (system, gt poses, frames)."""
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
    return sys_, poses, frames


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
    n = ref["n_frames"]
    sys_, poses, frames = slam_setup(torch, ref, sequential)
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


def search_launches(st):
    """The `sim3_level` launches the constraint searches of a run whose
    stats are `st` make: one a level of each stage they reached, both
    directions together, each final pass inside its stage's last launch
    (stage (4,3) two, (2,2) and (1,1) one each)."""
    return int(2 * st.get("sim3_stage0_n", 0) + st.get("sim3_stage1_n", 0)
               + st.get("sim3_stage2_n", 0))


def assert_lm_on_path(tag, st, n_tracked):
    """The LM loops of a card run went through the kernels: the four levels
    of every tracked frame (frame 0 is the initialisation) launched
    `lm_level`, every constraint search launched `sim3_level` once a level
    of every stage it reached (`search_launches`), and no tracker (SE(3),
    quick, Sim(3)) pulled a trial flag."""
    searches = int(st.get("sim3_stage0_n", 0))
    sim3 = SIM3_LAUNCHES.get(tag, 0)
    log(f"[{tag}] lm_level launches {LM_LAUNCHES[tag]} over {n_tracked} "
        f"tracked frames, by cluster size {LM_CLUSTERS[tag]}; sim3_level "
        f"launches {sim3} over {searches} constraint searches, by cluster "
        f"size {SIM3_CLUSTERS.get(tag, {})}; LM trial flags pulled: SE3 "
        f"{st.get('lm_syncs', 0):.0f}, quick {st.get('quick_syncs', 0):.0f}"
        f", Sim3 {st.get('sim3_syncs', 0):.0f}")
    assert LM_LAUNCHES[tag] >= 4 * n_tracked, (tag, LM_LAUNCHES[tag])
    # the SE(3) track's levels 1-3 spread over a cluster
    assert any(int(c) > 1 for c in LM_CLUSTERS[tag]), LM_CLUSTERS[tag]
    assert st.get("lm_syncs", 0) == 0 and st.get("quick_syncs", 0) == 0, st
    assert sim3 == search_launches(st), (tag, sim3, search_launches(st))
    assert st.get("sim3_syncs", 0) == 0, st


def slam_phase(torch, stencil, counted_plain, tag, trace):
    """Phase 5 ("slam"), 6 ("slam-loop") or 8 ("slam-pipelined"): the run
    of SLAM_RUNS[tag] against its stored reference, then, if `trace`, a
    second pass under torch.profiler. Returns (fused launches on the path,
    the final state's planes for the kernel check, the busy share or
    None)."""
    from lsd_slam_tpu_torch.ops import epl_stereo, lm_track, scatter
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    ref_file, traj_bound, rot_bound = SLAM_RUNS[tag]
    ref = load_ref(ref_file)
    n = ref["n_frames"]
    sync_each = ref.get("pipeline_lag", 0) == 0
    with counted_plain() as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        lm_track.LAUNCHES = lm_track.SIM3_LAUNCHES = 0
        lm_track.CLUSTER_SIZES.clear()
        lm_track.SIM3_CLUSTER_SIZES.clear()
        epl_stereo.reset_counts()
        run = run_slam(torch, ref, sync_each=sync_each)
        fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
        SEGMENT_LAUNCHES[tag] = scatter.LAUNCHES
        ORDER_LAUNCHES[tag] = scatter.ORDER_LAUNCHES
        LM_LAUNCHES[tag] = lm_track.LAUNCHES
        LM_CLUSTERS[tag] = dict(lm_track.CLUSTER_SIZES)
        SIM3_LAUNCHES[tag] = lm_track.SIM3_LAUNCHES
        SIM3_CLUSTERS[tag] = dict(lm_track.SIM3_CLUSTER_SIZES)
        epl = epl_stereo.counts()
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
        f"segment_order launches {ORDER_LAUNCHES[tag]}, lm_level launches "
        f"{LM_LAUNCHES[tag]} (plain LM loop calls {plain_calls[1]})"
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
    assert SIM3_LAUNCHES[tag] > 0, "no sim3_level launch on the path"
    assert_lm_on_path(tag, sys_.stats.snapshot(),
                      len(sys_.all_frame_poses) - 1)
    assert_epl_on_path(tag, epl)
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
    from lsd_slam_tpu_torch.ops import epl_stereo, lm_track, scatter

    with counted_plain() as plain_calls:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        lm_track.LAUNCHES = lm_track.SIM3_LAUNCHES = 0
        lm_track.CLUSTER_SIZES.clear()
        lm_track.SIM3_CLUSTER_SIZES.clear()
        epl_stereo.reset_counts()
        run = run_slam(torch, ref, sequential=False, sync_each=False)
        fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
        SEGMENT_LAUNCHES[tag] = scatter.LAUNCHES
        ORDER_LAUNCHES[tag] = scatter.ORDER_LAUNCHES
        LM_LAUNCHES[tag] = lm_track.LAUNCHES
        LM_CLUSTERS[tag] = dict(lm_track.CLUSTER_SIZES)
        SIM3_LAUNCHES[tag] = lm_track.SIM3_LAUNCHES
        SIM3_CLUSTERS[tag] = dict(lm_track.SIM3_CLUSTER_SIZES)
        epl = epl_stereo.counts()
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
    assert_lm_on_path(tag, st, len(sys_.all_frame_poses) - 1)
    assert_epl_on_path(tag, epl)
    return fused


def multi_scene(torch):
    """[observe-multi]'s inputs at 640x480 on BenchScene(seed=0): the
    keyframe (frame 0) with its ground-truth inverse depth, frames 1..10
    rendered on the card, their ref->keyframe poses, a per-pixel
    next_min_id, good masks (the tracker's min level) and residuals from
    a seed."""
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.lie import np_sim3 as nps
    from lsd_slam_tpu_torch.utils import synth

    w, h, n_frames = 640, 480, 130
    cam = synth.default_camera(w, h)
    scene = synth.BenchScene(seed=0)
    poses = synth.bench_trajectory(n_frames)
    rng = np.random.default_rng(0)
    renders = [synth.render_realistic(scene, cam, poses[i], frame_index=i,
                                      noise_sigma=0.0, device="cuda")
               for i in range(11)]
    kf_img, kf_dep = renders[0]
    gt = torch.where(kf_dep > 0, 1.0 / torch.clamp_min(kf_dep, 1e-6),
                     torch.zeros_like(kf_dep))
    return types.SimpleNamespace(
        w=w, h=h, cam=cam, cfg=LSDConfig(width=w, height=h),
        renders=renders, kf_img=kf_img, gt=gt,
        # frame k's ref->keyframe pose (gt poses are world->camera)
        r2k=[nps.se3_mul(poses[0].astype(np.float64),
                         nps.se3_inverse(poses[k].astype(np.float64)))
             for k in range(11)],
        nmi=rng.integers(0, 17, (h, w)).astype(np.float32),
        gms=[rng.uniform(size=(h // 2, w // 2)) < 0.9 for _ in range(11)],
        res=[float(x) for x in rng.uniform(0.5, 2.0, 11)])


def multi_depth_map(torch, ms, dev):
    """(keyframe pyramid, DepthMap) of `multi_scene` on `dev`: the
    ground-truth init and the seeded next_min_id."""
    from lsd_slam_tpu_torch.depth.depth_map import DepthMap
    from lsd_slam_tpu_torch.frames import build_frame

    pyr = build_frame(ms.kf_img.to(dev), 5)
    dm = DepthMap(ms.cam, ms.cfg, dev)
    dm.initialize_from_gt(ms.gt.to(dev), pyr.max_grad[0])
    dm.state = dm.state.replace(next_min_id=torch.as_tensor(ms.nmi,
                                                            device=dev))
    return pyr, dm


def multi_update(torch, ms, dm, pyr, frames, dev):
    """DepthMap.update_keyframe_multi over `frames` of `multi_scene`."""
    return dm.update_keyframe_multi(
        pyr, [ms.renders[i][0].to(dev) for i in frames],
        [ms.r2k[i] for i in frames], [float(4 + i) for i in frames],
        [torch.as_tensor(ms.gms[i], device=dev) for i in frames],
        [ms.res[i] for i in frames])


def observe_multi_phase(torch, stencil, counted_plain, reg_bound):
    """Phase 7: DepthMap.update_keyframe_multi at 640x480 on the card and on
    the CPU port from the same inputs, K = 1, 3, 8, 10. Returns (fused
    launches on the card, the max abs error of the state fields off the
    flipped pixels, the most pixels flipped in one K)."""
    from lsd_slam_tpu_torch.ops import epl_stereo

    scn = multi_scene(torch)
    h, w = scn.h, scn.w

    def run(dev, k):
        pyr, dm = multi_depth_map(torch, scn, dev)
        t0 = time.perf_counter()
        stats = multi_update(torch, scn, dm, pyr, range(1, k + 1), dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        return dm, stats, (time.perf_counter() - t0) * 1e3

    launches, worst_err, worst_flips = 0, 0.0, 0
    fields = ("valid", "idepth", "var", "validity", "blacklisted",
              "idepth_smoothed", "var_smoothed")
    for k in (1, 3, 8, 10):
        with counted_plain() as plain_calls:
            stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
            epl_stereo.reset_counts()
            dm, stats, ms = run("cuda", k)
            fused, acc = stencil.FUSED_LAUNCHES, stencil.LAUNCHES
            epl = epl_stereo.counts()
        assert fused > 0 and acc == 0 and plain_calls[0] == 0, (
            k, fused, acc, plain_calls)
        assert_epl_on_path(f"observe-multi-K{k}", epl, sweeps=-(-k // 8))
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
    Fails unless the run launched the fused kernel and `lm_level`, never
    the accumulators entry, called no plain version (the LM loops'
    included), and its constraint searches launched `sim3_level` and
    pulled no Sim(3) flag."""
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
            and counts["plain"] == 0 and counts["segment_plain"] == 0
            and counts["lm"] > 0), (args, counts)
    # the Sim(3) loops on the card pull no flag; every search launched
    # once a level of every stage it reached
    assert counts.get("sim3_syncs", 0) == 0, (args, counts)
    assert counts["sim3"] == counts.get("search_launches", 0), (args, counts)
    # every observe sweep went through the three kernels
    epl = counts["epl"]
    assert min(epl.values()) > 0 and len(set(epl.values())) == 1, (args,
                                                                    counts)
    return proc.stdout, done_fps(done[0]), counts


def done_fps(line: str) -> float:
    """Frames per second from the runner's `done: N frames in T s` line
    (its own fps field has one decimal)."""
    head = line.split(" frames in ")
    return int(head[0].split()[-1]) / float(head[1].split("s ")[0])


def counted_runner(argv, multihost_gates=False) -> int:
    """`chip_smoke.py --counted-runner ARGS`: the dataset runner's own
    entry, `io.runner.main(ARGS)`, as `python -m lsd_slam_tpu_torch.io.runner
    ARGS` calls it, with the kernel launch counters zeroed just before and
    the plain versions counted; the counts read just after are the last
    line, behind COUNTS_TAG. On a `multihost:` run they add the frontend's
    fan-outs and SPMD PGO calls (rank 0) or the commands served (ranks >=
    1), and the collectives run and bytes staged through host memory;
    `multihost_gates` (`--multihost-gates`) lowers the fan-out gate to 2
    candidates and the SPMD PGO gate to 1 edge, as
    tests/multihost_engine_worker.py does, and, before rank 0's frontend
    stops, reads the run's fan-outs and runs `reloc_check` on the engine
    and `fanout_check` on the keyframes it mirrored."""
    from lsd_slam_tpu_torch.io import runner
    from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
    from lsd_slam_tpu_torch.ops import epl_stereo, lm_track
    from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.parallel import multihost_engine
    from lsd_slam_tpu_torch.system import SlamSystem

    if multihost_gates:
        multihost_engine.MultihostFrontend.min_candidates = 2
        PoseGraph.multihost_min_edges = 1
    seen = {}
    bringup, serve = runner.bringup_multihost, multihost_engine.serve

    def bringup_seen(*a, **k):
        seen["frontend"] = bringup(*a, **k)
        return seen["frontend"]

    def serve_seen(channel, mesh=None):
        seen["mesh"] = mesh
        seen["served"] = serve(channel, mesh)
        return seen["served"]

    stop = multihost_engine.MultihostFrontend.stop
    finalize = SlamSystem.finalize

    def finalize_seen(sys_):
        seen["system"] = sys_
        return finalize(sys_)

    def stop_checked(frontend):
        seen["run_fanouts"] = frontend.fanouts
        seen["reloc_check"] = reloc_check(seen["system"], frontend)
        seen["fanout_check"] = fanout_check(frontend)
        stop(frontend)

    runner.bringup_multihost = bringup_seen
    multihost_engine.serve = serve_seen
    SlamSystem.finalize = finalize_seen
    if multihost_gates:
        multihost_engine.MultihostFrontend.stop = stop_checked
    try:
        with counted_plain(stencil) as plain_calls, \
                counted_segment_plain() as seg_plain:
            stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
            scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
            lm_track.LAUNCHES = lm_track.SIM3_LAUNCHES = 0
            lm_track.CLUSTER_SIZES.clear()
            lm_track.SIM3_CLUSTER_SIZES.clear()
            epl_stereo.reset_counts()
            runner.main(argv)
            counts = dict(fused=stencil.FUSED_LAUNCHES,
                          accumulators=stencil.LAUNCHES,
                          plain=plain_calls[0], lm_plain=plain_calls[1],
                          segment_plain=seg_plain[0],
                          segment_sum=scatter.LAUNCHES,
                          segment_order=scatter.ORDER_LAUNCHES,
                          lm=lm_track.LAUNCHES,
                          lm_clusters=dict(lm_track.CLUSTER_SIZES),
                          sim3=lm_track.SIM3_LAUNCHES,
                          sim3_clusters=dict(lm_track.SIM3_CLUSTER_SIZES),
                          epl=epl_stereo.counts())
    finally:
        runner.bringup_multihost = bringup
        multihost_engine.serve = serve
        multihost_engine.MultihostFrontend.stop = stop
        SlamSystem.finalize = finalize
    if "system" in seen:
        st = seen["system"].stats.snapshot()
        counts.update(sim3_syncs=st.get("sim3_syncs", 0),
                      searches=st.get("sim3_stage0_n", 0),
                      search_launches=search_launches(st))
    frontend = seen.get("frontend")
    if frontend is not None:
        counts.update(fanouts=frontend.fanouts, pgo_calls=frontend.pgo_calls,
                      pgo_secs=frontend.pgo_secs,
                      run_fanouts=seen.get("run_fanouts"),
                      reloc_check=seen.get("reloc_check"),
                      fanout_check=seen.get("fanout_check"),
                      collectives=frontend.mesh.collectives,
                      collective_secs=frontend.mesh.collective_secs,
                      staged_bytes=frontend.mesh.staged_bytes)
    elif "served" in seen:
        counts.update(served=seen["served"],
                      collectives=seen["mesh"].collectives,
                      collective_secs=seen["mesh"].collective_secs,
                      staged_bytes=seen["mesh"].staged_bytes)
    log(COUNTS_TAG + json.dumps(counts))
    return 0


def reloc_check(sys_, frontend) -> dict:
    """The engine's relocaliser (`KeyFrameGraph.relocalize`, which names
    the keyframes itself) on the last keyframe's frame, fanned out through
    the frontend, against the same call on rank 0 alone (the frontend
    detached). Returns the keyframe picked, the fan-outs, quick_syncs and
    `lm_level` launches (rank 0's share of the quick tracks) the fanned
    call made, whether both calls pick the same keyframe and the max
    |init difference|."""
    from lsd_slam_tpu_torch.ops import lm_track

    graph = sys_.backend.graph
    pyr = sys_.keyframes[-1].pyr
    fanouts = frontend.fanouts
    syncs = sys_.stats.snapshot().get("quick_syncs", 0)
    launched = lm_track.LAUNCHES
    hit = graph.relocalize(pyr)
    made = frontend.fanouts - fanouts
    bumped = sys_.stats.snapshot().get("quick_syncs", 0) - syncs
    launched = lm_track.LAUNCHES - launched
    graph.multihost = None
    try:
        alone = graph.relocalize(pyr)
    finally:
        graph.multihost = frontend
    same = (hit is None) == (alone is None) and (
        hit is None or hit[0].id == alone[0].id)
    gap = (float(np.abs(np.asarray(hit[1]) - np.asarray(alone[1])).max())
           if same and hit is not None else 0.0 if same else float("inf"))
    return dict(kf=None if hit is None else hit[0].id, fanouts=made,
                quick_syncs=bumped, lm_launches=launched, same=same, gap=gap)


def fanout_check(frontend) -> dict:
    """Both quick-track fan-outs over every keyframe rank 0 mirrored: the
    last keyframe's frame quad against every keyframe's point set, and its
    point set against every keyframe's frame quad, split round-robin over
    the ranks, against the same batches on rank 0 alone. Returns the
    lanes, the max |ref_to_frame difference| and whether the good flags
    are equal."""
    from lsd_slam_tpu_torch.parallel import multihost_engine as mhe

    local = frontend.backend
    ids = sorted(local.permaref)
    pts, quad = local.permaref[ids[-1]]
    inits = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                    (len(ids), 1))
    gap, same = 0.0, True
    for fanned, alone in (
            (frontend.quick_refs(quad, ids, inits),
             local.quick_refs(mhe._to_host(quad), ids, inits)),
            (frontend.quick_frames(pts, ids, inits),
             local.quick_frames(mhe._to_host(pts), ids, inits))):
        gap = max(gap, float(np.abs(fanned[0][0] - alone[0][0]).max()))
        same = same and bool(np.array_equal(fanned[0][1], alone[0][1]))
    return dict(lanes=len(ids), gap=gap, flags_equal=same)


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
        LM_LAUNCHES["cli-hz0"] = counts["lm"]
        LM_CLUSTERS["cli-hz0"] = counts["lm_clusters"]
        SIM3_LAUNCHES["cli-hz0"] = counts["sim3"]
        SIM3_CLUSTERS["cli-hz0"] = counts["sim3_clusters"]
        EPL_LAUNCHES["cli-hz0"] = counts["epl"]
        with open(os.path.join(out, "poses.jsonl")) as f:
            published = {p["id"]: p["cam_to_world"]
                         for p in map(json.loads, f)}
        log(f"[cli] runner hz:0: {fps:g} fps ({CLI_FRAMES} frames, decode "
            f"{many_ms:.2f} ms per frame on this host), keyframes {kfs}, "
            f"{len(edges)} edges, {n_pts} points, {n_poses} tracked poses "
            f"published; regularize_fused launches {counts['fused']}, "
            f"regularize_accumulators launches {counts['accumulators']}, "
            f"lm_level launches {counts['lm']}, sim3_level launches "
            f"{counts['sim3']} over {counts.get('searches', 0)} constraint "
            f"searches (Sim3 LM flags pulled {counts.get('sim3_syncs', 0)})"
            f", plain-version calls {counts['plain']} (the LM loops' "
            f"{counts['lm_plain']})")
        assert counts["sim3"] > 0, counts
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

        t0 = time.perf_counter()
        launches["multihost_rank0"] = multihost_phase(
            card, frames, calib, root, ikfs, iedges, mine, fps)
        log(f"[time] multihost pair took {time.perf_counter() - t0:.1f} s")

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
        LM_LAUNCHES["cli-checkpoint"] = counts["lm"]
        LM_CLUSTERS["cli-checkpoint"] = counts["lm_clusters"]
        SIM3_LAUNCHES["cli-checkpoint"] = counts["sim3"]
        SIM3_CLUSTERS["cli-checkpoint"] = counts["sim3_clusters"]
        EPL_LAUNCHES["cli-checkpoint"] = counts["epl"]
        stdout, fps_b, counts = _runner([f"files:{halves[1]}",
                                         f"calib:{calib}",
                                         f"out:{os.path.join(root, 'out_b')}",
                                         f"resume:{ckpt}"])
        launches["resume"] = counts["fused"]
        seg["resume"] = (counts["segment_sum"], counts["segment_order"])
        LM_LAUNCHES["cli-resume"] = counts["lm"]
        LM_CLUSTERS["cli-resume"] = counts["lm_clusters"]
        SIM3_LAUNCHES["cli-resume"] = counts["sim3"]
        SIM3_CLUSTERS["cli-resume"] = counts["sim3_clusters"]
        EPL_LAUNCHES["cli-resume"] = counts["epl"]
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
        LM_LAUNCHES["cli-hz30_pipeline3"] = counts["lm"]
        LM_CLUSTERS["cli-hz30_pipeline3"] = counts["lm_clusters"]
        SIM3_LAUNCHES["cli-hz30_pipeline3"] = counts["sim3"]
        SIM3_CLUSTERS["cli-hz30_pipeline3"] = counts["sim3_clusters"]
        EPL_LAUNCHES["cli-hz30_pipeline3"] = counts["epl"]
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
            f"launches {seg}; lm_level launches "
            f"{ {k: v for k, v in LM_LAUNCHES.items() if k.startswith('cli')} }"
            f"; sim3_level launches "
            f"{ {k: v for k, v in SIM3_LAUNCHES.items() if k.startswith('cli')} }")
        for run, (fold, order) in seg.items():
            SEGMENT_LAUNCHES[f"cli-{run}"] = fold
            ORDER_LAUNCHES[f"cli-{run}"] = order
        assert all(min(n) > 0 for n in seg.values()), seg
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---- the observe sweep's kernels

@contextlib.contextmanager
def recorded_observe_inputs():
    """Record the arguments (by name) and the stats of every
    `depth.observe.observe` call (the engine's single-reference sweep; on
    the card it launches the three kernels) while inside. The arguments
    are kept, not copied (the sweep writes no input in place). Yields the
    list of (arguments, stats)."""
    import inspect
    from lsd_slam_tpu_torch.depth import observe

    seen = []
    real = observe.observe
    sig = inspect.signature(real)

    def call(*a, **k):
        bound_args = sig.bind(*a, **k)
        bound_args.apply_defaults()
        out = real(*a, **k)
        seen.append((dict(bound_args.arguments), out[1]))
        return out

    observe.observe = call
    try:
        yield seen
    finally:
        observe.observe = real


def epl_case_of_observe(args):
    """An [epl] case from a recorded `observe` call: one reference frame."""
    return dict(
        state=args["state"], kf_img=args["kf_img"], kf_gx=args["kf_gx"],
        kf_gy=args["kf_gy"], kf_max_grad=args["kf_max_grad"],
        ref_stack=args["ref_img"][None], ref_to_kf=args["ref_to_kf"][None],
        ids=[float(np.float32(args["ref_frame_id"]))],
        good=args["good_mask"][None],
        residual=args["tracking_residual"].reshape(1),
        skip_inc=float(args["skip_inc"]), cam=args["cam"],
        dcfg=args["dcfg"], mcfg=args["mcfg"],
        budget=int(args["point_budget"]))


def epl_case_of_multi(torch, scn, frames):
    """An [epl] case of `multi_scene`: the sweep update_keyframe_multi
    runs first for `frames` (one sweep of up to 8 frames; one frame is the
    single-reference sweep at the engine's budget)."""
    from lsd_slam_tpu_torch.depth.depth_map import (observe_budget_full,
                                                    upsample_mask)

    pyr, dm = multi_depth_map(torch, scn, "cuda")
    frames = list(frames)
    good = torch.stack([torch.as_tensor(scn.gms[i], device="cuda")
                        for i in frames])
    return dict(
        state=dm.state, kf_img=pyr.images[0], kf_gx=pyr.gx[0],
        kf_gy=pyr.gy[0], kf_max_grad=pyr.max_grad[0],
        ref_stack=torch.stack([scn.renders[i][0] for i in frames]),
        ref_to_kf=dm._f32(np.stack([scn.r2k[i] for i in frames])),
        ids=[float(np.float32(4 + i)) for i in frames],
        good=upsample_mask(good, scn.cfg),
        residual=dm._f32([scn.res[i] for i in frames]),
        skip_inc=dm._skip_inc(), cam=scn.cam, dcfg=scn.cfg.depth,
        mcfg=scn.cfg.mapping,
        budget=(dm.pick_budget() if len(frames) == 1
                else observe_budget_full(scn.h, scn.w)))


def _moved(torch, x, dev):
    """Tensors (and the fields of states and named tuples) on `dev`."""
    if torch.is_tensor(x):
        return x.to(dev)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        vals = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
        if not any(torch.is_tensor(v) for v in vals.values()):
            return x     # a camera or a config
        return dataclasses.replace(x, **{k: _moved(torch, v, dev)
                                         for k, v in vals.items()})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(torch, v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(torch, v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _moved(torch, v, dev) for k, v in x.items()}
    return x


def epl_terms(O, lie, c):
    """The case's FrameTerms as its sweep computes them."""
    if len(c["ids"]) == 1:
        return O.frame_terms(lie.se3_inverse(c["ref_to_kf"][0]),
                             0.25 * (1.0 + c["residual"][0]), c["cam"])
    return O.frame_terms(lie.se3_inverse(c["ref_to_kf"]),
                         0.25 * (1.0 + c["residual"]), c["cam"])


def epl_sweep(O, c):
    """The case's whole sweep through the entry a caller uses: `observe`
    for one frame, `observe_multi` for several."""
    kf = (c["kf_img"], c["kf_gx"], c["kf_gy"], c["kf_max_grad"])
    if len(c["ids"]) == 1:
        return O.observe(c["state"], *kf, c["ref_stack"][0],
                         c["ref_to_kf"][0], c["ids"][0], c["good"][0],
                         c["residual"][0], c["skip_inc"], c["cam"],
                         c["dcfg"], c["mcfg"], point_budget=c["budget"])
    return O.observe_multi(c["state"], *kf, c["ref_stack"], c["ref_to_kf"],
                           c["ids"], c["good"], c["residual"], c["skip_inc"],
                           c["cam"], c["dcfg"], c["mcfg"],
                           point_budget=c["budget"])


def epl_stages(O, lie, c, plain=False, terms=None):
    """The case's sweep stage by stage, as the entry runs it: the routed
    stages (the kernels on the card, the plain versions on the CPU) or,
    with `plain`, every stage on its plain version (torch ops on the
    case's device: what the card ran before the kernels). `terms` (on the
    case's device) replaces the FrameTerms the sweep computes. Returns
    (set-up, search grids, new state, stats)."""
    h, w = c["kf_img"].shape
    setup_fn, search_fn, fuse_fn = (
        (O.epl_setup_plain, O.epl_search_plain, O.fuse_plain) if plain
        else (O.epl_setup, O.epl_search, O.fuse))
    setup = setup_fn(c["state"], c["kf_img"], c["kf_max_grad"],
                     c["ref_to_kf"][:, 4:7], c["ids"], c["good"], c["cam"],
                     c["dcfg"], c["mcfg"])
    flat_idx, valid_k = O.compact_active(
        setup.process, O.frame_shift(c["ids"][-1], h * w), c["budget"])
    grids = search_fn(setup, flat_idx, valid_k, c["kf_img"], c["kf_gx"],
                      c["kf_gy"], c["ref_stack"],
                      epl_terms(O, lie, c) if terms is None else terms,
                      c["cam"], c["dcfg"], c["mcfg"])
    new, stats = fuse_fn(c["state"], setup, grids, valid_k,
                         c["kf_max_grad"], c["ids"], c["skip_inc"],
                         c["dcfg"])
    return setup, grids, new, stats


@contextlib.contextmanager
def rounded_sqrt(torch):
    """While inside, `torch.sqrt` of a CPU f32 tensor is numpy's, the IEEE
    square root, correctly rounded like the kernels' `sqrtf`. The CPU's
    torch.sqrt of a large tensor runs MKL's vector math, which is not
    always correctly rounded: this is the plain version with the kernels'
    rounding, to tell that difference from any other."""
    real = torch.sqrt

    def sqrt(x, *a, **k):
        if (not a and not k and torch.is_tensor(x) and x.device.type == "cpu"
                and x.dtype == torch.float32):
            return torch.from_numpy(np.sqrt(x.numpy()))
        return real(x, *a, **k)

    torch.sqrt = sqrt
    try:
        yield
    finally:
        torch.sqrt = real


def _bits_equal(torch, a, b):
    """Same bits (NaNs of one payload compare equal)."""
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _state_bits_equal(torch, a, b):
    return all(_bits_equal(torch, getattr(a, f.name),
                           getattr(b, f.name).to(getattr(a, f.name).device))
               for f in dataclasses.fields(a))


def _share_off(a, b):
    return float(np.mean(a != b)) if a.size else 0.0


def _bit_share(a, b):
    """The share of entries of two arrays with the same bits."""
    view = np.uint8 if a.dtype == bool else (
        np.int64 if a.dtype.itemsize == 8 else np.int32)
    return float(np.mean(a.view(view) == b.view(view))) if a.size else 1.0


def _rel_err(a, b, mask):
    a, b = a[mask].astype(np.float64), b[mask].astype(np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin])
                        / np.maximum(np.abs(b[fin]), 1e-30)))


def _abs_err(a, b, mask):
    a, b = a[mask].astype(np.float64), b[mask].astype(np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))


def search_flips(O, got, want):
    """(H, W) mask of the pixels where two searches decided apart: the codes
    differ, or both are OK and the inverse depth or the variance is off
    EPL_RTOL (a subpixel branch that flipped moves the variance by its
    discretisation term), or the codes agree and the EPL length is off
    it."""
    a = {f: getattr(got, f).cpu().numpy() for f in O.StereoGrids._fields}
    b = {f: getattr(want, f).cpu().numpy() for f in O.StereoGrids._fields}

    def off(f):
        return ~np.isclose(a[f], b[f], rtol=EPL_RTOL, atol=1e-9,
                           equal_nan=True)
    code_off = a["code"] != b["code"]
    both_ok = (a["code"] == O.OK) & (b["code"] == O.OK)
    return code_off | (both_ok & (off("idepth") | off("var"))) | (
        ~code_off & off("epl"))


def inputs_apart(O, setup_a, grids_a, setup_b, grids_b):
    """(H, W) mask of the pixels whose fusion inputs that a sweep computes
    (the set-up's masks and k_sel, the search's four grids) differ in bits
    between two sweeps of the same state. The fusion is a function of a
    pixel's own inputs: on every other pixel two sweeps must agree."""
    apart = None
    pairs = [(getattr(setup_a, f), getattr(setup_b, f)) for f in (
        "epl_ok", "can_update", "can_create", "process", "k_sel")]
    pairs += list(zip(grids_a, grids_b))
    for x, y in pairs:
        x, y = x.cpu().numpy(), y.cpu().numpy()
        view = np.uint8 if x.dtype == bool else (
            np.int64 if x.dtype.itemsize == 8 else np.int32)
        d = x.view(view) != y.view(view)
        apart = d if apart is None else apart | d
    return apart


def check_state(tag, got, want, n_active, stats_got, stats_want,
                apart=None, codes_off=None):
    """A sweep's new state and stats against the plain version's, under
    tests/test_torch_observe.py's bounds: valid and the blacklist equal,
    validity and next_min_id to EPL_COUNTER_RTOL, inverse depth and
    variance to EPL_RTOL where both keep the pixel. Every pixel is held
    but those of `apart` (`inputs_apart`; none for a check on the same
    inputs), where a decision near its threshold may flip: of those at
    most EPL_SHARE of the active points may be off, and each count may
    be off by at most the pixels that are off or whose code or process
    mask differ (`codes_off`, at most EPL_SHARE of the active points; each
    pixel adds 0 or 1 to a count). Returns (max
    relative and max absolute error of the inverse depths and variances
    on the held pixels, the share of pixels whose every field has the
    plain version's bits, the mask of pixels off)."""
    from lsd_slam_tpu_torch.depth.observe import OBSERVE_STAT_KEYS

    a = {f: getattr(got, f).cpu().numpy() for f in (
        "valid", "blacklisted", "next_min_id", "validity", "idepth", "var")}
    b = {f: getattr(want, f).cpu().numpy() for f in a}
    shape = a["valid"].shape
    apart = np.zeros(shape, bool) if apart is None else apart
    codes_off = np.zeros(shape, bool) if codes_off is None else codes_off
    off = np.zeros(shape, bool)
    for key in ("valid", "blacklisted"):
        off_k = a[key] != b[key]
        assert not (off_k & ~apart).any(), (tag, key,
                                            int((off_k & ~apart).sum()))
        off |= off_k
    for key in ("next_min_id", "validity"):
        off_k = ~np.isclose(a[key], b[key], rtol=EPL_COUNTER_RTOL,
                            atol=EPL_COUNTER_RTOL)
        assert not (off_k & ~apart).any(), (tag, key,
                                            int((off_k & ~apart).sum()))
        off |= off_k
    both = a["valid"] & b["valid"]
    for key in ("idepth", "var"):
        off_k = ~np.isclose(a[key], b[key], rtol=EPL_RTOL, atol=1e-7) & both
        assert not (off_k & ~apart).any(), (tag, key,
                                            int((off_k & ~apart).sum()))
        off |= off_k
    assert off.sum() <= EPL_SHARE * max(n_active, 1.0), (tag,
                                                         int(off.sum()))
    assert codes_off.sum() <= EPL_SHARE * max(n_active, 1.0), (
        tag, int(codes_off.sum()))
    held = both & ~off
    err = abs_err = 0.0
    for key in ("idepth", "var"):
        err = max(err, _rel_err(a[key], b[key], held))
        abs_err = max(abs_err, _abs_err(a[key], b[key], held))
    same = np.ones(shape, bool)
    for key in a:
        view = np.uint8 if a[key].dtype == bool else np.int32
        same &= a[key].view(view) == b[key].view(view)
    decided = int((off | codes_off).sum())
    for key in OBSERVE_STAT_KEYS:
        x, y = int(stats_got[key]), int(stats_want[key])
        assert abs(x - y) <= decided, (tag, key, x, y, decided)
    return err, abs_err, float(same.mean()), off


# sha256 of the one source --baseline-epl-cu takes:
# baselines/epl_stereo_2bd7213.cu, commit 2bd7213's kernels (the search
# one thread a slot, on a grid over the whole budget) with the search's
# clock stamps; its LsdEplPtrs and LsdEplParams are today's
EPL_STAMPED_SHA256 = (
    "147e05bddcdd505b8d93b18f4d564b4b480b5c28ffc2e7d0ec27924af238b139")
# the group sizes [epl] builds csrc/epl_stereo.cu at (kGroup)
EPL_GROUPS = (8, 16, 32)
# the search kernels [epl] runs beside the package's on every case's
# set-up and compaction: name -> library (the source at each other group
# size, and with --baseline-epl-cu commit 2bd7213's kernel as "2bd7213")
EPL_SEARCHES = {}


def source_group() -> int:
    """kGroup of csrc/epl_stereo.cu: the lanes that search one slot."""
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "csrc",
                           "epl_stereo.cu")) as f:
        return int(re.search(r"constexpr int kGroup = (\d+);",
                             f.read()).group(1))


def epl_group_sources(build):
    """csrc/epl_stereo.cu at each other group size of EPL_GROUPS (its line
    of kGroup changed, nothing else), written into the build directory:
    build name -> path, for build.build(sources=)."""
    src = (build.CSRC / "epl_stereo.cu").read_text()
    line = f"constexpr int kGroup = {source_group()};"
    assert src.count(line) == 1, line
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for g in EPL_GROUPS:
        if g != source_group():
            path = build.BUILD_DIR / f"epl_stereo_g{g}.cu"
            path.write_text(src.replace(line, f"constexpr int kGroup = {g};"))
            out[f"epl_stereo_g{g}"] = path
    return out


@contextlib.contextmanager
def epl_library(lib=None, stamps=None):
    """While inside, ops.epl_stereo's wrappers launch the kernels of `lib`
    (a build of EPL_SEARCHES; None: the package's own) and the search
    writes its clock stamps into `stamps` (int64, kStampSlots = 5 a slot;
    None: no stamps, as on every engine path)."""
    from lsd_slam_tpu_torch.ops import epl_stereo as E

    real_lib, real_launch = E._library, E._launch
    if lib is not None:
        E._library = lambda: lib
    if stamps is not None:
        def launch(name, entry, ptrs, prm, dev):
            if name == "epl_stereo":
                ptrs.stamps = stamps.data_ptr()
            return real_launch(name, entry, ptrs, prm, dev)
        E._launch = launch
    try:
        yield
    finally:
        E._library, E._launch = real_lib, real_launch


def fresh_out(torch, O, setup):
    """`setup` with new result grids holding the not-processed values (what
    epl_prepare fills), for another launch of the search on it."""
    h, w = setup.prior.shape
    dev = setup.prior.device
    f32 = dict(dtype=torch.float32, device=dev)
    return setup._replace(out=O.StereoGrids(
        torch.full((h, w), O.SKIP, dtype=torch.int32, device=dev),
        torch.zeros((h, w), **f32), torch.zeros((h, w), **f32),
        torch.full((h, w), 1e9, **f32)))


# the parts of a slot the search's stamps split: after its gathers (and,
# in commit 2bd7213's kernel, its descriptor), its endpoints, its lattice
# (and, in the group kernel, the descriptor's taps), its scans and tail
EPL_STAMP_PARTS = ("gathers", "endpoints", "lattice", "scans_tail")


def epl_stamp_split(torch, setup, args, lib, clock_mhz):
    """One launch of a search kernel with its clock stamps: the median
    cycles (and us at `clock_mhz`) of each part of a slot's chain, and of
    the whole slot, over the searched slots."""
    from lsd_slam_tpu_torch.depth import observe as O
    from lsd_slam_tpu_torch.ops import epl_stereo as E

    flat_idx, valid_k = args[0], args[1]
    stamps = torch.zeros(flat_idx.shape[0] * 5, dtype=torch.int64,
                         device=flat_idx.device)
    with epl_library(lib, stamps):
        E.epl_stereo(fresh_out(torch, O, setup), *args)
    st = stamps.view(-1, 5)[valid_k].cpu().numpy()
    if not st.size:
        return {}
    cyc = {k: float(np.median(st[:, i + 1] - st[:, i]))
           for i, k in enumerate(EPL_STAMP_PARTS)}
    cyc["slot"] = float(np.median(st[:, 4] - st[:, 0]))
    cyc["slot_p90"] = float(np.percentile(st[:, 4] - st[:, 0], 90))
    return {k: dict(cycles=v, us=v / clock_mhz) for k, v in cyc.items()}


def search_variants(torch, card, name, setup, args, timed=True):
    """The search of one set-up and compaction (`args`: epl_stereo's after
    the set-up) by the package's kernel and by every kernel of
    EPL_SEARCHES, each on fresh result grids: every slot's four outputs
    must have the package kernel's bits. With `timed`, the CUDA-event ms
    of each in turns (the package's first and last) and each one's stamp
    split. Returns {kernel name: row}."""
    from lsd_slam_tpu_torch.depth import observe as O
    from lsd_slam_tpu_torch.ops import epl_stereo as E

    own = f"G{source_group()}"
    libs = {own: None, **EPL_SEARCHES}
    grids_of = {}
    for k, lib in libs.items():
        fn = getattr(lib or E._library(), "lsd_epl_stereo_grid", None)
        if fn is not None:
            fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
            grids_of[k] = fn(int(args[0].shape[0]))
    setups = {k: fresh_out(torch, O, setup) for k in libs}
    grids = {}
    for k, lib in libs.items():
        with epl_library(lib):
            grids[k] = E.epl_stereo(setups[k], *args)
    torch.cuda.synchronize()
    for k in libs:
        assert all(_bits_equal(torch, x, y)
                   for x, y in zip(grids[k], grids[own])), (
            f"{name}: the {k} search's outputs differ from {own}'s")
    rows = {k: {} for k in libs}
    if timed:
        def launch(k):
            with epl_library(libs[k]):
                E.epl_stereo(setups[k], *args)
        t = time_in_turns(torch, [(k, functools.partial(launch, k))
                                  for k in libs], 5, 8)
        # the same grid with no valid slot: the launch, the frame terms'
        # staging and one ballot a warp
        none = (args[0], torch.zeros_like(args[1])) + tuple(args[2:])
        empty = fresh_out(torch, O, setup)
        empty_ms = time_gpu(torch, lambda: E.epl_stereo(empty, *none), 5, 8)
        clock_mhz = sm_clocks_mhz()[0]
        for k, lib in libs.items():
            rows[k] = dict(ms=t[k], grid=grids_of.get(k),
                           split=epl_stamp_split(torch, setup, args, lib,
                                                 clock_mhz))
        rows[own]["empty_ms"] = empty_ms
        log(f"[epl] {name}: the search kernels on one set-up and "
            f"compaction give {own}'s bits on every slot; grids (blocks) "
            f"{grids_of}; in turns "
            + ", ".join(f"{k} {t[k]:.5f} ms" for k in libs)
            + f" ({own} with no valid slot {empty_ms:.5f} ms)"
            + f"; stamp split (median cycles a slot at {clock_mhz:.0f} "
            f"MHz): " + "; ".join(
                f"{k}" + "".join(f" {p} {r['split'][p]['cycles']:.0f}"
                                 for p in (*EPL_STAMP_PARTS, "slot",
                                           "slot_p90")
                                 if p in r["split"])
                for k, r in rows.items()) + f"; {card}")
    else:
        log(f"[epl] {name}: the search kernels ({', '.join(libs)}) on one "
            f"set-up and compaction give {own}'s bits on every slot")
    return rows


@contextlib.contextmanager
def recorded_searches():
    """Record the set-up and the other arguments of every `epl_search` on
    the card (the engine's sweeps launch `epl_stereo` there) while
    inside. Yields the list of (set-up, arguments)."""
    from lsd_slam_tpu_torch.depth import observe as O

    seen = []
    real = O.epl_search

    def call(setup, *a):
        out = real(setup, *a)
        if setup.prior.device.type == "cuda":
            seen.append((setup, a))
        return out

    O.epl_search = call
    try:
        yield seen
    finally:
        O.epl_search = real


def ties_case(torch, card, c):
    """[epl] on inputs built to tie and to hold NaNs, from a case's set-up
    and compaction on the card: every reference frame constant (100) but
    for a block of NaN pixels (a slot's steps all tie, or NaN samples make
    steps NaN: the first minimum, the first NaN), and NaN far bounds
    (max_id) at a tenth of the pixels (every lattice coordinate NaN, each
    group's base (0, 0)). Every search kernel gives the package kernel's
    bits, and the package kernel the plain version's run on the CPU with
    a correctly rounded sqrt (NaN for NaN) at every slot."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.depth import observe as O
    from lsd_slam_tpu_torch.ops import epl_stereo as E

    cpu = functools.partial(_moved, torch, dev="cpu")
    h, w = c["kf_img"].shape
    s = E.epl_prepare(c["state"], c["kf_img"], c["kf_max_grad"],
                      c["ref_to_kf"][:, 4:7].contiguous(), c["ids"],
                      c["good"], c["cam"], c["dcfg"], c["mcfg"])
    flat_idx, valid_k = O.compact_active(
        s.process, O.frame_shift(c["ids"][-1], h * w), c["budget"])
    ref = torch.full_like(c["ref_stack"], 100.0)
    ref[:, h * 5 // 12:h * 7 // 12, w // 6:w * 5 // 6:5] = float("nan")
    rng = np.random.default_rng(5)
    nan_far = torch.as_tensor(rng.uniform(size=(h, w)) < 0.1, device="cuda")
    s = s._replace(max_id=torch.where(
        nan_far, torch.full_like(s.max_id, float("nan")), s.max_id))
    args = (flat_idx, valid_k, c["kf_img"], c["kf_gx"], c["kf_gy"], ref,
            epl_terms(O, lie, c), c["cam"], c["dcfg"], c["mcfg"])
    g = E.epl_stereo(fresh_out(torch, O, s), *args)
    with rounded_sqrt(torch):
        gq = O.epl_search_plain(cpu(s), *cpu(args))
    torch.cuda.synchronize()
    slots = flat_idx[valid_k].cpu().numpy()
    a = {f: getattr(g, f).cpu().numpy().reshape(-1)[slots]
         for f in O.StereoGrids._fields}
    b = {f: getattr(gq, f).numpy().reshape(-1)[slots]
         for f in O.StereoGrids._fields}
    same = np.ones(slots.size, bool)
    for f in a:
        eq = a[f].view(np.int32) == b[f].view(np.int32)
        if a[f].dtype.kind == "f":
            eq |= np.isnan(a[f]) & np.isnan(b[f])
        same &= eq
    codes = {int(k): int(n) for k, n in zip(*np.unique(a["code"],
                                                       return_counts=True))}
    assert (a["code"] == b["code"]).all() and same.all(), (
        "ties", int((a["code"] != b["code"]).sum()), int((~same).sum()))
    assert codes.get(O.ERR_NAN, 0) > 0 and codes.get(O.OK, 0) > 0, codes
    log(f"[epl] ties and NaNs ({slots.size} slots, codes {codes}): the "
        f"package kernel gives the CPU plain version's codes and, with a "
        f"correctly rounded sqrt, its bits (NaN for NaN) at every slot")
    search_variants(torch, card, "ties and NaNs", s, args, timed=False)
    return dict(points=int(slots.size), codes=codes)


def epl_bounds(c, n_valid):
    """(bytes, operations) of each kernel on the case's inputs, each input
    read once and each output written once, each field at its dtype's
    size. The set-up reads 25 B a pixel (valid 1, idepth_smoothed,
    var_smoothed, blacklisted, next_min_id, the keyframe image and its
    gradient bound 4 each) and 1 B of each good mask it reads (the
    selected frame's and frame 0's: at most two), and writes 48 B (epx,
    epy, prior, min_id, max_id 4 each, four masks 1 each, k_sel 8, the four
    filled result grids 16). The search reads valid_k (1 B) of every slot
    and, of a searched slot, flat_idx 8 B, the set-up and gradients 28 B
    (+8 B of k_sel with several frames), writes 16 B of results, and
    reads the keyframe and the reference images. The fusion reads 53 B a
    pixel (the result grids 16, the state 29, four masks 4, the gradient
    bound 4; +8 B of k_sel with several frames) and writes 21 B."""
    h, w = c["kf_img"].shape
    n_pix, k = h * w, len(c["ids"])
    multi = 8 if k > 1 else 0     # k_sel, read with several frames only
    setup_b = n_pix * (25 + min(k, 2) + 48)
    stereo_b = (c["budget"] * 1 + n_valid * (8 + 28 + multi + 16)
                + n_pix * 4 * (1 + k))
    fuse_b = n_pix * (53 + multi + 21)
    return {"epl_prepare": (setup_b, 45 * n_pix),
            "epl_stereo": (stereo_b, EPL_OPS_PER_SLOT * n_valid),
            "observe_fuse": (fuse_b, 40 * n_pix)}


def bound_of(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _ints(stats):
    return {key: int(v) for key, v in stats.items()}


def epl_case(torch, card, name, c):
    """[epl] on one case: each kernel and the whole sweep against its plain
    version run on the CPU from the same inputs (the plain versions also
    with a correctly rounded sqrt, `rounded_sqrt`, the bit-equal shares
    logged), second launches bit for bit, CUDA-event ms of kernel and
    plain (on the card) beside the bound, host us per sweep. Returns the
    case's row."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.depth import observe as O
    from lsd_slam_tpu_torch.ops import epl_stereo as E

    cpu = functools.partial(_moved, torch, dev="cpu")
    h, w = c["kf_img"].shape
    n_pix, k = h * w, len(c["ids"])
    cam, dcfg, mcfg = c["cam"], c["dcfg"], c["mcfg"]
    setup_args = (c["state"], c["kf_img"], c["kf_max_grad"],
                  c["ref_to_kf"][:, 4:7].contiguous(), c["ids"], c["good"],
                  cam, dcfg, mcfg)
    row = dict(frames=k, shape=f"{w}x{h}", budget=c["budget"])

    # -- epl_prepare
    s1 = E.epl_prepare(*setup_args)
    s2 = E.epl_prepare(*setup_args)
    sp = O.epl_setup_plain(*cpu(setup_args))
    with rounded_sqrt(torch):
        sq = O.epl_setup_plain(*cpu(setup_args))
    torch.cuda.synchronize()
    fields = O.EplSetup._fields[:10]
    assert all(_bits_equal(torch, getattr(s1, f), getattr(s2, f))
               for f in fields), f"{name}: epl_prepare's second launch"
    bit_eq, bit_eq_rounded, worst, worst_abs = {}, {}, 0.0, 0.0
    for f in fields:
        a, b = getattr(s1, f).cpu().numpy(), getattr(sp, f).numpy()
        bit_eq_rounded[f] = _bit_share(a, getattr(sq, f).numpy())
        if a.dtype.kind in "bi":
            off = _share_off(a, b)
            assert off <= EPL_SHARE, (name, f, off)
        else:
            np.testing.assert_allclose(a, b, rtol=EPL_RTOL, atol=1e-6,
                                       equal_nan=True,
                                       err_msg=f"{name} setup {f}")
            everywhere = np.ones(a.shape, bool)
            worst = max(worst, _rel_err(a, b, everywhere))
            worst_abs = max(worst_abs, _abs_err(a, b, everywhere))
        bit_eq[f] = _bit_share(a, b)
    row["epl_prepare"] = dict(bit_equal_share=min(bit_eq.values()),
                              bit_equal_share_rounded_sqrt=min(
                                  bit_eq_rounded.values()),
                              max_rel_err=worst, max_abs_err=worst_abs)
    log(f"[epl] {name}: epl_prepare against the CPU plain version: share "
        f"of bit-equal pixels per field {bit_eq}, max rel err {worst:.3g}; "
        f"with a correctly rounded sqrt {bit_eq_rounded}; second launch "
        f"bit-equal")

    # -- the compaction (torch ops) on the card's set-up, then epl_stereo
    # (each launch writes its set-up's grids)
    flat_idx, valid_k = O.compact_active(
        s1.process, O.frame_shift(c["ids"][-1], n_pix), c["budget"])
    terms = epl_terms(O, lie, c)
    stereo_args = (flat_idx, valid_k, c["kf_img"], c["kf_gx"], c["kf_gy"],
                   c["ref_stack"], terms, cam, dcfg, mcfg)
    g1 = E.epl_stereo(s1, *stereo_args)
    g2 = E.epl_stereo(s2, *stereo_args)
    gp = O.epl_search_plain(cpu(s1), *cpu(stereo_args))
    with rounded_sqrt(torch):
        gq = O.epl_search_plain(cpu(s1), *cpu(stereo_args))
    torch.cuda.synchronize()
    assert all(_bits_equal(torch, x, y) for x, y in zip(g1, g2)), (
        f"{name}: epl_stereo's second launch")
    slots = flat_idx[valid_k].cpu().numpy()
    n_valid = int(slots.size)
    a = {f: getattr(g1, f).cpu().numpy().reshape(-1)[slots]
         for f in O.StereoGrids._fields}
    b = {f: getattr(gp, f).numpy().reshape(-1)[slots]
         for f in O.StereoGrids._fields}
    q = {f: getattr(gq, f).numpy().reshape(-1)[slots]
         for f in O.StereoGrids._fields}
    code_off = _share_off(a["code"], b["code"])
    agree = a["code"] == b["code"]
    both_ok = agree & (a["code"] == O.OK)
    assert code_off <= EPL_SHARE, (name, "codes", code_off)
    for f, mask in (("idepth", both_ok), ("var", both_ok), ("epl", agree)):
        np.testing.assert_allclose(a[f][mask], b[f][mask], rtol=EPL_RTOL,
                                   atol=1e-9, equal_nan=True,
                                   err_msg=f"{name} stereo {f}")
    same = np.ones(n_valid, bool)
    same_q = np.ones(n_valid, bool)
    for f in a:
        same &= a[f].view(np.int32) == b[f].view(np.int32)
        same_q &= a[f].view(np.int32) == q[f].view(np.int32)
    compared = (("idepth", both_ok), ("var", both_ok), ("epl", agree))
    serr = max(_rel_err(a[f], b[f], m) for f, m in compared)
    row["epl_stereo"] = dict(points=n_valid, codes_off=int((~agree).sum()),
                             ok_codes=int(both_ok.sum()),
                             bit_equal_share=float(same.mean())
                             if n_valid else 1.0,
                             bit_equal_share_rounded_sqrt=float(
                                 same_q.mean()) if n_valid else 1.0,
                             max_rel_err=serr,
                             max_abs_err=max(_abs_err(a[f], b[f], m)
                                             for f, m in compared))
    log(f"[epl] {name}: epl_stereo on {n_valid} points of a {c['budget']} "
        f"budget against the CPU plain version: codes differ at "
        f"{int((~agree).sum())} ({code_off:.4%}), {int(both_ok.sum())} OK on "
        f"both, share of bit-equal points "
        f"{row['epl_stereo']['bit_equal_share']:.6f} (with a correctly "
        f"rounded sqrt {row['epl_stereo']['bit_equal_share_rounded_sqrt']:.6f}"
        f"), max rel err (idepth, var where both OK; EPL length where the "
        f"codes agree) {serr:.3g}; second launch bit-equal")
    assert (a["code"] == q["code"]).all() and same_q.all(), (
        f"{name}: epl_stereo against the plain version with a correctly "
        f"rounded sqrt", int((a["code"] != q["code"]).sum()),
        int((~same_q).sum()))
    # every search kernel (each group size, commit 2bd7213's) on this
    # set-up and compaction: the same bits, ms in turns, the stamps' split
    row["epl_stereo"]["searches"] = search_variants(torch, card, name, s1,
                                                    stereo_args)

    # -- observe_fuse on the card's set-up and results: the same inputs,
    # so every pixel is held and the counts are equal (each launch adds
    # into its set-up's counts)
    f1, st1 = E.observe_fuse(c["state"], s1, g1, c["kf_max_grad"], c["ids"],
                             c["skip_inc"], dcfg)
    f2, st2 = E.observe_fuse(c["state"], s2, g2, c["kf_max_grad"], c["ids"],
                             c["skip_inc"], dcfg)
    fp, stp = O.fuse_plain(cpu(c["state"]), cpu(s1), cpu(g1), cpu(valid_k),
                           cpu(c["kf_max_grad"]), c["ids"], c["skip_inc"],
                           dcfg)
    torch.cuda.synchronize()
    st1, st2, stp = _ints(st1), _ints(st2), _ints(stp)
    assert _state_bits_equal(torch, f1, f2), (
        f"{name}: observe_fuse's second launch")
    assert st1 == st2, (name, st1, st2)
    ferr, fabs, fsame, _ = check_state(f"{name} fuse", f1, fp,
                                       stp["active"], st1, stp)
    row["observe_fuse"] = dict(bit_equal_share=fsame, max_rel_err=ferr,
                               max_abs_err=fabs, stats=st1)
    log(f"[epl] {name}: observe_fuse against the CPU plain version: every "
        f"pixel held, share of bit-equal pixels {fsame:.6f}, max rel err "
        f"{ferr:.3g}, stats {st1} (plain {stp}, equal); second launch "
        f"bit-equal")

    # -- the whole sweep through its entry, card against the CPU port, and
    # stage by stage (the entry's bits) to find the pixels whose searches
    # decided apart
    w1, ws1 = epl_sweep(O, c)
    w2, _ = epl_sweep(O, c)
    c_cpu = cpu(c)
    wp, wsp = epl_sweep(O, c_cpu)
    card_st = epl_stages(O, lie, c)
    refs = {"the CPU port": epl_stages(O, lie, c_cpu)}
    with rounded_sqrt(torch):
        refs["the CPU port with a correctly rounded sqrt"] = epl_stages(
            O, lie, c_cpu)
    torch.cuda.synchronize()
    assert _state_bits_equal(torch, w1, w2), f"{name}: second sweep"
    assert _state_bits_equal(torch, card_st[2], w1), (
        f"{name}: the card's stages against its entry")
    assert _state_bits_equal(torch, refs["the CPU port"][2], wp), (
        f"{name}: the CPU's stages against its entry")
    ws1, wsp = _ints(ws1), _ints(wsp)
    row["sweep"] = dict(active=ws1["active"], processed=ws1["processed"],
                        updated=ws1["updated"], created=ws1["created"],
                        killed=ws1["killed"],
                        blacklisted=ws1["blacklisted"])
    for ref_name, (r_setup, r_grids, r_state, r_stats) in refs.items():
        r_stats = _ints(r_stats)
        apart = inputs_apart(O, card_st[0], card_st[1], r_setup, r_grids)
        flips = search_flips(O, card_st[1], r_grids)
        codes_off = ((card_st[1].code.cpu() != r_grids.code)
                     | (card_st[0].process.cpu() != r_setup.process)).numpy()
        werr, wabs, wsame, off = check_state(
            f"{name} sweep, {ref_name}", card_st[2], r_state,
            r_stats["active"], ws1, r_stats, apart, codes_off)
        entry = dict(bit_equal_share=wsame, max_rel_err=werr,
                     max_abs_err=wabs, inputs_apart=int(apart.sum()),
                     off=int(off.sum()), search_flips=int(flips.sum()),
                     off_on_search_flips=int((off & flips).sum()),
                     stats_equal=ws1 == r_stats)
        if ref_name == "the CPU port":
            row["sweep"].update(entry)
        else:
            row["sweep"]["rounded_sqrt"] = entry
        log(f"[epl] {name}: the whole sweep (set-up, compaction, search, "
            f"fusion) on the card against {ref_name}: the fusion's inputs "
            f"differ in bits at {entry['inputs_apart']} pixels, the "
            f"searches decided apart at {entry['search_flips']}; "
            f"{entry['off']} pixels off the bounds, all of them among the "
            f"first ({entry['off_on_search_flips']} where a search "
            f"decided apart, the rest on a fusion threshold); every other "
            f"pixel held; share of bit-equal pixels {wsame:.6f}, max rel "
            f"err {werr:.3g}, stats {ws1} ({ref_name} {r_stats})")
    log(f"[epl] {name}: a second sweep bit-equal; the stages give the "
        f"entry's bits on the card and on the CPU")
    # the sweep on the card with the frame terms (pose inverse, K*R, K*t)
    # computed on the CPU as each reference computes them, then copied:
    # which of the pixels off each reference the frame terms explain
    for ref_name, rounded in (("the CPU port", False),
                              ("the CPU port with a correctly rounded sqrt",
                               True)):
        with rounded_sqrt(torch) if rounded else contextlib.nullcontext():
            terms = _moved(torch, epl_terms(O, lie, c_cpu), "cuda")
        r_setup, r_grids, r_state, r_stats = refs[ref_name]
        r_stats = _ints(r_stats)
        ct = epl_stages(O, lie, c, terms=terms)
        ct_stats = _ints(ct[3])
        apart = inputs_apart(O, ct[0], ct[1], r_setup, r_grids)
        codes_off = ((ct[1].code.cpu() != r_grids.code)
                     | (ct[0].process.cpu() != r_setup.process)).numpy()
        _, _, tsame, off = check_state(
            f"{name} sweep with the CPU's frame terms, {ref_name}", ct[2],
            r_state, r_stats["active"], ct_stats, r_stats, apart, codes_off)
        entry = row["sweep"] if not rounded else row["sweep"]["rounded_sqrt"]
        entry["cpu_frame_terms"] = dict(
            off=int(off.sum()), inputs_apart=int(apart.sum()),
            bit_equal_share=tsame, stats_equal=ct_stats == r_stats)
        log(f"[epl] {name}: the sweep on the card with {ref_name}'s frame "
            f"terms (computed on the CPU, copied): {int(off.sum())} pixels "
            f"off it (with the card's frame terms {entry['off']}), fusion "
            f"inputs apart at {int(apart.sum())} "
            f"(with the card's {entry['inputs_apart']}), share of bit-equal "
            f"pixels {tsame:.6f}, stats equal {ct_stats == r_stats}")

    # -- timings, beside the bounds
    plain_card = {
        "epl_prepare": lambda: O.epl_setup_plain(*setup_args),
        "epl_stereo": lambda: O.epl_search_plain(s1, *stereo_args),
        "observe_fuse": lambda: O.fuse_plain(
            c["state"], s1, g1, valid_k, c["kf_max_grad"], c["ids"],
            c["skip_inc"], dcfg)}
    kern = {
        "epl_prepare": lambda: E.epl_prepare(*setup_args),
        "epl_stereo": lambda: E.epl_stereo(s1, *stereo_args),
        "observe_fuse": lambda: E.observe_fuse(
            c["state"], s1, g1, c["kf_max_grad"], c["ids"], c["skip_inc"],
            dcfg)}
    bounds = epl_bounds(c, n_valid)
    for kname in E.KERNELS:
        t = time_in_turns(torch, [("kernel", kern[kname]),
                                  ("plain", plain_card[kname])], 5, 8)
        b_ms, b_by = bound_of(*bounds[kname])
        row[kname].update(ms=t["kernel"], plain_ms=t["plain"],
                          bound_ms=b_ms, bound_by=b_by,
                          bound_share=b_ms / t["kernel"],
                          bytes=bounds[kname][0], ops=bounds[kname][1])
        log(f"[epl] {name}: {kname} {t['kernel']:.5f} ms (plain torch ops "
            f"on the card {t['plain']:.4f} ms), bound {b_ms:.5f} ms "
            f"({b_by}: {bounds[kname][0]} B, {bounds[kname][1]} ops), "
            f"{b_ms / t['kernel']:.1%} of it; {card}")
    # does the sweep make the host wait for the card? (torch's sync debug
    # mode names the first operation that would)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        epl_sweep(O, c)
        synced = "none"
    except RuntimeError as exc:
        import traceback
        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                 for f in traceback.extract_tb(exc.__traceback__)
                 if "lsd_slam_tpu_torch" in f.filename]
        synced = (f"{str(exc).splitlines()[0][:120]} at "
                  f"{where[-1] if where else '?'}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row["sweep"]["host_waits"] = synced
    assert synced == "none", (name, synced)
    log(f"[epl] {name}: the sweep's first host wait for the card (torch's "
        f"sync debug mode): {synced}")
    shift = O.frame_shift(c["ids"][-1], n_pix)
    row["compaction_ms"] = time_gpu(
        torch, lambda: O.compact_active(s1.process, shift, c["budget"]), 10,
        8)
    log(f"[epl] {name}: the compaction (torch ops) "
        f"{row['compaction_ms']:.4f} ms; {card}")
    t = time_in_turns(torch, [("kernels", lambda: epl_sweep(O, c)),
                              ("plain", lambda: epl_stages(O, lie, c,
                                                           plain=True))],
                      3, 8)
    us = {"kernels": host_us_per_call(torch, lambda: epl_sweep(O, c), 30, 5),
          "plain": host_us_per_call(
              torch, lambda: epl_stages(O, lie, c, plain=True), 10, 5)}
    row["sweep"].update(ms=t["kernels"], plain_ms=t["plain"],
                        host_us=us["kernels"], plain_host_us=us["plain"])
    log(f"[epl] {name}: whole sweep {t['kernels']:.4f} ms device (plain "
        f"route on the card {t['plain']:.4f} ms), host {us['kernels']:.1f} "
        f"us per sweep (plain route {us['plain']:.1f} us); {card}")
    return row


def with_mixed_state(torch, c, seed=1):
    """The case on a state where creation, blacklisting and kills run: 30%
    of the pixels invalidated (the create path), the blacklist counter
    drawn from {-2, -1, 0} (below min_blacklist no pixel is created), and
    a fifth of the pixels at 0.95 max_var, which a failed update's
    fail_var_inc_fac pushes past max_var (a kill). Drawn from `seed`."""
    st = c["state"]
    h, w = st.valid.shape
    rng = np.random.default_rng(seed)
    dev = st.valid.device
    drop = torch.as_tensor(rng.uniform(size=(h, w)) < 0.3, device=dev)
    high = torch.as_tensor(rng.uniform(size=(h, w)) < 0.2, device=dev)
    black = torch.as_tensor(rng.integers(-2, 1, (h, w)).astype(np.int32),
                            device=dev)
    var = torch.where(high, torch.full_like(st.var, 0.95 * c["dcfg"].max_var),
                      st.var)
    return dict(c, state=st.replace(valid=st.valid & ~drop,
                                    blacklisted=black, var=var))


def threads_repeat(torch, stencil, n):
    """[slam-threads] and [slam-production], `n` times each (free-running,
    so each run takes its own path), each held to its phase's bars, a
    failure recorded, not raised: how often a threaded run, whose tracking
    never waits for the mapping thread, holds them."""
    results = {}
    for tag in ("slam-threads", "slam-production"):
        for i in range(n):
            try:
                threaded_phase(torch, stencil,
                               functools.partial(counted_plain, stencil), tag)
                ok, why = True, ""
            except Exception as exc:  # noqa: BLE001 - the run's verdict
                ok, why = False, repr(exc)[:400]
            results.setdefault(tag, []).append(ok)
            log(f"[threads-repeat] {tag} run {i + 1} of {n}: "
                + ("holds its bars" if ok else f"FAILS: {why}"))
    log(f"[threads-repeat] runs holding their bars: {json.dumps(results)}")
    return results


def epl_kernel_rows(rows):
    """The kernels line's entries of the observe sweep's three kernels: the
    [vo] sweep's numbers, every case beside them."""
    src = "lsd_slam_tpu_torch/csrc/epl_stereo.cu"
    jax = "lsd_slam_tpu/depth/observe.py"
    replaces = {
        "epl_prepare": (f"{jax}:62 (make_epl, XLA-fused jnp code; no "
                        f"Pallas counterpart)",
                        [f"{jax}:586", f"{jax}:430-462", f"{jax}:640-680"]),
        "epl_stereo": (f"{jax}:88-414 (line_stereo, XLA-fused jnp code; no "
                       f"Pallas counterpart)", [f"{jax}:417", f"{jax}:616"]),
        "observe_fuse": (f"{jax}:501 (_fuse_results, XLA-fused jnp code; "
                         f"no Pallas counterpart)", []),
    }
    cases = {k: v for k, v in rows.items()
             if k not in ("k10_chunks", "ties")}
    out = []
    for name, (main, also) in replaces.items():
        vo = rows["vo"][name]
        entry = dict(
            name=name, route="cuda", source=src, replaces=main,
            also_replaces=also,
            launches=sum(c.get(name, 0) for c in EPL_LAUNCHES.values()),
            path_launches={tag: c.get(name, 0)
                           for tag, c in EPL_LAUNCHES.items()},
            max_abs_err=max(c[name]["max_abs_err"] for c in cases.values()),
            shape="[vo]'s last 640x480 sweep, as the engine passed it",
            ms=vo["ms"], plain_ms=vo["plain_ms"], bound_ms=vo["bound_ms"],
            bound_by=vo["bound_by"], library_ms=None,
            library_note="none: no single PyTorch call runs the EPL search",
            cases={k: c[name] for k, c in cases.items()})
        if name == "epl_stereo":
            entry["sweeps"] = {k: c["sweep"] for k, c in cases.items()}
            entry["k10_chunks"] = rows["k10_chunks"]
            entry["ties"] = rows["ties"]
            entry["group"] = source_group()
        out.append(entry)
    return out


def flip_count(got, want, reg_bound):
    """(pixels whose EPL decision flipped, pixels where only the
    next_min_id dither differs, its largest step, the max abs error
    elsewhere) between two states, as [observe-multi] counts them."""
    decided = np.zeros(tuple(got.valid.shape), bool)
    diffs = {}
    for f in ("valid", "idepth", "var", "validity", "blacklisted",
              "idepth_smoothed", "var_smoothed"):
        a = getattr(got, f).cpu().numpy().astype(np.float64)
        b = getattr(want, f).cpu().numpy().astype(np.float64)
        diffs[f] = np.abs(a - b)
        decided |= diffs[f] > (0 if f in ("valid", "blacklisted")
                               else reg_bound)
    a = got.next_min_id.cpu().numpy()
    b = want.next_min_id.cpu().numpy()
    dither = (a != b) & ~decided
    err = max(float(d[~decided].max(initial=0.0)) for d in diffs.values())
    return (int(decided.sum()), int(dither.sum()),
            float(np.abs(a - b)[dither].max(initial=0.0)), err)


def chunk_experiment(torch, scn):
    """Queue 3 item 1: K = 10 maps as two chunks (frames 1-8, then 9-10).
    Chunk 1 on the card and on the CPU port; then chunk 2 from the CPU's
    chunk-1 state on both. Returns the flips after chunk 1, after chunk 2
    from one state, and after both chunks run apart (the [observe-multi]
    K = 10 case), and the card's searches (`recorded_searches`)."""
    pyr_c, dm_c = multi_depth_map(torch, scn, "cuda")
    pyr_p, dm_p = multi_depth_map(torch, scn, "cpu")
    with recorded_searches() as searches:
        multi_update(torch, scn, dm_c, pyr_c, range(1, 9), "cuda")
        multi_update(torch, scn, dm_p, pyr_p, range(1, 9), "cpu")
        after1 = flip_count(dm_c.state, dm_p.state, MULTI_BOUND)
        apart = dm_c.state
        dm_c.state = _moved(torch, dm_p.state, "cuda")
        assert dm_c.num_mapped_on_this == dm_p.num_mapped_on_this
        multi_update(torch, scn, dm_c, pyr_c, range(9, 11), "cuda")
        multi_update(torch, scn, dm_p, pyr_p, range(9, 11), "cpu")
        torch.cuda.synchronize()
        after2 = flip_count(dm_c.state, dm_p.state, MULTI_BOUND)
        dm_c.state = apart
        multi_update(torch, scn, dm_c, pyr_c, range(9, 11), "cuda")
        both = flip_count(dm_c.state, dm_p.state, MULTI_BOUND)
    return after1, after2, both, searches


def epl_phase(torch, card, vo_sweeps):
    """[epl]: the three kernels of csrc/epl_stereo.cu and the whole sweep
    on [vo]'s sweep of the most active points as the engine passed it
    (`recorded_observe_inputs`; the last one searches none), on
    [observe-multi]'s inputs at K = 1, 3, 8 (one sweep each) and at K = 3
    on a mixed state (`with_mixed_state`: the fusion's create, blacklist
    and kill branches run), on [vo]'s sweep built to tie and to hold NaNs
    (`ties_case`), then K = 10's chunk experiment, every search kernel
    (`search_variants`) on each chunk's sweep. Returns the kernels'
    rows."""
    scn = multi_scene(torch)
    active = [int(st["active"]) for _, st in vo_sweeps]
    pick = int(np.argmax(active))
    log(f"[epl] [vo]'s sweeps searched {active} active points; the case is "
        f"sweep {pick + 1} of {len(active)}")
    rows = {"vo": epl_case(torch, card, "vo",
                           epl_case_of_observe(vo_sweeps[pick][0]))}
    for k in (1, 3, 8):
        rows[f"multi-K{k}"] = epl_case(
            torch, card, f"multi K={k}",
            epl_case_of_multi(torch, scn, range(1, k + 1)))
    # the create, blacklist and kill branches of the fusion
    rows["multi-K3-mixed"] = row = epl_case(
        torch, card, "multi K=3 mixed state",
        with_mixed_state(torch, epl_case_of_multi(torch, scn, range(1, 4))))
    reached = {key: row["sweep"][key]
               for key in ("created", "blacklisted", "killed")}
    assert all(v > 0 for v in reached.values()), reached
    rows["ties"] = ties_case(torch, card,
                             epl_case_of_observe(vo_sweeps[pick][0]))
    after1, after2, both, searches = chunk_experiment(torch, scn)
    # every search kernel on the chunks' own set-ups and compactions
    names = ("chunk 1", "chunk 2 from the CPU's chunk-1 state",
             "chunk 2 run apart")
    assert len(searches) == len(names), len(searches)
    chunk_searches = {
        n: search_variants(torch, card, f"K=10 {n}", setup, a)
        for n, (setup, a) in zip(names, searches)}
    chunks = dict(after_chunk1=after1, chunk2_from_one_state=after2,
                  chunks_apart=both, searches=chunk_searches)
    log(f"[epl] K=10 chunks (flipped EPL decisions, dither-only pixels, "
        f"largest dither step, max abs err elsewhere), card against the CPU "
        f"port: after chunk 1 (frames 1-8) {after1}; chunk 2 (frames 9-10) "
        f"from the CPU's chunk-1 state on both {after2}; both chunks run "
        f"apart {both}")
    rows["k10_chunks"] = chunks
    return rows


# ---- the trackers' LM level loop

@contextlib.contextmanager
def recorded_lm_inputs(keep=4):
    """Record the arguments and keywords of the last `keep` calls of
    `tracking.lm.level` (what the trackers call; on the card it launches
    `lm_level`) while inside: the main path's own inputs of the kernel.
    The arguments are kept, not copied (the port writes no tracker input
    in place), so the recording adds no device work to the timed run.
    Yields the deque of (args, keywords); `level_args` turns one into the
    plain positional call [lm] replays."""
    import collections
    from lsd_slam_tpu_torch.tracking import lm

    seen = collections.deque(maxlen=keep)
    real = lm.level

    def call(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    lm.level = call
    try:
        yield seen
    finally:
        lm.level = real


@contextlib.contextmanager
def recorded_track_inputs(keep=1):
    """Record the arguments of the last `keep` SE(3) tracks
    (`tracking.se3_tracker.track`, which `SE3Tracker.track` calls) while
    inside, kept, not copied. Yields the deque."""
    import collections
    from lsd_slam_tpu_torch.tracking import se3_tracker as se3

    seen = collections.deque(maxlen=keep)
    real = se3.track

    def call(*a, **k):
        seen.append(a[:7])
        return real(*a, **k)

    se3.track = call
    try:
        yield seen
    finally:
        se3.track = real


def track_final_phase(torch, card, tracks, levels):
    """[vo]'s last SE(3) track, its final pass inside the last `lm_level`
    launch (`track_fused`), against the route before it (`track_plain`:
    the same kernels, then `final_pass_plain` and the tail in torch ops):
    the kernel launches and device operations of one track each way
    (torch.profiler) and its host us; the last level's device ms with and
    without the epilogue (CUDA events, in turns); and the fused final pass
    against `final_pass_plain` run on the CPU at the kernel's loop pose
    and affine pair: the good mask bit for bit, the in-image, good and bad
    counts exactly, the error and the usage within 1e-6 relative. Returns
    the numbers."""
    import dataclasses
    from lsd_slam_tpu_torch.ops import lm_track
    from lsd_slam_tpu_torch.tracking import se3_tracker as se3

    args = tracks[-1]
    fused = launches_in_one_call(torch, lambda: se3.track(*args))
    plain = launches_in_one_call(torch, lambda: se3.track_plain(*args))
    host_fused = host_us_per_call(torch, lambda: se3.track(*args), calls=50)
    host_plain = host_us_per_call(torch, lambda: se3.track_plain(*args),
                                  calls=20)
    (pose, aff_a, aff_b, pts, quad, cam, cfg, sigma2, sched), kw = levels[-1]
    assert kw.get("final"), kw
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)

    def last(final):
        return lm_track.lm_level(
            pose, aff_a, aff_b, fields, quad, cam, cfg, sigma2,
            dataclasses.asdict(sched), diverged=kw.get("diverged"),
            final_n_valid=pts.n_valid if final else None)
    turns = time_in_turns(torch, [("with", lambda: last(True)),
                                  ("without", lambda: last(False))], 20, 10)
    out = last(True)
    fin = out[7]
    cpu_pts = dataclasses.replace(pts, **{
        f.name: getattr(pts, f.name).cpu() for f in dataclasses.fields(pts)})
    stats, err, grid = se3.final_pass_plain(
        out[0].cpu(), out[1].cpu(), out[2].cpu(), cpu_pts, quad.cpu(), cam,
        cfg, sigma2)
    mask_equal = bool(torch.equal(fin.good_mask.cpu().reshape(-1), grid))
    counts = fin.counts.cpu().tolist()
    want = [int(stats["in_count"]), int(stats["good_count"]),
            int(stats["bad_count"])]
    pack = fin.pack.cpu().double()
    usage = float(stats["usage"] / torch.clamp_min(cpu_pts.n_valid, 1.0))
    err_rel = abs(float(pack[16]) - float(err)) / abs(float(err))
    usage_rel = abs(float(pack[17]) - usage) / abs(usage)
    row = dict(launches_fused=fused[0], device_ops_fused=fused[1],
               launches_plain=plain[0], device_ops_plain=plain[1],
               host_us_fused=host_fused, host_us_plain=host_plain,
               last_level_ms_with=turns["with"],
               last_level_ms_without=turns["without"],
               mask_equal=mask_equal, counts=counts, counts_plain=want,
               err_rel=err_rel, usage_rel=usage_rel,
               points=int(pts.idx.shape[-1]), trials=int(out[5]))
    log(f"[vo] one track: {fused[0]} kernel launches ({fused[1]} device "
        f"ops), {host_fused:.1f} us of host; the route before it "
        f"(track_plain) {plain[0]} launches ({plain[1]} device ops), "
        f"{host_plain:.1f} us; the last level ({cam.width}x{cam.height}, "
        f"{row['points']} points, {row['trials']} trials) with the "
        f"epilogue {turns['with']:.4f} ms, without {turns['without']:.4f} "
        f"ms (CUDA events, in turns); the final pass against the plain one "
        f"at its pose on the CPU: good mask bit-equal {mask_equal}, counts "
        f"{counts} / {want}, error {err_rel:.3g} and usage {usage_rel:.3g} "
        f"relative; {card}")
    assert mask_equal and counts == want, row
    assert err_rel <= 1e-6 and usage_rel <= 1e-6, row
    if fused[1] is not None:
        assert fused[1] <= 8, row
    return row


def level_args(rec):
    """A recorded `tracking.lm.level` call (args, keywords) as the plain
    positional call of the same loop: the SE(3) track's first level gets
    the inverse of its frame_to_ref (`invert`) and a None affine pair
    (1, 0) as tensors; the diverged input and the final pass, which do not
    change the loop, are left out."""
    import torch
    from lsd_slam_tpu_torch import lie

    a, k = rec
    pose, aff_a, aff_b = a[:3]
    if k.get("invert"):
        pose = lie.se3_inverse(pose)
    if aff_a is None:
        aff_a = torch.ones(pose.shape[:-1], device=pose.device)
        aff_b = torch.zeros(pose.shape[:-1], device=pose.device)
    return (pose, aff_a, aff_b) + tuple(a[3:])


def lm_bound(args, got):
    """The least time of one launch (`args` a recorded `tracking.lm.level`
    call, `got` its result): the bytes of every input read once (the point
    fields and the quad layout as given, shared or per lane, and the
    initial pose and affine pair) and every output written once, against
    LM_OPS_PER_POINT per point for every pass the lanes took (the first
    and one per trial: what these inputs needed). Returns (ms, "bytes" or
    "operations", passes)."""
    import torch
    from lsd_slam_tpu_torch.ops import lm_track

    pose, aff_a, aff_b, pts, quad = args[:5]
    moved = [getattr(pts, f) for f in lm_track.POINT_FIELDS] + [
        quad, pose, aff_a, aff_b, got.pose, got.aff_a, got.aff_b,
        got.last_err, got.diverged, got.trials, got.its]
    n_bytes = sum(t.numel() * t.element_size() for t in moved
                  if torch.is_tensor(t))
    passes = int((got.trials.long() + 1).sum())
    n_points = int(pts.idx.shape[-1])
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * n_points * LM_OPS_PER_POINT / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", passes)


@contextlib.contextmanager
def f64_sums():
    """Inside, the plain LM passes (tracking/se3_tracker.py) sum in f64 as
    the kernel does: every per-point term stays the f32 value the plain
    version computes, each sum over the points (the moments, the counts,
    the error, the normal equations' products) is taken in f64 and rounded
    to f32 once."""
    import torch
    from lsd_slam_tpu_torch.tracking import se3_tracker as se3

    real_torch, real_ne = se3.torch, se3._normal_equations

    class Torch64:
        def __getattr__(self, name):
            return getattr(real_torch, name)

        @staticmethod
        def sum(x, *a, **k):
            if x.dtype != real_torch.float32:
                return real_torch.sum(x, *a, **k)
            return real_torch.sum(x.double(), *a, **k).float()

    def normal_equations(buffers, weight):
        px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
        gx, gy, r = buffers["dx"], buffers["dy"], buffers["r"]
        z = 1.0 / pz
        z2 = z * z
        J = torch.stack([
            z * gx, z * gy, -px * z2 * gx - py * z2 * gy,
            -px * py * z2 * gx - (1.0 + py * py * z2) * gy,
            (1.0 + px * px * z2) * gx + px * py * z2 * gy,
            -py * z * gx + px * z * gy], dim=-1)
        n = torch.clamp_min(torch.sum(buffers["mask"], dim=-1),
                            1).to(torch.float32)
        Jw = J * weight.unsqueeze(-1)
        A = (Jw.unsqueeze(-1) * J.unsqueeze(-2)).double().sum(-3).float()
        g = (Jw * r.unsqueeze(-1)).double().sum(-2).float()
        return A / n[..., None, None], g / n[..., None]

    se3.torch, se3._normal_equations = Torch64(), normal_equations
    try:
        yield
    finally:
        se3.torch, se3._normal_equations = real_torch, real_ne


def mesh_witness(within, args):
    """The plain loop on the CPU as the witness of the kernel at lanes that
    start at the rounding floor of their noise-free images ([mesh]'s),
    where an ulp can send a lane's loop elsewhere. The CPU's: the card's
    torch divides a tensor by a Python float through the float's f32
    reciprocal, one ulp off the quotient that the kernel and the CPU's
    torch compute, which moves the first pass's error by up to 3.6e-4
    relative on these lanes (PERF.md section 6, PR 9). A lane is settled
    where the plain loop summing in f64 (`f64_sums`) and the plain loop on
    the lane's points in another order both meet the bounds (`within`)
    against the plain loop: there, rounding of the sums does not decide the
    result. Returns the plain loop's result and the settled lanes."""
    from lsd_slam_tpu_torch.tracking import lm

    def cpu(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return type(x)(**{f.name: cpu(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return x.cpu() if hasattr(x, "cpu") else x

    pose, a, b, pts, quads, *rest = [cpu(x) for x in args]
    plain = lm.level_plain(pose, a, b, pts, quads, *rest)
    with f64_sums():
        summed = lm.level_plain(pose, a, b, pts, quads, *rest)
    import torch
    perm = torch.randperm(int(pts.idx.shape[-1]),
                          generator=torch.Generator().manual_seed(1))
    moved = type(pts)(**{f.name: (getattr(pts, f.name) if f.name == "n_valid"
                                  else getattr(pts, f.name)[..., perm])
                         for f in dataclasses.fields(pts)})
    reordered = lm.level_plain(pose, a, b, moved, quads, *rest)
    settled = within(summed, plain) & within(reordered, plain)
    return types.SimpleNamespace(plain=plain, settled=settled)


def stamp_split(torch, launch, slots, clock_mhz, launches=5):
    """Where one launch of an LM level kernel spends its cycles, from its
    stamp buffer: `launch(stamps)` runs one launch that writes the first
    lane's leader `clock64()` into `stamps` (int64, `slots` long: the
    start, the end of its own sweep and the end of the fold of every pass,
    the end last) and returns the passes that lane ran. Per pass the
    leader thread's sweep (its own points), the fold (the rest of the
    sums, the barriers included) and the tail (the solve, the update and
    the barriers up to the next pass). Returns the medians over every pass
    of `launches` launches in cycles and in us at `clock_mhz`, and the
    passes a launch ran."""
    stamps = torch.zeros(slots, dtype=torch.int64, device="cuda")
    parts = {"sweep": [], "fold": [], "tail": []}
    for _ in range(launches):
        stamps.zero_()
        passes = launch(stamps)
        st = stamps.cpu().numpy()
        end = st[-1]
        for q in range(passes):
            s0, s1, s2 = st[3 * q:3 * q + 3]
            nxt = st[3 * (q + 1)] if q + 1 < passes else end
            parts["sweep"].append(s1 - s0)
            parts["fold"].append(s2 - s1)
            parts["tail"].append(nxt - s2)
    out = {"passes": passes}
    for k, v in parts.items():
        cyc = float(np.median(v))
        out[k] = dict(cycles=cyc, us=cyc / clock_mhz)
    return out


def split_text(split):
    return "".join(f" {k} {split[k]['cycles']:.0f} cycles "
                   f"{split[k]['us']:.2f} us;"
                   for k in ("sweep", "fold", "tail"))


def lm_phase_split(torch, args, clock_mhz, launches=5, **kw):
    """`stamp_split` of `lm_level` (`ops.lm_track.lm_level(stamps=...)`)
    on `args`, a recorded `tracking.lm.level` call."""
    from dataclasses import asdict
    from lsd_slam_tpu_torch.ops import lm_track

    pose, a, b, pts, quad, cam, cfg, sigma2, sched = args
    sched = asdict(sched)
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)

    def launch(stamps):
        out = lm_track.lm_level(pose, a, b, fields, quad, cam, cfg, sigma2,
                                sched, stamps=stamps, **kw)
        return int(out[5].reshape(-1)[0]) + 1
    return stamp_split(torch, launch, lm_track.stamp_slots(sched), clock_mhz,
                       launches)


@contextlib.contextmanager
def lm_baseline_entry(lib):
    """Inside, `ops.lm_track.lm_level` launches the entry of `lib`, the
    build of baselines/lm_track_04f70d1_stamped.cu (one block per lane,
    the stamp buffer: `lsd_lm_level(17 pointers, lanes, params, stream)`;
    its `Params` are the first fields of today's), for `--baseline-lm-cu`
    only."""
    from lsd_slam_tpu_torch.ops import lm_track

    fn = lib.lsd_lm_level
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p]
    real = lm_track._entry

    def entry():
        # drop the cluster and shared-memory sizes the old entry lacks
        return lambda *a: fn(*a[:18], *a[20:])

    lm_track._entry = entry
    try:
        yield
    finally:
        lm_track._entry = real


def every_cluster(torch, name, args, got, card):
    """`args` (a recorded `tracking.lm.level` call) launched at every
    power-of-two cluster size the card schedules: each gives the bits of
    `got` (the launch at the chosen size). Logs the chosen size, the tree
    and the staging, and the device ms at each size; returns them."""
    from dataclasses import asdict
    from lsd_slam_tpu_torch.ops import lm_track

    pose, a, b, pts, quad, cam, cfg, sigma2, sched = args
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)
    most = lm_track.max_cluster(pose.device)
    lanes = pose.reshape(-1, 7).shape[0]
    n = int(pts.idx.shape[-1])
    sms = torch.cuda.get_device_properties(pose.device).multi_processor_count
    chosen = lm_track.choose_cluster(lanes, n, sms, most)
    chunk, leaves, staged, smem = lm_track.launch_layout(n, chosen)
    want = [got.pose, got.last_err, got.diverged, got.trials, got.its]
    if torch.is_tensor(got.aff_a):
        want += [got.aff_a, got.aff_b]
    same, ms = {}, {}
    c = 1
    while c <= most:
        def launch(c=c):
            return lm_track.lm_level(pose, a, b, fields, quad, cam, cfg,
                                     sigma2, asdict(sched), cluster=c)
        out = launch()
        outs = [out[0], out[3], out[4], out[5], out[6]]
        if torch.is_tensor(got.aff_a):
            outs += [out[1], out[2]]
        same[c] = all(torch.equal(x.reshape(-1).view(torch.int32)
                                  if x.is_floating_point() else x.reshape(-1),
                                  y.reshape(-1).view(torch.int32)
                                  if y.is_floating_point() else y.reshape(-1))
                      for x, y in zip(outs, want))
        ms[c] = time_gpu(torch, launch, 10, 5)
        c *= 2
    log(f"[lm] {name}: cluster {chosen} chosen ({lanes} lanes, {sms} SMs, "
        f"the card's largest {most}); {leaves} chunks of {chunk} points, "
        f"{staged} points staged, {smem} B of shared memory a block; the "
        f"same bits at every cluster size: {same}; ms by cluster size "
        + ", ".join(f"{k}: {v:.4f}" for k, v in ms.items()) + f"; {card}")
    assert all(same.values()), (name, same)
    return dict(cluster=chosen, max_cluster=most, chunk=chunk,
                leaves=leaves, staged=staged, smem_bytes=smem,
                ms_by_cluster=ms)


def lm_phase(torch, card, vo_levels, baseline=None):
    """Phase [lm]: the kernel `lm_level` against its plain version
    (`tracking.lm.level_plain`) on the card, held to the bounds of
    tests/test_torch_lm.py (pose within LM_POSE_ATOL, the level's error
    within LM_ERR_RTOL relative, the affine pair within LM_AFF_ATOL, the
    diverged flags and the trial and accept counts equal), a second launch
    giving the first one's bits and every power-of-two cluster size the
    same bits (`every_cluster`):
      * the four levels of [vo]'s last tracked frame, on the inputs the
        main path gave the kernel (SE(3) schedule, B = 1);
      * the quick schedule over 64 lanes on [vo]'s level-4 inputs (the
        quick tracker's level at 640x480), each lane's init the recorded
        one disturbed (seeded), both ways the quick tracker batches: a
        point set per lane against one frame layout, and one point set
        against a layout per lane.
    Then [mesh]'s 64 quick lanes (BenchScene; a point set or a layout of
    its own per lane, both directions), held to the plain loop where
    rounding does not decide the result (`mesh_witness`), and timed.
    CUDA-event ms of the kernel and of the plain loop on the same inputs,
    beside their bound (`lm_bound`), and at [vo]'s levels where each
    launch spends its cycles (`lm_phase_split`). With
    `baseline` (a library, `--baseline-lm-cu`) the earlier kernel's split
    and its ms in turns with today's at [vo]'s levels. Returns the kernels
    line's numbers."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.tracking import lm
    from lsd_slam_tpu_torch.tracking.quick_tracker import stack_points

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def gaps(a, b):
        """Per lane: whether a meets the bounds against b, and the pose
        gap."""
        pose = (a.pose - b.pose).abs().reshape(-1, 7).max(dim=1).values
        fin = torch.isfinite(a.last_err) & torch.isfinite(b.last_err)
        err = torch.where(fin, (a.last_err - b.last_err).abs()
                          / b.last_err.abs(), torch.zeros_like(a.last_err))
        ok = ((pose <= LM_POSE_ATOL) & (err.reshape(-1) <= LM_ERR_RTOL)
              & (a.diverged == b.diverged).reshape(-1)
              & (a.trials == b.trials).reshape(-1)
              & (a.its == b.its).reshape(-1))
        if torch.is_tensor(a.aff_a):
            d = torch.maximum((a.aff_a - b.aff_a).abs(),
                              (a.aff_b - b.aff_b).abs()).reshape(-1)
            ok &= ~(d > LM_AFF_ATOL)       # NaN (a diverged lane) passes
        return ok, pose, err.reshape(-1)

    def run(args):
        got, again = lm.level(*args), lm.level(*args)
        want = lm.level_plain(*args)
        torch.cuda.synchronize()
        twice = all(torch.equal(bits(getattr(got, f)),
                                bits(getattr(again, f)))
                    for f in ("pose", "last_err", "diverged", "trials",
                              "its"))
        return got, want, twice

    def check(name, args):
        got, want, twice = run(args)
        ok, pose, err = gaps(got, want)
        log(f"[lm] {name}: trials kernel {got.trials.reshape(-1).tolist()} "
            f"/ plain {want.trials.reshape(-1).tolist()}, accepted "
            f"{got.its.reshape(-1).tolist()} / "
            f"{want.its.reshape(-1).tolist()}; diverged "
            f"{int(got.diverged.sum())} / {int(want.diverged.sum())} lanes; "
            f"max |pose - plain| {float(pose.max()):.3g} (bound "
            f"{LM_POSE_ATOL:g}), error {float(err.max()):.3g} relative "
            f"({LM_ERR_RTOL:g}); lanes within the bounds {int(ok.sum())} of "
            f"{len(ok)}; second launch bit-equal {twice}")
        assert twice and bool(ok.all()), (name, twice, pose, err)
        return got, float(pose.max())

    def times(args, per_batch):
        return (time_gpu(torch, lambda: lm.level(*args), per_batch, 10),
                time_gpu(torch, lambda: lm.level_plain(*args), 1, 3))

    assert len(vo_levels) == 4, len(vo_levels)
    vo_levels = [level_args(rec) for rec in vo_levels]
    clock_mhz = sm_clocks_mhz()[0]
    levels, worst = [], 0.0
    for args in vo_levels:
        cam = args[5]
        lvl = int(round(math.log2(640 / cam.width)))
        n_pts = int(args[3].idx.shape[-1])
        got, err = check(f"[vo] level {lvl} ({cam.width}x{cam.height}, "
                         f"{n_pts} points)", args)
        worst = max(worst, err)
        layout = every_cluster(torch, f"[vo] level {lvl}", args, got, card)
        ms, plain_ms = times(args, 20)
        b_ms, b_by, passes = lm_bound(args, got)
        levels.append(dict(level=lvl, points=n_pts, **layout,
                           trials=int(got.trials), its=int(got.its),
                           ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, passes=passes,
                           us_per_pass=ms * 1e3 / passes))
        log(f"[lm] [vo] level {lvl}: kernel {ms:.4f} ms ({passes} passes, "
            f"{ms * 1e3 / passes:.2f} us each), plain loop {plain_ms:.3f} "
            f"ms, bound {b_ms:.5f} ms ({b_by}); {card}")
        split = lm_phase_split(torch, args, clock_mhz)
        levels[-1]["phase_split"] = split
        log(f"[lm] [vo] level {lvl} phase split (median per pass over "
            f"{split['passes']} passes x 5 launches, at {clock_mhz:.0f} MHz):"
            + "".join(f" {k} {split[k]['cycles']:.0f} cycles "
                      f"{split[k]['us']:.2f} us;"
                      for k in ("sweep", "fold", "tail")) + f" {card}")
        if baseline is not None:
            with lm_baseline_entry(baseline):
                old = lm_phase_split(torch, args, clock_mhz)

            def old_level(args=args):
                with lm_baseline_entry(baseline):
                    return lm.level(*args)
            was = old_level()
            same = all(torch.equal(bits(getattr(got, f)),
                                   bits(getattr(was, f)))
                       for f in ("pose", "last_err", "diverged", "trials",
                                 "its", "aff_a", "aff_b"))
            turns = time_in_turns(torch, [
                ("kernel", lambda args=args: lm.level(*args)),
                ("baseline", old_level)], 20, 10)
            levels[-1].update(baseline_split=old, turns=turns,
                              baseline_bits_equal=same)
            log(f"[lm] [vo] level {lvl} baseline kernel: phase split"
                + "".join(f" {k} {old[k]['cycles']:.0f} cycles "
                          f"{old[k]['us']:.2f} us;"
                          for k in ("sweep", "fold", "tail"))
                + f" in turns: kernel {turns['kernel']:.4f} ms, baseline "
                f"{turns['baseline']:.4f} ms; the same bits as the "
                f"baseline: {same}; {card}")
    track = {k: sum(lv[k] for lv in levels)
             for k in ("ms", "plain_ms", "bound_ms")}
    if baseline is not None:
        track["turns"] = {k: sum(lv["turns"][k] for lv in levels)
                          for k in ("kernel", "baseline")}
        log(f"[lm] one track in turns: kernel {track['turns']['kernel']:.4f}"
            f" ms, baseline {track['turns']['baseline']:.4f} ms; {card}")
    # the track's bound is the sum of its levels': named by the larger part
    by_bytes = sum(lv["bound_ms"] for lv in levels
                   if lv["bound_by"] == "bytes")
    track["bound_by"] = ("bytes" if 2 * by_bytes >= track["bound_ms"]
                         else "operations")
    log(f"[lm] one track (levels 4..1): kernel {track['ms']:.4f} ms, plain "
        f"loop {track['plain_ms']:.3f} ms, bound {track['bound_ms']:.5f} ms; "
        f"{card}")

    # the quick schedule, 64 lanes on [vo]'s level-4 inputs
    pose4, _, _, pts4, quad4, cam4, cfg4, sigma2, _ = vo_levels[0]
    lanes = QUICK_LANES
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(np.concatenate(
        [rng.normal(0, 0.01, (lanes, 3)), rng.normal(0, 0.005, (lanes, 3))],
        axis=1), dtype=torch.float32, device=pose4.device)
    inits = lie.se3_mul(lie.se3_exp(noise), pose4.expand(lanes, 7))
    sched = lm.quick_schedule(cfg4)
    n4 = int(pts4.idx.shape[-1])
    quick = {}
    for name, pts, quads in (
            ("refs", stack_points([pts4] * lanes), quad4),
            ("frames", pts4, torch.stack([quad4] * lanes))):
        args = (inits, 1.0, 0.0, pts, quads, cam4, cfg4, sigma2, sched)
        got, err = check(f"quick {name}, {lanes} lanes on [vo]'s level 4",
                         args)
        worst = max(worst, err)
        layout = every_cluster(torch, f"quick {name}", args, got, card)
        ms, plain_ms = times(args, 20)
        b_ms, b_by, passes = lm_bound(args, got)
        quick[name] = dict(lanes=lanes, points=n4, **layout, ms=ms,
                           plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, passes=passes,
                           trials_max=int(got.trials.max()))
        log(f"[lm] quick {name} ([vo]'s level 4): kernel {ms:.4f} ms "
            f"({passes} passes over {lanes} blocks), plain loop "
            f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); {card}")

    # [mesh]'s lanes: distinct data per lane, held where rounding does not
    # decide, and timed
    tracker, refs, quad, frames, inits, one = quick_lanes(torch, lanes)
    caml = tracker.cam.level(tracker.level)
    sched = lm.quick_schedule(tracker.cfg)
    for name, pts, quads in (("refs", refs, quad), ("frames", one, frames)):
        args = (inits, 1.0, 0.0, pts, quads, caml, tracker.cfg,
                tracker.sigma2, sched)
        got, again = lm.level(*args), lm.level(*args)
        card_plain = lm.level_plain(*args)
        torch.cuda.synchronize()
        twice = all(torch.equal(bits(getattr(got, f)),
                                bits(getattr(again, f)))
                    for f in ("pose", "last_err", "diverged", "trials",
                              "its"))
        w = mesh_witness(lambda *a: gaps(*a)[0], args)
        kernel_ok = gaps(lm.LevelResult(*(
            x.cpu() if torch.is_tensor(x) else x for x in (
                got.pose, got.aff_a, got.aff_b, got.last_err, got.diverged,
                got.trials, got.its))), w.plain)[0]
        held = kernel_ok[w.settled]
        n_card = int(gaps(got, card_plain)[0].sum())
        ms, plain_ms = times(args, 20)
        n_pts = int(pts.idx.shape[-1])
        b_ms, b_by, passes = lm_bound(args, got)
        quick[f"mesh_{name}"] = dict(
            lanes=lanes, points=n_pts, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, passes=passes,
            settled_lanes=int(w.settled.sum()), kernel_held=int(held.sum()),
            kernel_within_bounds=int(kernel_ok.sum()),
            card_plain_within=n_card)
        log(f"[lm] [mesh]'s quick {name}: lanes the CPU witnesses settle "
            f"(the plain loop with f64 sums and on reordered points within "
            f"the bounds of the plain loop) {int(w.settled.sum())} of "
            f"{lanes} ({int((w.settled & (w.plain.its > 0)).sum())} with an "
            f"accepted step); the kernel within the bounds on "
            f"{int(held.sum())} of them, on {int(kernel_ok.sum())} of all "
            f"{lanes} (the card's "
            f"plain loop: {n_card}); mean errors "
            f"{float(w.plain.last_err.min()):.3g} to "
            f"{float(w.plain.last_err.max()):.3g}; second launch bit-equal "
            f"{twice}; kernel {ms:.4f} ms ({passes} passes), plain loop "
            f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); {card}")
        assert twice, name
        quick[f"mesh_{name}"].update(every_cluster(
            torch, f"[mesh]'s quick {name}", args, got, card))
        assert w.settled.any(), name
        assert bool(held.all()), (
            name, (w.settled & ~kernel_ok).nonzero().flatten().tolist())
    return dict(levels=levels, track=track, quick=quick, max_abs_err=worst)


# ---- the Sim(3) tracker's level kernel

# a recorded launch's lane sets, in the order of the constraint search's
# `track_pair_packed`: the new keyframe against the stacked candidates'
# frames, and the stacked candidates against the new keyframe
DIRECTIONS = ("frames", "refs")


@contextlib.contextmanager
def recorded_sim3_search():
    """While inside, record the calls of `tracking.sim3_tracker.levels`
    (what `_sim3_impl` calls; on the card each is one `sim3_level` launch
    over both directions of a constraint stage, the stage's last level
    with the final pass after its loop) made by the first constraint
    search (`KeyFrameGraph.test_constraints_batch`) that runs all three
    stages, each with its stage (0-2) and whether it ran the final pass.
    The arguments are kept, not copied (nothing writes a tracker input in
    place). Yields the list, filled when such a search returns."""
    from lsd_slam_tpu_torch.mapping.keyframe_graph import KeyFrameGraph
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    got = []
    cur = dict(calls=None, stage=-1)
    real_levels = st3.levels
    tracker = st3.Sim3Tracker
    real_pair = tracker.track_pair_packed
    real_search = KeyFrameGraph.test_constraints_batch

    def levels(*a, **k):
        if cur["calls"] is not None:
            cur["calls"].append(dict(stage=cur["stage"], args=a,
                                     final=bool(k.get("final", False))))
        return real_levels(*a, **k)

    def pair(self, *a, **k):
        cur["stage"] += 1
        return real_pair(self, *a, **k)

    def search(self, *a, **k):
        if got:
            return real_search(self, *a, **k)
        cur.update(calls=[], stage=-1)
        try:
            return real_search(self, *a, **k)
        finally:
            calls, cur["calls"] = cur["calls"], None
            if cur["stage"] == 2:
                got.extend(calls)

    st3.levels = levels
    tracker.track_pair_packed = pair
    KeyFrameGraph.test_constraints_batch = search
    try:
        yield got
    finally:
        st3.levels = real_levels
        tracker.track_pair_packed = real_pair
        KeyFrameGraph.test_constraints_batch = real_search


@contextlib.contextmanager
def sim3_f64_sums():
    """Inside, the plain Sim(3) passes (tracking/sim3_tracker.py) sum in
    f64 as `sim3_level` does: every per-point term stays the f32 value the
    plain version computes, each sum over the points (the moments, the
    counts, the usage, the error sums, LGS6 and LGS4) is taken in f64 and
    rounded to f32 once."""
    import torch
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    real_torch, real_ne = st3.torch, st3._sim3_normal_equations

    class Torch64:
        def __getattr__(self, name):
            return getattr(real_torch, name)

        @staticmethod
        def sum(x, *a, **k):
            if x.dtype != real_torch.float32:
                return real_torch.sum(x, *a, **k)
            return real_torch.sum(x.double(), *a, **k).float()

    def normal_equations(buffers, weight_p, weight_d):
        px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
        gx, gy = buffers["dx"], buffers["dy"]
        rp, rd = buffers["rp"], buffers["rd"]
        z = 1.0 / pz
        z2 = z * z
        j6 = torch.stack([
            z * gx, z * gy, -px * z2 * gx - py * z2 * gy,
            -px * py * z2 * gx - (1.0 + py * py * z2) * gy,
            (1.0 + px * px * z2) * gx + px * py * z2 * gy,
            -py * z * gx + px * z * gy], dim=-1)
        j4 = torch.stack([z2, z2 * py, -z2 * px, z], dim=-1)
        j6w = j6 * weight_p.unsqueeze(-1)
        j4w = j4 * weight_d.unsqueeze(-1)

        def outer(a, b):
            return (a.unsqueeze(-1) * b.unsqueeze(-2)).double().sum(-3).float()
        A6, A4 = outer(j6w, j6), outer(j4w, j4)
        b6 = (j6w * rp.unsqueeze(-1)).double().sum(-2).float()
        b4 = (j4w * rd.unsqueeze(-1)).double().sum(-2).float()
        A = A6.new_zeros(A6.shape[:-2] + (7, 7))
        A[..., :6, :6] = A6
        remap = torch.tensor(st3._REMAP, device=A.device)
        A[..., remap[:, None], remap[None, :]] += A4
        b = A6.new_zeros(A6.shape[:-2] + (7,))
        b[..., :6] = b6
        b[..., remap] += b4
        n = (torch.sum(buffers["mask"], dim=-1)
             + torch.sum(buffers["has_depth"], dim=-1))
        return A, b, torch.clamp_min(n, 1).to(torch.float32)

    st3.torch, st3._sim3_normal_equations = Torch64(), normal_equations
    try:
        yield
    finally:
        st3.torch, st3._sim3_normal_equations = real_torch, real_ne


def slam_search_inputs(torch):
    """[slam]'s scenario on the card (sequential, lag 0) up to the end of
    its first constraint search that runs all three stages; returns that
    search's recorded Sim(3) launches (`recorded_sim3_search`)."""
    ref = load_ref(SLAM_RUNS["slam"][0])
    sys_, _, frames = slam_setup(torch, ref)
    with recorded_sim3_search() as calls:
        sys_.gt_depth_init(frames[0][0], frames[0][1], 0, 0.0)
        for i in range(1, ref["n_frames"]):
            sys_.track_frame(frames[i][0], i, i / 30.0)
            if calls:
                break
    torch.cuda.synchronize()
    assert calls, "no constraint search of [slam] ran all three stages"
    return calls


def sim3_max_trials(rec):
    tracks, cam, cfg, sigma2, min_pts, max_its = rec["args"]
    return max_its + 4 * cfg.max_lm_rejects


def sim3_launch(rec, cluster=None, stamps=None):
    """`ops.lm_track.sim3_level` on a recorded `levels` call, as the
    tracker launches it (both directions in one launch, the final pass
    after the loop where the call had one), at cluster size `cluster`
    (None: the chosen one)."""
    from lsd_slam_tpu_torch.ops import lm_track
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    tracks, cam, cfg, sigma2, min_pts, max_its = rec["args"]
    pose, a, b, sets = st3.lane_table(tracks)
    return lm_track.sim3_level(pose, a, b, sets, cam, cfg, sigma2, min_pts,
                               max_its, sim3_max_trials(rec),
                               final=rec["final"], cluster=cluster,
                               stamps=stamps)


def sim3_final_alone(rec, out):
    """The final pass as a launch of its own (no trials) at the merged
    launch's result `out`: what its fused final pass must give."""
    from lsd_slam_tpu_torch.ops import lm_track
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    tracks, cam, cfg, sigma2 = rec["args"][:4]
    sets = st3.lane_table(tracks)[3]
    return lm_track.sim3_level(out[0], out[1], out[2], sets, cam, cfg,
                               sigma2, 0.0, 0, 0, final=True)


def sim3_bound(rec, outs, passes):
    """The least time of one `sim3_level` launch on a recorded call: every
    input read once (each set's point fields as given, 29 B a point,
    strided or not, shared or per lane; its quad layouts, 80 B a row; the
    poses and the affine pairs) and every output written once, against
    SIM3_OPS_PER_POINT per point for every pass the lanes took (the final
    pass included). Returns (ms, "bytes" or "operations")."""
    import torch
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    pose, a, b, sets = st3.lane_table(rec["args"][0])
    moved = [pose, a, b] + [t for fields, quad, _ in sets
                            for t in (*fields, quad)]
    moved += [t for t in outs if torch.is_tensor(t)]
    n_bytes = sum(t.numel() * t.element_size() for t in moved)
    n_points = int(sets[0][0][0].shape[-1])
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * n_points * SIM3_OPS_PER_POINT / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# sha256 of the one source --baseline-sim3-cu takes:
# baselines/sim3_track_681971f_stamped.cu, whose `lsd_sim3_level` has the
# ABI `baseline_sim3_launch` binds
SIM3_STAMPED_SHA256 = (
    "b142957b3561c7550c262aadbef4d7e90d4bb23db32a1765a5c7983e4a232f57")
# that kernel's launch layout: tiles of 8 warps x 32 x 43 f32, then 25 B a
# staged point (int32 index, five f32, the valid byte) up to 160 KB
BASELINE_SIM3_TILE_BYTES = 8 * 32 * 43 * 4
BASELINE_SIM3_STAGE_CAP = 160 * 1024 // 25


def baseline_sim3_params():
    """The ctypes struct of that kernel's `LsdSim3Params`: the three
    strides of one lane layout, then today's fields after the lane
    table."""
    from lsd_slam_tpu_torch.ops import lm_track

    class Params(ctypes.Structure):
        _fields_ = [("pts_stride", ctypes.c_longlong),
                    ("quad_stride", ctypes.c_longlong),
                    ("pts_step", ctypes.c_longlong)] + [
            f for f in lm_track.Sim3Params._fields_ if f[0] != "sets"]
    return Params


def baseline_sim3_launch(lib, track, cam, cfg, sigma2, min_pts, max_its,
                         max_trials, final=False, cluster=None,
                         stamps=None):
    """One launch of `lib` (the build of
    baselines/sim3_track_681971f_stamped.cu, for `--baseline-sim3-cu`) on
    one direction `track` = (pose, aff_a, aff_b, pts, frame_quad), as
    that commit's wrapper launched it: one lane layout by strides, its own
    staging (25 B a point), C by the lane count and the SMs alone.
    Returns the wrapper's eight outputs."""
    import torch
    from lsd_slam_tpu_torch.ops import lm_track
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    pose, a, b, pts, quad = track
    lanes = int(pose.shape[0])
    dev = pose.device
    fields, pstride, pstep, n = lm_track._sim3_points(
        tuple(getattr(pts, f) for f in st3._POINT_FIELDS), lanes)
    quad, qstride = lm_track._sim3_quad(quad, lanes)
    a_in, b_in = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  .reshape(-1).expand(lanes).contiguous() for x in (a, b))
    if cluster is None:
        cluster = lm_track.choose_cluster(
            lanes, n, torch.cuda.get_device_properties(
                dev).multi_processor_count,
            lm_track.max_cluster(dev, sim3=True))
    now = lm_track.make_sim3_params(cam, cfg, sigma2, min_pts, max_its,
                                    max_trials, n, quad.shape[-2], [],
                                    cluster)
    staged = min(now.leaves // cluster * now.chunk, n,
                 BASELINE_SIM3_STAGE_CAP)
    smem = BASELINE_SIM3_TILE_BYTES + -(-staged * 25 // 16) * 16
    Params = baseline_sim3_params()
    prm = Params(pts_stride=pstride, quad_stride=qstride, pts_step=pstep,
                 **{f: getattr(now, f) for f, _ in Params._fields_[3:]
                    if f != "staged"}, staged=staged)
    outs = [torch.empty(lanes, 8, dtype=torch.float32, device=dev)] + [
        torch.empty(lanes, dtype=torch.float32, device=dev)
        for _ in range(3)] + [
        torch.empty(lanes, dtype=torch.bool, device=dev)] + [
        torch.empty(lanes, dtype=torch.int32, device=dev) for _ in range(2)]
    fin = (torch.empty(lanes, lm_track.SIM3_FINAL, dtype=torch.float32,
                       device=dev) if final else None)
    fn = lib.lsd_sim3_level
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    rc = fn(*(t.data_ptr() for t in fields), quad.data_ptr(),
            pose.contiguous().data_ptr(), a_in.data_ptr(), b_in.data_ptr(),
            *(t.data_ptr() for t in outs),
            0 if fin is None else fin.data_ptr(),
            0 if stamps is None else stamps.data_ptr(), lanes, cluster,
            smem, ctypes.byref(prm), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline sim3_level launch failed: cudaError "
                           f"{rc}")
    return (*outs, fin)


def baseline_sim3_call(lib, rec, direction, cluster=None):
    """What commit 681971f's tracker launched for one direction of a
    recorded `levels` call: the level's launch and, where the call ran the
    final pass, one more launch with no trials at its result. Returns the
    level launch's outputs with the final values in place of its None."""
    tracks, cam, cfg, sigma2, min_pts, max_its = rec["args"]
    track = tracks[direction]
    out = baseline_sim3_launch(lib, track, cam, cfg, sigma2, min_pts,
                               max_its, sim3_max_trials(rec),
                               cluster=cluster)
    if not rec["final"]:
        return out
    fin = baseline_sim3_launch(lib, (out[0], out[1], out[2]) + track[3:],
                               cam, cfg, sigma2, 0.0, 0, 0, final=True,
                               cluster=cluster)
    return (*out[:7], fin[7])


def sim3_phase(torch, card, baseline=None):
    """[lm]'s Sim(3) cases: every `sim3_level` launch of [slam]'s first
    constraint search that runs all three stages (`slam_search_inputs`:
    stages (4,3), (2,2), (1,1); one launch a level over both directions,
    the lanes as the engine padded them; each stage's last level with the
    final pass after its loop), on the inputs the main path gave the
    kernel. Each direction of each launch is held to its plain version run
    on the CPU (`sim3_tracker.level_plain` / `final_pass_plain`), as
    `mesh_witness` holds `lm_level`: the kernel computes each per-point
    term as the CPU's torch does, and the card's torch divides by a Python
    float through its f32 reciprocal (PERF.md section 6), one ulp off,
    which degenerate lanes amplify (the plain loop on the card is run too,
    timed, and how many lanes it meets the bounds on is logged):
      * the level: the pose within SIM3_POSE_ATOL, the affine pair within
        LM_AFF_ATOL, the level's error within SIM3_ERR_RTOL relative, the
        diverged flags and the trial and accept counts equal, on every lane
        that settles: where the CPU's plain loop summing in f64 as the
        kernel does (`sim3_f64_sums`) meets the same bounds against the
        CPU's plain loop, so the rounding of the sums does not decide the
        lane's path;
      * the final pass (one pass at the level's result, the kernel's own):
        A within SIM3_HESS_RTOL of the lane's largest entry, the residual
        means and the usage within SIM3_ERR_RTOL relative, on every lane
        that settles (the f64-summing pass within those bounds; the
        padding lanes of the "frames" direction warp real points into zero
        layouts, a degenerate pass whose sums rounding decides); and its
        bits equal the final pass launched on its own at that result.
    A second launch gives the first one's bits, and every power-of-two
    cluster size the card schedules gives them too (the card's active
    clusters at each size are logged). CUDA-event ms of the kernel and the
    plain version per launch, per stage and for the search, beside the
    bound (`sim3_bound`), and where the launch spends its cycles
    (`stamp_split` on lane 0 of the "frames" direction). With `baseline`
    (the library of `--baseline-sim3-cu`): commit 681971f's kernel, run as
    that commit's tracker ran it (a launch per direction and level, the
    final pass a launch of its own), gives the same bits on every lane at
    every cluster size, and its split and its ms in turns with the merged
    launch.
    Returns the kernels line's numbers."""
    from lsd_slam_tpu_torch.ops import lm_track
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def same_bits(xs, ys):
        return all(torch.equal(bits(x), bits(y)) for x, y in zip(xs, ys)
                   if torch.is_tensor(x))

    def cpu(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return type(x)(**{f.name: cpu(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            return tuple(cpu(y) for y in x)
        return x.cpu() if torch.is_tensor(x) else x

    def rel(a, b):
        """|a - b| / |b|, 0 where both are equal (NaN included)."""
        a, b = a.double(), b.double()
        d = (a - b).abs() / b.abs().clamp_min(1e-30)
        return torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)),
                           torch.zeros_like(d), d)

    def level_gaps(a, b):
        """Per lane: whether level result a meets the bounds against b,
        and the pose gap."""
        pose = (a.pose - b.pose).abs()
        pose = torch.where(torch.isnan(a.pose) & torch.isnan(b.pose),
                           torch.zeros_like(pose), pose).max(dim=1).values
        aff = torch.maximum((a.aff_a - b.aff_a).abs(),
                            (a.aff_b - b.aff_b).abs())
        ok = ((pose <= SIM3_POSE_ATOL) & (rel(a.last_err, b.last_err)
                                          <= SIM3_ERR_RTOL)
              & ~(aff > LM_AFF_ATOL) & (a.diverged == b.diverged)
              & (a.trials == b.trials) & (a.its == b.its))
        return ok, pose

    def final_gaps(a, b):
        """The final pass's gaps, (5, lanes): the Hessian's relative to
        the lane's largest entry, then the residual means' and the
        usage's."""
        big = b[0].abs().flatten(1).max(dim=1).values.clamp_min(1e-30)
        hess = (a[0] - b[0]).abs().flatten(1).max(dim=1).values / big
        return torch.stack([hess.double()] + [rel(x, y)
                                              for x, y in zip(a[1:], b[1:])])

    def final_ok(gaps):
        """Per lane: the final pass's gaps within the bounds (NaN fails)."""
        return (gaps[0] <= SIM3_HESS_RTOL) & (gaps[1:] <= SIM3_ERR_RTOL).all(0)

    def final_values(fin):
        return (fin[:, 4:].reshape(-1, 7, 7), fin[:, 0], fin[:, 1],
                fin[:, 2], fin[:, 3])

    calls = slam_search_inputs(torch)
    dev = calls[0]["args"][0][0][0].device
    clock_mhz = sm_clocks_mhz()[0]
    most = lm_track.max_cluster(dev, sim3=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases, worst, n_settled = [], 0.0, 0
    stages = {}
    for rec in calls:
        tracks, cam, cfg, sigma2, min_pts, max_its = rec["args"]
        sizes = [int(t[0].shape[0]) for t in tracks]
        lanes = sum(sizes)
        n_pts = int(tracks[0][3].idx.shape[-1])
        lvl = int(round(math.log2(640 / cam.width)))
        head = (f"Sim(3) stage {rec['stage']}, level {lvl}"
                + (" and the final pass" if rec["final"] else "")
                + f" ({lanes} lanes: " + ", ".join(
                    f"{n} {d}" for n, d in zip(sizes, DIRECTIONS))
                + f"; {n_pts} points a lane)")
        out = sim3_launch(rec)
        again = sim3_launch(rec)
        torch.cuda.synchronize()
        twice = same_bits(out[:8], again[:8])
        settled_all = []
        for d, direction in enumerate(DIRECTIONS):
            track = tracks[d]
            name = f"{head} {direction}"
            cpu_args = cpu(tuple(track) + (cam, cfg, sigma2, min_pts,
                                           max_its))
            got = st3.LevelResult(*(x.split(sizes)[d].cpu()
                                    for x in out[:7]))
            want = st3.level_plain(*cpu_args)
            with sim3_f64_sums():
                summed = st3.level_plain(*cpu_args)
            settled = level_gaps(summed, want)[0]
            ok, pose_gap = level_gaps(got, want)
            on_card = level_gaps(cpu(st3.level_plain(
                *track, cam, cfg, sigma2, min_pts, max_its)), want)[0]
            held = ok[settled]
            if settled.any():
                worst = max(worst, float(pose_gap[settled].max()))
            log(f"[lm] {name}: trials kernel {got.trials.tolist()} / plain "
                f"{want.trials.tolist()}, accepted {got.its.tolist()} / "
                f"{want.its.tolist()}; diverged {int(got.diverged.sum())} / "
                f"{int(want.diverged.sum())} lanes; max |pose - plain| "
                f"{float(pose_gap.max()):.3g} (bound {SIM3_POSE_ATOL:g}), "
                f"error {float(rel(got.last_err, want.last_err).max()):.3g} "
                f"relative ({SIM3_ERR_RTOL:g}); lanes that settle (the CPU's "
                f"plain loop summing in f64 within the bounds of the CPU's "
                f"plain loop) {int(settled.sum())} of {sizes[d]}, the kernel "
                f"within the bounds on {int(held.sum())} of them "
                f"({int(ok.sum())} of all; the card's plain loop: "
                f"{int(on_card.sum())}); second launch bit-equal {twice}")
            assert twice and bool(held.all()), (name, twice, settled, ok)
            settled_all.append(int(settled.sum()))
            if not rec["final"]:
                continue
            fin = cpu(final_values(out[7].split(sizes)[d]))
            at = (got.pose, got.aff_a, got.aff_b) + cpu_args[3:8]
            want_f = st3.final_pass_plain(*at)
            with sim3_f64_sums():
                summed_f = st3.final_pass_plain(*at)
            settled_f = final_ok(final_gaps(summed_f, want_f))
            gaps = final_gaps(fin, want_f)
            ok_f = final_ok(gaps)
            held_f = ok_f[settled_f]
            hess = (float(gaps[0][settled_f].max()) if settled_f.any()
                    else 0.0)
            rest = (float(gaps[1:, settled_f].max()) if settled_f.any()
                    else 0.0)
            log(f"[lm] {name}, its final pass: lanes that settle (the "
                f"CPU's plain pass at the kernel's result summing in f64 "
                f"within the bounds of the CPU's plain pass) "
                f"{int(settled_f.sum())} of {sizes[d]}; on them the largest "
                f"gap of the kernel: Hessian {hess:.3g} of its largest "
                f"entry (bound {SIM3_HESS_RTOL:g}), residual means and "
                f"usage {rest:.3g} relative ({SIM3_ERR_RTOL:g}); within the "
                f"bounds on {int(ok_f.sum())} of all")
            assert bool(held_f.all()), (name, settled_f, gaps)
            settled_all.append(int(settled_f.sum()))
        fused_same = None
        if rec["final"]:
            alone = sim3_final_alone(rec, out)
            fused_same = torch.equal(bits(alone[7]), bits(out[7]))
            assert fused_same, (head, "fused final pass")
        active = {c: lm_track.sim3_active_clusters(
            dev, c, lm_track.launch_layout(n_pts, c, sim3=True)[3])
            for c in (1, 2, 4, 8, 16)}
        chosen = lm_track.choose_cluster(lanes, n_pts, sms, most, active.get)
        assert active[chosen] >= lanes, (head, chosen, active)
        chunk, leaves, staged, smem = lm_track.launch_layout(
            n_pts, chosen, sim3=True)
        by_c, size = {}, 1
        while size <= most:
            by_c[size] = same_bits(sim3_launch(rec, size)[:8], out[:8])
            size *= 2

        def kernel(rec=rec):
            return st3.levels(*rec["args"], final=rec["final"])

        def plain(rec=rec):
            return st3.levels_plain(*rec["args"], final=rec["final"])
        ms = time_gpu(torch, kernel, 10, 5)
        plain_ms = time_gpu(torch, plain, 1, 3)
        passes = int((out[5].long() + 1).sum()) + (lanes if rec["final"]
                                                   else 0)
        b_ms, b_by = sim3_bound(rec, out, passes)

        def stamped(stamps, rec=rec):
            got = sim3_launch(rec, stamps=stamps)
            return int(got[5][0]) + 1 + int(rec["final"])
        split = stamp_split(torch, stamped,
                            lm_track.sim3_stamp_slots(sim3_max_trials(rec)),
                            clock_mhz)
        log(f"[lm] {head}: the fused final pass gives the bits of the "
            f"final pass launched alone: {fused_same}; cluster {chosen} "
            f"chosen (the card's largest {most}; clusters the card holds "
            f"at once by size, at each size's shared memory: {active}); "
            f"{leaves} chunks of {chunk} points, {staged} points staged, "
            f"{smem} B of shared memory a block; the same bits at every "
            f"cluster size: {by_c}; kernel {ms:.4f} ms ({passes} passes), "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); phase "
            f"split (median per pass of lane 0 over {split['passes']} "
            f"passes x 5 launches, at {clock_mhz:.0f} MHz):"
            + split_text(split) + f" {card}")
        assert all(by_c.values()), (head, by_c)
        n_settled += sum(settled_all)
        case = dict(stage=rec["stage"], level=lvl, final=rec["final"],
                    lanes=sizes, points=n_pts, settled=settled_all,
                    cluster=chosen, active_clusters=active, chunk=chunk,
                    leaves=leaves, staged=staged, smem_bytes=smem,
                    passes=passes, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, phase_split=split)
        if baseline is not None:
            old_same = {}
            size = 1
            while size <= most:
                new = sim3_launch(rec, size)
                old_same[size] = all(
                    same_bits([x.split(sizes)[d] for x in new[:8]
                               if torch.is_tensor(x)],
                              [x for x in baseline_sim3_call(
                                  baseline, rec, d, size)
                               if torch.is_tensor(x)])
                    for d in range(len(DIRECTIONS)))
                size *= 2
            old_split = {}
            for d, direction in enumerate(DIRECTIONS):
                def old_stamped(stamps, d=d, rec=rec):
                    got = baseline_sim3_launch(
                        baseline, tracks[d], cam, cfg, sigma2, min_pts,
                        max_its, sim3_max_trials(rec), stamps=stamps)
                    return int(got[5][0]) + 1
                old_split[direction] = stamp_split(
                    torch, old_stamped, 3 * (sim3_max_trials(rec) + 1) + 1,
                    clock_mhz)

            def old(rec=rec):
                return [baseline_sim3_call(baseline, rec, d)
                        for d in range(len(DIRECTIONS))]
            turns = time_in_turns(torch, [("kernel", kernel),
                                          ("baseline", old)], 10, 6)
            case.update(baseline_bits_equal=old_same,
                        baseline_split=old_split, turns=turns,
                        baseline_launches=len(DIRECTIONS)
                        * (2 if rec["final"] else 1))
            log(f"[lm] {head}: commit 681971f's kernel (baseline, "
                f"{case['baseline_launches']} launches) gives the same bits "
                f"on every lane at every cluster size: {old_same}; its "
                f"phase split per direction (level launch, lane 0):"
                + "".join(f" {k}:" + split_text(v)
                          for k, v in old_split.items())
                + f" in turns: kernel {turns['kernel']:.4f} ms, baseline "
                f"{turns['baseline']:.4f} ms; {card}")
            assert all(old_same.values()), (head, old_same)
        cases.append(case)
        stage = stages.setdefault(rec["stage"], dict(
            ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0,
            baseline_turns_ms=0.0, kernel_turns_ms=0.0))
        stage["ms"] += ms
        stage["plain_ms"] += plain_ms
        stage["bound_ms"] += b_ms
        stage["launches"] += 1
        if baseline is not None:
            stage["kernel_turns_ms"] += case["turns"]["kernel"]
            stage["baseline_turns_ms"] += case["turns"]["baseline"]
    # every case held on its settled lanes; the search as a whole settles
    assert n_settled > 0, "no lane of the search settles"
    search = {k: sum(st[k] for st in stages.values())
              for k in ("ms", "plain_ms", "bound_ms", "launches",
                        "kernel_turns_ms", "baseline_turns_ms")}
    by_bytes = sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes")
    search["bound_by"] = ("bytes" if 2 * by_bytes >= search["bound_ms"]
                          else "operations")
    for k, st in sorted(stages.items()):
        log(f"[lm] Sim(3) stage {k} ({st['launches']} launches, both "
            f"directions): kernel {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.3f} ms, bound {st['bound_ms']:.5f} ms; {card}")
    log(f"[lm] Sim(3) constraint search ({search['launches']} launches): "
        f"kernel {search['ms']:.4f} ms, plain {search['plain_ms']:.3f} ms, "
        f"bound {search['bound_ms']:.5f} ms ({search['bound_by']}); {card}")
    if baseline is not None:
        log(f"[lm] Sim(3) constraint search in turns: kernel "
            f"{search['kernel_turns_ms']:.4f} ms ({search['launches']} "
            f"launches), commit 681971f's kernel "
            f"{search['baseline_turns_ms']:.4f} ms "
            f"({sum(c['baseline_launches'] for c in cases)} launches); "
            f"{card}")
    # a three-stage search: two levels at (4,3), one at (2,2) and (1,1),
    # each final pass inside its stage's last launch
    assert search["launches"] == 4, search
    return dict(cases=cases, stages=stages, search=search,
                max_abs_err=worst)


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
    function's name). The breakdown is informational: a profiler that
    cannot start or sees no kernel on the card (CUPTI tracing is not
    available on every machine) logs a note and gives None, and the
    CUDA-event times of the same calls stand; a failure of `fn` itself
    propagates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:  # noqa: BLE001 - informational breakdown
        log(f"[scatter] profiler unavailable: {exc!r}")
        prof = None
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    out = {}
    if prof is not None:
        prof.stop()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.device_time_total:
                continue
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            name = ("torch fill" if "FillFunctor" in name
                    else name.split("(")[0])
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    if not out:
        log("[scatter] torch.profiler saw no kernel on the card: no "
            "breakdown by kernel; the CUDA-event times of the order and "
            "the fold stand")
        return None
    return {k: round(v, 3) for k, v in out.items()}


# sha256 of the one source --baseline-lm-cu takes:
# baselines/lm_track_04f70d1_stamped.cu, whose `lsd_lm_level` has the ABI
# `lm_baseline_entry` binds
LM_STAMPED_SHA256 = (
    "0025b2e329d2ff0b52b53b15a76a5b285246fe80dbd4f1fed3ff88e5980a2d54")
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
    the fold by kernel (torch.profiler, where it traces the card; else
    None); each shape's bounds. Last, a
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


# ---- multi-device and multi-process: the mesh, the worker ranks

MESH_SHARDS = 4
QUICK_LANES = 64
QUICK_BOUND = 1e-5


@contextlib.contextmanager
def counted_segment_plain():
    """Count the calls of the order step's and the fold's plain versions
    while inside; yields a one-element list holding the count."""
    from lsd_slam_tpu_torch.ops import scatter

    calls = [0]
    plains = {name: getattr(scatter, name) for name in (
        "segment_order_plain", "segment_sum_plain")}

    def counted(fn):
        def call(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return call
    for name, fn in plains.items():
        setattr(scatter, name, counted(fn))
    try:
        yield calls
    finally:
        for name, fn in plains.items():
            setattr(scatter, name, fn)


def quick_lanes(torch, lanes):
    """`lanes` quick-track lanes at 640x480: eight BenchScene keyframes
    (ground-truth depth, var_gt_init_initial) at the quick level, each
    repeated with perturbed inits, against one later frame; returns
    (QuickTracker, stacked point sets, frame quad, frame quads, inits,
    one point set)."""
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.frames.pyramid import (build_depth_pyramid,
                                                   build_frame)
    from lsd_slam_tpu_torch.lie import np_sim3 as nps
    from lsd_slam_tpu_torch.tracking import quick_tracker as qt
    from lsd_slam_tpu_torch.tracking.reference import make_tracking_ref
    from lsd_slam_tpu_torch.utils import synth

    cfg = LSDConfig()
    cam = synth.default_camera(640, 480)
    tracker = qt.QuickTracker(cam, cfg.tracker,
                              sigma2=cfg.mapping.camera_pixel_noise2)
    scene = synth.BenchScene(seed=0)
    poses = synth.bench_trajectory(130)
    levels = cfg.system.pyramid_levels
    pts, quads = [], []
    for i in range(8):
        img, dep = synth.render_bench(scene, cam, poses[2 * i],
                                      device="cuda")
        pyr = build_frame(img, levels, cfg.mapping.min_use_grad)
        ok = dep > 0
        idepth = torch.where(ok, 1.0 / torch.where(ok, dep, 1.0), 0.0)
        ivar = torch.where(ok, 1.0 / cfg.depth.var_gt_init_initial, 0.0)
        ref = make_tracking_ref(pyr, build_depth_pyramid(idepth, ivar,
                                                         levels),
                                with_sim3=False)
        pts.append(ref.pts[tracker.level])
        quads.append(pyr.quad[tracker.level])
    img, _ = synth.render_bench(scene, cam, poses[20], device="cuda")
    quad = build_frame(img, levels, cfg.mapping.min_use_grad).quad[
        tracker.level]
    rng = np.random.default_rng(0)
    inits = []
    for k in range(lanes):
        rel = nps.se3_mul(poses[20], nps.se3_inverse(poses[2 * (k % 8)]))
        noise = np.concatenate([rng.normal(0, 0.01, 3),
                                rng.normal(0, 0.005, 3)])
        inits.append(nps.se3_mul(nps.se3_exp(noise), rel))
    inits = torch.as_tensor(np.asarray(inits, np.float32), device="cuda")
    refs = qt.stack_points([pts[k % 8] for k in range(lanes)])
    frames = torch.stack([quads[k % 8] for k in range(lanes)])
    return tracker, refs, quad, frames, inits, pts[0]


def mesh_phase(torch, card):
    """Phase [mesh]: the mesh programs of parallel/distributed.py in one
    process on `make_mesh(MESH_SHARDS, device="cuda")` (the shards spread
    over the cards in turn: on one card all four are that card, on four
    cards one shard each): the gathered dense assembly of a 64-vertex
    circle graph against `_assemble` (bit for bit),
    `PoseGraph(mesh)` (mesh_min_edges = 0) on [pgo-sparse]'s 1000-vertex
    circle against the ground truth (8e-3) and the one-device sparse solve
    (PGO_GAP), the sharded quick track of 64 lanes at 640x480 in both
    directions against the unsharded batch (flags equal, ref_to_frame
    within QUICK_BOUND); each a second time, bit for bit. Segment kernels
    launch, no plain version runs. Returns (segment_sum, segment_order)
    launches."""
    from lsd_slam_tpu_torch.lie import np_sim3 as nps
    from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph, _assemble
    from lsd_slam_tpu_torch.ops import lm_track, scatter
    from lsd_slam_tpu_torch.parallel import (
        distributed_pgo_normal_equations, make_mesh, sharded_quick_track,
        sharded_quick_track_frames)

    mesh = make_mesh(MESH_SHARDS, device="cuda")
    where = ("every shard is this card, so the cross-shard sums are ordered "
             "adds on it" if len(set(mesh.devices)) == 1 else
             "each shard's blocks and partials are copied to cuda:0 for the "
             "ordered sums")
    log(f"[mesh] {mesh.size} shards {[str(d) for d in mesh.devices]} on "
        f"{torch.cuda.device_count()} card(s): {where}; one process, no NCCL "
        f"collective runs; {card}")

    def secs(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with counted_segment_plain() as plain:
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        lm_track.LAUNCHES = 0
        lm_track.CLUSTER_SIZES.clear()
        # the gathered dense assembly, 64 vertices
        verts, edges, _ = circle_graph(64)
        pg = PoseGraph(device="cuda", mesh=mesh)
        for i, p in enumerate(verts):
            pg.add_vertex(p, fixed=(i == 0))
        for e in edges:
            pg.add_edge(*e)
        nb, a = pg._padded_arrays(mesh.size)
        args = [torch.as_tensor(a[k], device="cuda") for k in (
            "poses", "efrom", "eto", "meas_inv", "info", "delta")]
        assemble = distributed_pgo_normal_equations(mesh, nb)
        H, g, chi2 = assemble(*args)
        H1, g1, c1 = _assemble(*args, nb)
        (H2, g2, chi2_2), mesh_s = secs(lambda: assemble(*args))
        one_s = secs(lambda: _assemble(*args, nb))[1]
        same = (torch.equal(H, H1) and torch.equal(g, g1)
                and torch.equal(chi2, torch.sum(c1)))
        again = (torch.equal(H, H2) and torch.equal(g, g2)
                 and torch.equal(chi2, chi2_2))
        log(f"[mesh] dense assembly, {len(verts)} vertices ({nb} padded), "
            f"{len(edges)} edges ({len(a['efrom'])} padded) over "
            f"{mesh.size} shards: H, g, chi2 equal to `_assemble` bit for "
            f"bit {same}, second pass bit-equal {again}; "
            f"{mesh_s * 1e3:.2f} ms mesh, {one_s * 1e3:.2f} ms one device "
            f"(synchronised host clock, the second call of each)")
        assert same and again

        # PoseGraph(mesh) on the 1000-vertex circle: the sharded PCG step
        verts, edges, gt = circle_graph(1000)
        runs = {}
        for name in ("mesh", "mesh-again", "one device"):
            g_ = PoseGraph(device="cuda",
                           mesh=None if name == "one device" else mesh)
            g_.mesh_min_edges = 0
            for i, p in enumerate(verts):
                g_.add_vertex(p, fixed=(i == 0))
            for e in edges:
                g_.add_edge(*e)
            runs[name] = secs(lambda: g_.optimize(12))[1], g_.poses
        err = max(nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(p), q))
                  for p, q in zip(runs["mesh"][1], gt))
        gap = max(nps.sim3_log_norm(nps.sim3_mul(nps.sim3_inverse(p), q))
                  for p, q in zip(runs["mesh"][1], runs["one device"][1]))
        again = all(np.array_equal(p, q) for p, q in zip(
            runs["mesh"][1], runs["mesh-again"][1]))
        log(f"[mesh] PoseGraph(mesh).optimize(12), 1000 vertices, "
            f"{len(edges)} edges (the sharded PCG step, fixed budget 250): "
            f"max |log| to the ground truth {err:.4g} (bound 8e-3), to the "
            f"one-device sparse solve {gap:.4g} (bound {PGO_GAP:g}); second "
            f"pass bit-equal {again}; {runs['mesh'][0] * 1e3:.1f} ms per "
            f"solve on the mesh ({runs['mesh-again'][0] * 1e3:.1f} the "
            f"second time), {runs['one device'][0] * 1e3:.1f} ms on one "
            f"device; {card}")
        assert err < 8e-3 and gap < PGO_GAP and again, (err, gap, again)

        # the sharded quick track, 64 lanes at 640x480
        tracker, refs, quad, frames, inits, one = quick_lanes(torch,
                                                             QUICK_LANES)
        results = {}
        for name, track, data in (
                ("refs", sharded_quick_track(mesh, tracker),
                 (refs, quad, inits)),
                ("frames", sharded_quick_track_frames(mesh, tracker),
                 (one, frames, inits))):
            plain_track = (tracker.track_batch_pts if name == "refs"
                           else tracker.track_batch_frames)
            res, mesh_s = secs(lambda: track(*data))
            res2, mesh2_s = secs(lambda: track(*data))
            base, one_s = secs(lambda: plain_track(*data))
            gap = float((res.ref_to_frame - base.ref_to_frame).abs().max())
            flags = torch.equal(res.tracking_good, base.tracking_good)
            again = (torch.equal(res.ref_to_frame, res2.ref_to_frame)
                     and torch.equal(res.tracking_good, res2.tracking_good))
            results[name] = (gap, flags, again)
            log(f"[mesh] sharded quick track ({name}), {QUICK_LANES} lanes "
                f"at 640x480 (level {tracker.level}), "
                f"{int(res.tracking_good.sum())} good: flags equal to the "
                f"unsharded batch {flags}, max |ref_to_frame difference| "
                f"{gap:.3g} (bound {QUICK_BOUND:g}), second pass bit-equal "
                f"{again}; {mesh_s * 1e3:.1f} ms per batch on the mesh "
                f"({mesh2_s * 1e3:.1f} the second time, {res.n_syncs} host "
                f"syncs), {one_s * 1e3:.1f} ms on one device "
                f"({base.n_syncs} syncs); {card}")
        for name, (gap, flags, again) in results.items():
            assert flags and gap <= QUICK_BOUND and again, (name, gap)
        torch.cuda.synchronize()
        launches = scatter.LAUNCHES, scatter.ORDER_LAUNCHES
        LM_LAUNCHES["mesh"] = lm_track.LAUNCHES
        LM_CLUSTERS["mesh"] = dict(lm_track.CLUSTER_SIZES)
    log(f"[mesh] segment_sum launches {launches[0]}, segment_order launches "
        f"{launches[1]}, lm_level launches {LM_LAUNCHES['mesh']}, "
        f"plain-version calls {plain[0]}")
    assert min(launches) > 0 and plain[0] == 0, (launches, plain)
    assert LM_LAUNCHES["mesh"] > 0
    SEGMENT_LAUNCHES["mesh"], ORDER_LAUNCHES["mesh"] = launches
    return launches


PGO_RANK_TAG = "[pgo-rank] "


def circle_payload(n=1000):
    """[pgo-sparse]'s circle graph at n vertices as `PoseGraph`'s padded
    payload (what the frontend ships for an SPMD PGO)."""
    from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph

    verts, edges, _ = circle_graph(n)
    pg = PoseGraph(device="cpu")
    for i, p in enumerate(verts):
        pg.add_vertex(p, fixed=(i == 0))
    for e in edges:
        pg.add_edge(*e)
    return pg._padded_arrays()[1]


def pgo_rank(rank, world, coord, chan, out) -> int:
    """`chip_smoke.py --pgo-rank R W COORD CHAN OUT`: rank R of W (one card
    each: NCCL by `pick_backend`'s rule) runs the SPMD CG PGO of
    `circle_payload()`, broadcast from rank 0 over the host channel, for 12
    GN iterations; every rank must end with the same poses; rank 0 saves
    them to OUT. Prints its timing and counts behind PGO_RANK_TAG."""
    from lsd_slam_tpu_torch.ops import scatter
    from lsd_slam_tpu_torch.parallel.multihost import (
        HostChannel, init_multihost, shutdown_multihost)
    from lsd_slam_tpu_torch.parallel.multihost_engine import _spmd_pgo

    mesh = init_multihost(f"127.0.0.1:{coord}", world, rank)
    chan_ = HostChannel(rank, world, port=chan, timeout=120.0)
    payload = chan_.broadcast(circle_payload() if rank == 0 else None)
    scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
    t0 = time.perf_counter()
    poses = _spmd_pgo(payload, 12, mesh)
    secs = time.perf_counter() - t0
    same = all(np.array_equal(p, poses) for p in chan_.allgather(poses))
    if rank == 0:
        np.save(out, poses)
    chan_.barrier()
    chan_.close()
    shutdown_multihost()
    log(PGO_RANK_TAG + json.dumps(dict(
        rank=rank, backend=mesh.backend, device=str(mesh.main), secs=secs,
        collectives=mesh.collectives, staged_bytes=mesh.staged_bytes,
        segment_sum=scatter.LAUNCHES, segment_order=scatter.ORDER_LAUNCHES,
        same_on_every_rank=same)))
    return 0 if same else 1


def multihost_nccl_phase(torch, card):
    """Phase [multihost-nccl] (more than one card): one process per card
    (NCCL) running `pgo_rank`, whose poses must equal, bit for bit, the
    same SPMD PGO on the one-process mesh of one shard per card."""
    import tempfile

    from lsd_slam_tpu_torch.parallel import make_mesh
    from lsd_slam_tpu_torch.parallel.multihost_engine import _spmd_pgo

    n = torch.cuda.device_count()
    coord, chan = free_ports(2)
    out = os.path.join(tempfile.mkdtemp(prefix="lsd_pgo_"), "poses.npy")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--pgo-rank",
         str(r), str(n), str(coord), str(chan), out], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    done = []
    try:
        for p in procs:
            done.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, done)):
        if p.returncode != 0:
            raise RuntimeError(f"--pgo-rank {r} exit {p.returncode}:\n"
                               f"{o[-3000:]}\n{e[-3000:]}")
        log("[multihost-nccl] " + next(
            ln for ln in o.splitlines() if ln.startswith("[multihost]")))
        got = json.loads(o.splitlines()[-1][len(PGO_RANK_TAG):])
        log("[multihost-nccl] " + json.dumps(got))
        SEGMENT_LAUNCHES[f"multihost-nccl-rank{r}"] = got["segment_sum"]
        ORDER_LAUNCHES[f"multihost-nccl-rank{r}"] = got["segment_order"]
    mesh = make_mesh(n, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = _spmd_pgo(circle_payload(), 12, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    multi = np.load(out)
    same = np.array_equal(one, multi)
    log(f"[multihost-nccl] {n} ranks, one card each, against the one-process "
        f"mesh {[str(d) for d in mesh.devices]} ({secs * 1e3:.1f} ms): "
        f"poses bit-equal {same}, max |difference| "
        f"{float(np.abs(one - multi).max()):g}; {card}")
    assert same


def free_ports(k):
    """k ports the OS has free now (bound together, so they differ)."""
    import socket

    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def multihost_phase(card, frames, calib, root, want_kfs, want_edges,
                    want_traj, cli_fps, timeout=600):
    """Phase [multihost]: the runner in two fresh processes started
    together on the card, `chip_smoke.py --multihost-gates --counted-runner
    files:... calib:... out:... multihost:R:2:P:Q` for R = 0, 1 (the
    fan-out and SPMD PGO gates lowered as in
    tests/multihost_engine_worker.py). Both must exit 0 (each is killed at
    `timeout`), rank 1 print `multihost worker done`; rank 0's keyframe
    ids and edge pairs equal [cli]'s in-process run's and its TUM rows lie
    within 5e-3 of that trajectory; the frontend ran the SPMD PGO; the
    engine's relocaliser fanned out (`reloc_check`: the run's candidate
    search forms no batch at [cli]'s `initialization_phase_count`) and
    picked what rank 0 alone picks; rank 0 launched regularize_fused,
    both ranks the segment kernels, neither a plain version. Prints rank
    0's SPMD PGO seconds and the host seconds inside collectives. Returns
    rank 0's fused launches."""
    coord, chan = free_ports(2)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(root, f"out_mh{r}") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--multihost-gates", "--counted-runner", f"files:{frames}",
         f"calib:{calib}", f"out:{outs[r]}",
         f"multihost:{r}:2:{coord}:{chan}"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    done = []
    try:
        for p in procs:
            done.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, done)):
        if p.returncode != 0:
            raise RuntimeError(f"multihost rank {r} exit {p.returncode}:\n"
                               f"{out[-3000:]}\n{err[-3000:]}")
    counts = []
    for out, _ in done:
        lines = out.splitlines()
        assert lines[-1].startswith(COUNTS_TAG), out[-3000:]
        counts.append(json.loads(lines[-1][len(COUNTS_TAG):]))
        log("[multihost] " + next(ln for ln in lines
                                  if ln.startswith("[multihost]")))
    assert "multihost worker done" in done[1][0], done[1][0][-3000:]
    r0, r1 = counts
    done0 = [ln for ln in done[0][0].splitlines() if ln.startswith("done:")]
    fps = done_fps(done0[0])
    traj, kfs, edges, n_pts, _ = _runner_outputs(outs[0], CLI_FRAMES)
    gap = (float(np.abs(traj - want_traj).max())
           if traj.shape == want_traj.shape else float("inf"))
    log(f"[multihost] rank 0: {fps:.3f} fps ({CLI_FRAMES} frames; [cli]'s "
        f"hz:0 runner {cli_fps:.3f} fps), keyframes {kfs}, {len(edges)} "
        f"edges, {n_pts} points; max |TUM row - [cli] in-process| {gap:.3g} "
        f"(bound 5e-3); frontend fan-outs {r0['fanouts']}: "
        f"{r0['run_fanouts']} in the run, the engine's relocaliser "
        f"{r0['reloc_check']}, `fanout_check` {r0['fanout_check']} (bound "
        f"{QUICK_BOUND:g}); SPMD PGO calls {r0['pgo_calls']}, collectives "
        f"{r0['collectives']}, bytes staged through host memory "
        f"{r0['staged_bytes']}; rank 1 served {r1['served']}, collectives "
        f"{r1['collectives']}, staged bytes {r1['staged_bytes']}; {card}")
    log(f"[multihost] host time: the run {CLI_FRAMES / fps:.3f} s at rank "
        f"0's fps, rank 0's SPMD PGO {r0['pgo_secs']:.3f} s, inside "
        f"collectives (staging copies, the device work they wait on, the "
        f"wait for the other rank) {r0['collective_secs']:.3f} s on rank 0 "
        f"and {r1['collective_secs']:.3f} s on rank 1")
    log(f"[multihost] rank 0 launches: regularize_fused {r0['fused']}, "
        f"segment_sum {r0['segment_sum']}, segment_order "
        f"{r0['segment_order']}, lm_level {r0['lm']}, plain {r0['plain']}; "
        f"rank 1: regularize_fused {r1['fused']}, segment_sum "
        f"{r1['segment_sum']}, segment_order {r1['segment_order']}, "
        f"lm_level {r1['lm']}, plain {r1['plain']}")
    assert kfs == want_kfs, (kfs, want_kfs)
    assert edges == want_edges, (edges, want_edges)
    assert gap <= 5e-3, gap
    assert r0["pgo_calls"] > 0, r0
    reloc = r0["reloc_check"]
    assert reloc["kf"] is not None and reloc["same"], reloc
    # the relocaliser's quick tracks ran: rank 0 launched the LM kernel for
    # its share of the fanned batch (its quick loops pull no flag)
    assert reloc["fanouts"] > 0 and reloc["lm_launches"] > 0, reloc
    assert reloc["gap"] <= QUICK_BOUND, reloc
    check = r0["fanout_check"]
    assert check["flags_equal"] and check["gap"] <= QUICK_BOUND, check
    assert r0["fused"] > 0 and r0["accumulators"] == 0, r0
    for c in counts:
        assert min(c["segment_sum"], c["segment_order"]) > 0, c
        assert c["plain"] == 0 and c["segment_plain"] == 0, c
    for r, c in enumerate(counts):
        SEGMENT_LAUNCHES[f"multihost-rank{r}"] = c["segment_sum"]
        ORDER_LAUNCHES[f"multihost-rank{r}"] = c["segment_order"]
        LM_LAUNCHES[f"multihost-rank{r}"] = c["lm"]
        LM_CLUSTERS[f"multihost-rank{r}"] = c["lm_clusters"]
        SIM3_LAUNCHES[f"multihost-rank{r}"] = c["sim3"]
        SIM3_CLUSTERS[f"multihost-rank{r}"] = c["sim3_clusters"]
        EPL_LAUNCHES[f"multihost-rank{r}"] = c["epl"]
    assert r0["lm"] > 0, r0
    # rank 0 runs the engine: its sweeps went through the three kernels
    assert min(r0["epl"].values()) > 0, r0["epl"]
    assert len(set(r0["epl"].values())) == 1, r0["epl"]
    return r0["fused"]


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
    from lsd_slam_tpu_torch.ops import epl_stereo, lm_track
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
        lm_track.LAUNCHES = lm_track.SIM3_LAUNCHES = 0
        lm_track.CLUSTER_SIZES.clear()
        lm_track.SIM3_CLUSTER_SIZES.clear()
        epl_stereo.reset_counts()
        seen = []
        finalize = SlamSystem.finalize

        def finalize_seen(sys_):
            seen.append(sys_)
            return finalize(sys_)
        SlamSystem.finalize = finalize_seen
        try:
            out["warmup"] = warmup(cam, cfg)
        finally:
            SlamSystem.finalize = finalize
        st = seen[0].stats.snapshot()
        out["warmup_sim3_syncs"] = st.get("sim3_syncs", 0)
        out["warmup_searches"] = st.get("sim3_stage0_n", 0)
        out["warmup_search_launches"] = search_launches(st)
        out["warmup_fused"] = stencil.FUSED_LAUNCHES
        out["warmup_segment_sum"] = scatter.LAUNCHES
        out["warmup_segment_order"] = scatter.ORDER_LAUNCHES
        out["warmup_lm"] = lm_track.LAUNCHES
        out["warmup_lm_clusters"] = dict(lm_track.CLUSTER_SIZES)
        out["warmup_sim3"] = lm_track.SIM3_LAUNCHES
        out["warmup_sim3_clusters"] = dict(lm_track.SIM3_CLUSTER_SIZES)
        out["warmup_epl"] = epl_stereo.counts()
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
        f"{w['warmup_segment_sum']} segment_sum, "
        f"{w['warmup_segment_order']} segment_order, {w['warmup_lm']} "
        f"lm_level and {w['warmup_sim3']} sim3_level launches) gt_depth_init "
        f"{w['init_ms']:.1f} ms, first frame steps "
        f"{[round(x, 1) for x in w['frame_ms']]} ms; {card}")
    assert w["warmup"]["keyframes"] >= 2 and w["warmup"]["reloc_warmed"]
    assert w["warmup_fused"] > 0 and w["warmup_segment_sum"] > 0
    assert w["warmup_segment_order"] > 0 and w["warmup_lm"] > 0
    # its constraint searches ran on the kernel and pulled no Sim(3) flag
    assert w["warmup_searches"] > 0 and w["warmup_sim3_syncs"] == 0, w
    assert w["warmup_sim3"] == w["warmup_search_launches"], w
    SEGMENT_LAUNCHES["warmup"] = w["warmup_segment_sum"]
    ORDER_LAUNCHES["warmup"] = w["warmup_segment_order"]
    LM_LAUNCHES["warmup"] = w["warmup_lm"]
    LM_CLUSTERS["warmup"] = w["warmup_lm_clusters"]
    SIM3_LAUNCHES["warmup"] = w["warmup_sim3"]
    SIM3_CLUSTERS["warmup"] = w["warmup_sim3_clusters"]
    assert_epl_on_path("warmup", w["warmup_epl"])
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


# the hole fill's shapes on the main path: TUM fr3 VGA and EuRoC cam0
FILL_SHAPES = ((480, 640), (480, 752))
# fill_holes' bound: 29 B a pixel read (valid 1; validity, idepth, var,
# blacklisted, max_grad, idepth_smoothed, var_smoothed 4 each), 21 B
# written (valid 1, five f32 planes); ~195 f32 operations a pixel
FILL_BYTES_PER_PX, FILL_OPS_PER_PX = 29 + 21, 195


def fill_args(torch, rng, h, w):
    """The planes and thresholds `stencil.fill_holes` takes, on the card:
    random_state with validities of a real state's scale (val5 spreads
    across the create and unblacklist thresholds) and a gradient plane."""
    from lsd_slam_tpu_torch.config import LSDConfig
    dcfg, mcfg = LSDConfig().depth, LSDConfig().mapping
    idepth, var, valid, _, id_sm, var_sm, bl = random_state(torch, rng, h, w)
    validity = torch.as_tensor(
        rng.uniform(0.0, 8.0, (h, w)).astype(np.float32), device="cuda")
    grad = torch.as_tensor(
        rng.uniform(0.0, 20.0, (h, w)).astype(np.float32), device="cuda")
    return (valid, idepth, var, validity, bl, grad, id_sm, var_sm,
            mcfg.min_use_grad, dcfg.min_blacklist,
            dcfg.val_sum_min_for_create, dcfg.val_sum_min_for_unblacklist,
            dcfg.var_random_init_initial)


def launches_in_one_call(torch, fn):
    """(kernel launches the host made, device operations the card ran, the
    device us of each operation by name) in one call of `fn`, from
    torch.profiler; Nones where the profiler sees no device activity
    (informational, as kernel_breakdown). A process's first profiler
    recording can miss the card's activity, so one that sees none is
    recorded once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - informational count
            log(f"[fill-holes] profiler unavailable: {exc!r}")
            return None, None, None
        events = prof.events()
        on_card = [e for e in events if e.device_type == DeviceType.CUDA]
        if on_card:
            break
    launches = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith(("cudaLaunch", "cuLaunch"))
                   for e in events)
    if not on_card:
        log("[fill-holes] torch.profiler saw no device activity")
        return None, None, None
    us = {}
    for e in on_card:
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        us[name] = us.get(name, 0.0) + e.device_time_total
    return launches, len(on_card), us


def fill_holes_phase(torch, stencil):
    """The hole fill's kernel (csrc/fill_holes.cu) against its plain
    version on the card, bit for bit on all six planes, at the main path's
    shapes and at 128x160; CUDA-event ms of both beside the bound, host us
    per call, and one profiler count of the launches inside a single call
    of each. Returns the kernel's row fields by shape."""
    rng = np.random.default_rng(18)
    rows = {}
    for h, w in FILL_SHAPES + ((128, 160),):
        args = fill_args(torch, rng, h, w)
        before = stencil.FILL_HOLES_LAUNCHES
        got = stencil.fill_holes(*args)
        want = stencil.fill_holes_plain(*args)
        torch.cuda.synchronize()
        assert stencil.FILL_HOLES_LAUNCHES == before + 1
        for name, a, b in zip(("valid", "idepth", "var", "validity",
                               "idepth_smoothed", "var_smoothed"), got, want):
            if a.dtype != b.dtype or not _bits_equal(torch, a, b):
                raise AssertionError(f"fill_holes {h}x{w} {name}: the "
                                     "kernel's bits differ from the plain "
                                     "version's")
        created = int((got[0] & ~args[0]).sum())
        log(f"[fill-holes] {h}x{w}: kernel == plain bit for bit on all six "
            f"planes ({created} holes filled)")
        if (h, w) not in FILL_SHAPES:
            continue
        t = dict(ms=time_gpu(torch, lambda: stencil.fill_holes(*args), 50,
                             60),
                 plain_ms=time_gpu(torch, lambda: stencil.fill_holes_plain(
                     *args), 2, 10),
                 host_us_per_call=host_us_per_call(
                     torch, lambda: stencil.fill_holes(*args)),
                 plain_host_us_per_call=host_us_per_call(
                     torch, lambda: stencil.fill_holes_plain(*args),
                     calls=5, repeats=5))
        t["bound_ms"], t["bound_by"] = bound(FILL_BYTES_PER_PX,
                                             FILL_OPS_PER_PX, h, w)
        t["roofline_pct"] = 100.0 * t["bound_ms"] / t["ms"]
        (t["launches_per_call"], t["device_ops_per_call"],
         t["kernel_us"]) = launches_in_one_call(
             torch, lambda: stencil.fill_holes(*args))
        (t["plain_launches_per_call"], t["plain_device_ops_per_call"],
         _) = launches_in_one_call(torch,
                                   lambda: stencil.fill_holes_plain(*args))
        log(f"[fill-holes] {h}x{w}: {json.dumps(t)}")
        if t["launches_per_call"] is not None:
            assert t["launches_per_call"] <= 3, t
        rows[f"{h}x{w}"] = t
    return rows


def check_fill_launches(tag, fills, sweeps, created):
    """A card path's hole fills went through the kernel: one an observe
    sweep, one or two a keyframe switch (the old keyframe's finalize, the
    new one's creation), at most one more at the run's finalize."""
    log(f"[{tag}] fill_holes launches {fills} over {sweeps} observe sweeps "
        f"and {created} keyframe switches")
    assert sweeps + created <= fills <= sweeps + 2 * created + 1, (
        tag, fills, sweeps, created)


def vo_fill_launches(torch, stencil, ref):
    """[vo]'s run with the hole fill's launches counted and no plain
    version called (`--fill-only`)."""
    from lsd_slam_tpu_torch.ops import epl_stereo

    with counted_plain(stencil) as plain_calls:
        stencil.FILL_HOLES_LAUNCHES = 0
        epl_stereo.reset_counts()
        sys_ = run_vo(torch, ref, profile=False)[0]
        fills = stencil.FILL_HOLES_LAUNCHES
        sweeps = epl_stereo.counts()["epl_prepare"]
    created = int(sys_.stats.snapshot().get("keyframes_created", 0))
    assert plain_calls[0] == 0, plain_calls
    assert sweeps == ref["n_frames"] - 1 - created, (sweeps, created)
    check_fill_launches("vo", fills, sweeps, created)
    return fills


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
            f"pull.pack {tm.median('pull.pack'):.2f}, switch "
            f"{tm.median('switch'):.1f}; keyframes "
            f"{[kf.id for kf in run.sys.keyframes]}; syncs per frame "
            f"{syncs / (len(run.sys.all_frame_poses) + 1):.2f}; {card}")


@contextlib.contextmanager
def lm_route(route: str):
    """Inside, the trackers' LM loops run as `route` says: "kernel" (the
    engine's own), "plain" (every LM loop on its plain version on the card
    as well: the SE(3) track's `track_plain` on `tracking.lm.level_plain`
    and the Sim(3) tracker's `levels_plain` (`level_plain`,
    `final_pass_plain`), one flag pull per trial, the host
    loops the port ran before the kernels) or "sim3-plain" (only the
    Sim(3) loop so: the port before this kernel); for `--lm-turns` only."""
    from lsd_slam_tpu_torch.tracking import lm
    from lsd_slam_tpu_torch.tracking import se3_tracker as se3
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    real = lm.level, se3.track, st3.levels
    if route == "plain":
        lm.level = lm.level_plain
        se3.track = se3.track_plain
    if route in ("plain", "sim3-plain"):
        st3.levels = st3.levels_plain
    try:
        yield
    finally:
        lm.level, se3.track, st3.levels = real


@contextlib.contextmanager
def epl_route(route: str):
    """Inside, the observe sweep's stages run as `route` says: "kernel"
    (the engine's own: `epl_prepare`, `epl_stereo`, `observe_fuse` on the
    card) or "plain" (each stage's plain version, torch ops on the card:
    the sweep the port ran before the kernels); for `--epl-turns` only."""
    from lsd_slam_tpu_torch.depth import observe

    real = observe.epl_setup, observe.epl_search, observe.fuse
    if route == "plain":
        observe.epl_setup = observe.epl_setup_plain
        observe.epl_search = observe.epl_search_plain
        observe.fuse = observe.fuse_plain
    try:
        yield
    finally:
        observe.epl_setup, observe.epl_search, observe.fuse = real


def lm_turns(torch, card, routes=("kernel", "sim3-plain", "plain", "plain",
                                  "sim3-plain", "kernel"),
             route_of=None, tag="lm-turns"):
    """`chip_smoke.py --lm-turns`: [vo]'s sequence, [slam]'s (lag 0, each
    frame synchronised) and [slam-pipelined]'s (lag 3) with the LM loops
    on the kernels, with only the Sim(3) loop on its plain version, and
    with every LM loop on its plain version (SE(3), quick and Sim(3)), in
    turns (kernel, sim3-plain, plain, plain, sim3-plain, kernel), on one
    card in one call: frames
    per second, p50 / p95 frame ms, the track stage's median (dispatch
    window), the switch frames' median, the constraint search per new
    keyframe, host syncs and LM trial flags per frame, keyframes, the
    observe stage's median. `--epl-turns` runs the same with the observe
    sweep's routes (`epl_route`: kernel, plain, plain, kernel)."""
    route_of = route_of or lm_route
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "vo_orbit_640x480.json")) as f:
        vo_ref = json.load(f)
    runs = (("slam", load_ref(SLAM_RUNS["slam"][0]), True),
            ("slam-pipelined", load_ref(SLAM_RUNS["slam-pipelined"][0]),
             False))
    for route in routes:
        with route_of(route):
            sys_, _, fms, _ = run_vo(torch, vo_ref, profile=False)
            st = sys_.stats.snapshot()
            steady = fms[1:]
            n = len(fms)
            log(f"[{tag}] {route} [vo]: "
                f"{len(steady) / (sum(steady) / 1e3):.3f} fps, p50 "
                f"{np.percentile(fms, 50):.3f} ms, p95 "
                f"{np.percentile(fms, 95):.3f} ms, track "
                f"{sys_.timers.median('track'):.2f} ms, observe "
                f"{sys_.timers.median('observe'):.2f} ms; syncs per frame "
                f"{sum(st.get(k, 0) for k in SYNC_KEYS) / n:.2f}, SE3 LM "
                f"flags {st.get('lm_syncs', 0):.0f}; {card}")
            for name, ref, sync_each in runs:
                run = run_slam(torch, ref, sync_each=sync_each)
                st = run.sys.stats.snapshot()
                n = ref["n_frames"]
                frames = len(run.sys.all_frame_poses) + 1
                searches = max(int(st.get("sim3_stage0_n", 0)), 1)
                search_ms = sum(st.get(f"sim3_stage{k}_ms", 0.0)
                                for k in range(3)) / searches
                sw = run.fms[run.sw]
                log(f"[{tag}] {route} [{name}]: "
                    f"{(n - 1) / run.track_s:.3f} fps, p50 "
                    f"{np.percentile(run.fms, 50):.3f} ms, p95 "
                    f"{np.percentile(run.fms, 95):.3f} ms, track "
                    f"{run.sys.timers.median('track'):.2f} ms, observe "
                    f"{run.sys.timers.median('observe'):.2f} ms, switch "
                    f"frames "
                    f"median {np.median(sw) if len(sw) else float('nan'):.1f}"
                    f" ms, constraint search {search_ms:.1f} ms per new "
                    f"keyframe; syncs per "
                    f"frame {sum(st.get(k, 0) for k in SYNC_KEYS) / frames:.2f}"
                    f", SE3 LM flags {st.get('lm_syncs', 0):.0f}, quick LM "
                    f"flags {st.get('quick_syncs', 0):.0f}, Sim3 LM flags "
                    f"{st.get('sim3_syncs', 0):.0f}; keyframes "
                    f"{[kf.id for kf in run.sys.keyframes]}; {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-cu",
                    help="an earlier stencil source to time against")
    ap.add_argument("--baseline-segment-cu",
                    help="the sort-and-walk segment_sum.cu of commit "
                    "7824632 (checked by its sha256), to time its route "
                    "(stable torch.sort + its kernel) in turns in "
                    "[scatter]")
    ap.add_argument("--baseline-lm-cu",
                    help="baselines/lm_track_04f70d1_stamped.cu (checked by "
                    "its sha256), for its phase split, its bits and its ms "
                    "in turns in [lm]")
    ap.add_argument("--baseline-sim3-cu",
                    help="baselines/sim3_track_681971f_stamped.cu (checked "
                    "by its sha256), for its bits at every cluster size, "
                    "its phase split and its ms in turns in [lm]'s Sim(3) "
                    "cases")
    ap.add_argument("--baseline-epl-cu",
                    help="baselines/epl_stereo_2bd7213.cu (checked by its "
                    "sha256), for its bits, its stamp split and its ms in "
                    "turns on every [epl] case")
    ap.add_argument("--pipeline-turns", action="store_true",
                    help="only time lag 0 against lag 3, in turns")
    ap.add_argument("--lm-turns", action="store_true",
                    help="only time the LM kernels against the plain LM "
                    "loops on [vo] and [slam]'s sequences, in turns")
    ap.add_argument("--lm-only", action="store_true",
                    help="only [vo] (its level inputs recorded) and [lm] "
                    "(one short call)")
    ap.add_argument("--epl-turns", action="store_true",
                    help="only time the observe sweep's kernels against its "
                    "plain torch route on [vo] and [slam]'s sequences, in "
                    "turns")
    ap.add_argument("--epl-only", action="store_true",
                    help="only [vo] (its last observe sweep recorded) and "
                    "[epl] (one short call)")
    ap.add_argument("--fill-only", action="store_true",
                    help="only [fill-holes] and [vo]'s hole-fill launches "
                    "(one short call)")
    ap.add_argument("--threads-repeat", type=int, metavar="N",
                    help="only [slam-threads] and [slam-production], N "
                    "times each, each held to its bars")
    ap.add_argument("--counted-runner", nargs=argparse.REMAINDER,
                    metavar="ARG", help="run io.runner.main(ARG...) with "
                    "the kernel counts as the last line ([cli] uses it)")
    ap.add_argument("--multihost-gates", action="store_true",
                    help="with --counted-runner: lower the fan-out and SPMD "
                    "PGO gates ([multihost] uses it)")
    ap.add_argument("--pgo-rank", nargs=5, metavar=("R", "W", "COORD",
                                                     "CHAN", "OUT"),
                    help="one rank of [multihost-nccl]'s SPMD PGO")
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
        return counted_runner(args.counted_runner, args.multihost_gates)
    if args.warmup_run:
        return warmup_run(args.warmup_run)
    if args.pgo_rank:
        r, w, coord, chan, out = args.pgo_rank
        return pgo_rank(int(r), int(w), int(coord), int(chan), out)
    from lsd_slam_tpu_torch.ops import build, epl_stereo, lm_track
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
    if args.baseline_lm_cu:
        with open(args.baseline_lm_cu, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != LM_STAMPED_SHA256:
            print(f"chip_smoke: {args.baseline_lm_cu} (sha256 {digest}) is "
                  "not baselines/lm_track_04f70d1_stamped.cu, the only "
                  "source whose ABI --baseline-lm-cu binds", file=sys.stderr)
            return 2
        extra["lm_baseline"] = os.path.abspath(args.baseline_lm_cu)
    if args.baseline_sim3_cu:
        with open(args.baseline_sim3_cu, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != SIM3_STAMPED_SHA256:
            print(f"chip_smoke: {args.baseline_sim3_cu} (sha256 {digest}) "
                  "is not baselines/sim3_track_681971f_stamped.cu, the only "
                  "source whose ABI --baseline-sim3-cu binds",
                  file=sys.stderr)
            return 2
        extra["sim3_baseline"] = os.path.abspath(args.baseline_sim3_cu)
    if args.baseline_epl_cu:
        with open(args.baseline_epl_cu, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != EPL_STAMPED_SHA256:
            print(f"chip_smoke: {args.baseline_epl_cu} (sha256 {digest}) is "
                  "not baselines/epl_stereo_2bd7213.cu, the only source "
                  "whose ABI --baseline-epl-cu binds", file=sys.stderr)
            return 2
        extra["epl_baseline"] = os.path.abspath(args.baseline_epl_cu)
    extra.update(epl_group_sources(build))
    secs = build.build(verbose=True, sources=extra)
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s")
    if args.pipeline_turns:
        pipeline_turns(torch, card)
        return 0
    if args.lm_turns:
        lm_turns(torch, card)
        return 0
    if args.epl_turns:
        lm_turns(torch, card, ("kernel", "plain", "plain", "kernel"),
                 epl_route, "epl-turns")
        return 0
    for key, path in extra.items():
        if key.startswith("epl_stereo_g"):
            EPL_SEARCHES[f"G{key[len('epl_stereo_g'):]}"] = ctypes.CDLL(
                str(build.library_path(key, path)))
    if "epl_baseline" in extra:
        EPL_SEARCHES["2bd7213"] = ctypes.CDLL(str(build.library_path(
            "epl_baseline", extra["epl_baseline"])))
    lm_base = sim3_base = None
    if "lm_baseline" in extra:
        lm_base = ctypes.CDLL(str(build.library_path(
            "lm_baseline", extra["lm_baseline"])))
    if "sim3_baseline" in extra:
        sim3_base = ctypes.CDLL(str(build.library_path(
            "sim3_baseline", extra["sim3_baseline"])))
    if args.lm_only:
        with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                               "vo_orbit_640x480.json")) as f:
            ref = json.load(f)
        with recorded_lm_inputs() as vo_levels, \
                recorded_track_inputs() as vo_tracks:
            run_vo(torch, ref, profile=False)
        track_final_phase(torch, card, vo_tracks, vo_levels)
        lm_phase(torch, card, vo_levels, lm_base)
        sim3_phase(torch, card, sim3_base)
        return 0
    if args.epl_only:
        with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                               "vo_orbit_640x480.json")) as f:
            ref = json.load(f)
        with recorded_observe_inputs() as vo_sweep:
            epl_stereo.reset_counts()
            sys_ = run_vo(torch, ref, profile=False)[0]
            created = int(sys_.stats.snapshot().get("keyframes_created", 0))
            # one sweep a tracked frame but the switch frames
            assert_epl_on_path("vo", epl_stereo.counts(),
                               sweeps=ref["n_frames"] - 1 - created)
        epl_phase(torch, card, vo_sweep)
        return 0
    if args.fill_only:
        fill_holes_phase(torch, stencil)
        with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                               "vo_orbit_640x480.json")) as f:
            ref = json.load(f)
        vo_fill_launches(torch, stencil, ref)
        return 0
    if args.threads_repeat:
        results = threads_repeat(torch, stencil, args.threads_repeat)
        return 0 if all(all(v) for v in results.values()) else 1
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
    fill_rows = fill_holes_phase(torch, stencil)
    seg_err, order_err, seg_t, sm_clock = scatter_phase(torch, card, walk)

    phase_done("build, kernels and scatter")

    # ---- 13., 17., 14., 16. sparse PGO, the mesh, appearance, warm-up ----
    pgo_sparse_phase(torch, card)
    phase_done("pgo-sparse")
    mesh_phase(torch, card)
    phase_done("mesh")
    if torch.cuda.device_count() > 1:
        multihost_nccl_phase(torch, card)
        phase_done("multihost-nccl")
    else:
        log("[multihost-nccl] skipped: one card (NCCL refuses two ranks on "
            "one device)")
    appearance_phase(torch, card)
    phase_done("appearance")
    warm_fused = warmup_phase(card)
    phase_done("warmup")

    # ---- 4. VO at full width ----
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "vo_orbit_640x480.json")) as f:
        ref = json.load(f)
    with counted_plain(stencil) as plain_calls, \
            recorded_lm_inputs() as vo_levels, \
            recorded_track_inputs() as vo_tracks, \
            recorded_observe_inputs() as vo_sweep:
        stencil.LAUNCHES = stencil.FUSED_LAUNCHES = 0
        stencil.FILL_HOLES_LAUNCHES = 0
        scatter.LAUNCHES = scatter.ORDER_LAUNCHES = 0
        lm_track.LAUNCHES = lm_track.FINAL_LAUNCHES = 0
        lm_track.CLUSTER_SIZES.clear()
        epl_stereo.reset_counts()
        sys_, poses, frame_ms, total_s = run_vo(torch, ref, profile=False)
        vo_epl = epl_stereo.counts()
        launches, fused_launches = stencil.LAUNCHES, stencil.FUSED_LAUNCHES
        vo_fills = stencil.FILL_HOLES_LAUNCHES
        SEGMENT_LAUNCHES["vo"] = scatter.LAUNCHES
        ORDER_LAUNCHES["vo"] = scatter.ORDER_LAUNCHES
        LM_LAUNCHES["vo"] = lm_track.LAUNCHES
        LM_CLUSTERS["vo"] = dict(lm_track.CLUSTER_SIZES)
        vo_finals = lm_track.FINAL_LAUNCHES
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
    assert_lm_on_path("vo", st, n - 1)
    # every track's final pass inside its last launch, none in torch ops
    # (plain_calls counts `final_pass_plain`)
    log(f"[vo] final passes inside lm_level {vo_finals} over {n - 1} "
        f"tracks (counter track_final_fused "
        f"{st.get('track_final_fused', 0):.0f} of frames_tracked "
        f"{st.get('frames_tracked', 0):.0f})")
    assert vo_finals == n - 1, (vo_finals, n)
    assert st.get("track_final_fused") == st.get("frames_tracked"), st
    track_final_phase(torch, card, vo_tracks, vo_levels)
    # one sweep a tracked frame but the switch frames
    assert_epl_on_path("vo", vo_epl, sweeps=n - 1 - created)
    log(f"[vo] stage ms (dispatch windows): {sys_.timers.summary()}")
    assert sys_.tracking_is_good, "tracking lost"
    assert created >= 1, "no keyframe switch"
    # one per tracked frame, two per switch frame instead of one, one at
    # finalize
    assert fused_launches >= n + created, (
        f"regularize_fused launched {fused_launches} < {n + created}")
    assert launches == 0 and plain_calls[0] == 0, (launches, plain_calls)
    check_fill_launches("vo", vo_fills, n - 1 - created, created)
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

    # ---- 19. the LM level kernel against its plain version ----
    lm_row = lm_phase(torch, card, vo_levels, lm_base)
    sim3_row = sim3_phase(torch, card, sim3_base)
    phase_done("lm")

    # ---- 20. the observe sweep's kernels against their plain versions ----
    epl_rows = epl_phase(torch, card, vo_sweep)
    phase_done("epl")

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


    log(f"[lm] lm_level launches by cluster size, per path: "
        f"{json.dumps(LM_CLUSTERS)}")
    log(f"[lm] sim3_level launches by cluster size, per path: "
        f"{json.dumps(SIM3_CLUSTERS)}")
    prop = seg_t["propagate-640x480"]
    seg_common = dict(
        source="lsd_slam_tpu_torch/csrc/segment_sum.cu",
        replaces="lsd_slam_tpu/depth/regularize.py:239-244 (XLA's "
                 "scatter-add in propagate; no Pallas counterpart)",
        also_replaces=["lsd_slam_tpu/mapping/pose_graph.py:57-63",
                       "lsd_slam_tpu/mapping/sparse_pgo.py:69-93",
                       "lsd_slam_tpu/mapping/appearance.py:93-105",
                       "lsd_slam_tpu/parallel/distributed.py:113-118",
                       "lsd_slam_tpu/parallel/distributed.py:180-203"],
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
             multihost_rank0_launches=cli_fused["multihost_rank0"],
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
        dict(name="lm_level", route="cuda",
             source="lsd_slam_tpu_torch/csrc/lm_track.cu",
             replaces="lsd_slam_tpu/tracking/se3_tracker.py:184-253 (the "
                      "XLA while_loop of _track_level; no Pallas "
                      "counterpart)",
             also_replaces=["lsd_slam_tpu/tracking/quick_tracker.py:66-104"],
             launches=sum(LM_LAUNCHES.values()), path_launches=LM_LAUNCHES,
             max_abs_err=lm_row["max_abs_err"],
             shape="one 640x480 track of [vo]: levels 4..1, B = 1",
             ms=lm_row["track"]["ms"], plain_ms=lm_row["track"]["plain_ms"],
             bound_ms=lm_row["track"]["bound_ms"],
             bound_by=lm_row["track"]["bound_by"],
             library_ms=None,
             library_note="no single PyTorch call runs an LM loop",
             levels=lm_row["levels"], quick=lm_row["quick"],
             path_clusters=LM_CLUSTERS),
        dict(name="sim3_level", route="cuda",
             source="lsd_slam_tpu_torch/csrc/sim3_track.cu",
             replaces="lsd_slam_tpu/tracking/sim3_tracker.py:265-314 (the "
                      "XLA while_loop of _sim3_impl; no Pallas "
                      "counterpart)",
             also_replaces=["lsd_slam_tpu/tracking/sim3_tracker.py:61-209",
                            "lsd_slam_tpu/tracking/sim3_tracker.py:321-350"],
             launches=sum(SIM3_LAUNCHES.values()),
             path_launches=SIM3_LAUNCHES,
             max_abs_err=sim3_row["max_abs_err"],
             shape="[slam]'s first three-stage constraint search at "
                   "640x480: one launch a level over both directions, "
                   "each stage's final pass inside its last launch",
             search_launches=sim3_row["search"]["launches"],
             ms=sim3_row["search"]["ms"],
             plain_ms=sim3_row["search"]["plain_ms"],
             bound_ms=sim3_row["search"]["bound_ms"],
             bound_by=sim3_row["search"]["bound_by"],
             library_ms=None,
             library_note="no single PyTorch call runs an LM loop",
             stages=sim3_row["stages"], cases=sim3_row["cases"],
             path_clusters=SIM3_CLUSTERS),
        *epl_kernel_rows(epl_rows),
        dict(name="fill_holes", route="cuda",
             source="lsd_slam_tpu_torch/csrc/fill_holes.cu",
             replaces="lsd_slam_tpu/depth/regularize.py:121 (the XLA-fused "
                      "fill_holes; no Pallas counterpart)",
             entry="lsd_fill_holes (two kernels: rows, then tiles)",
             vo_launches=vo_fills, max_abs_err=0.0,
             shape="640x480", **fill_rows["480x640"],
             euroc_752x480=fill_rows["480x752"], library_ms=None,
             library_note="no single PyTorch call fills holes"),
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
