"""The trackers' LM level loop on the card: the CUDA kernel's wrapper.

Replaces the XLA `lax.while_loop` programs `_track_level`
(lsd_slam_tpu/tracking/se3_tracker.py:184-253) and `_quick_impl`'s loop
(lsd_slam_tpu/tracking/quick_tracker.py:66-104). The kernel is
`csrc/lm_track.cu` (see its header for the design and the bound): one
cluster of C thread blocks per lane runs every trial of the level, so a
track pulls nothing to the host. Its plain version is `tracking/lm.py`
`level_plain`; `tracking.lm.level` sends CPU tensors there and CUDA
tensors here, and this wrapper launches the kernel or raises: it never
falls back.

The launch's shape is pure functions of the inputs and the card, tested
on the CPU: `tree_layout` cuts a lane's points into the sum tree's
chunks (from the point count alone, so the bits do not depend on C),
`choose_cluster` picks C from the lane count, the point count, the SM
count and the largest cluster the card schedules (`max_cluster`, asked
of the card once per device), and `launch_layout` sizes each block's
staged share of the points.

The wrapper takes tensors and scalars only (the point fields, the
schedule's constants as a mapping) and returns tensors; `tracking.lm`
builds its `LevelResult` from them, so this layer knows nothing of the
trackers.

`LAUNCHES` counts kernel launches and `CLUSTER_SIZES` the launches by
C; the engine's worker threads launch too, so both are bumped under a
lock.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig

# number of kernel launches (reset it to count a run), and of launches by
# cluster size (clear it with LAUNCHES)
LAUNCHES = 0
CLUSTER_SIZES = collections.Counter()
_COUNT_LOCK = threading.Lock()

# the sum tree: chunks of consecutive points, a warp each; one point a lane
# (CHUNK_TARGET) until there are LEAF_CAP chunks (16 blocks of 16 warps),
# larger chunks above that: a lane's points run as a serial chain, so
# shallow chunks hide latency, and past a chunk a warp they only queue
CHUNK_TARGET = 32
LEAF_CAP = 256
# blocks of a cluster per lane: at most the card's largest (16 on an H100,
# beyond the portable 8), and at least one chunk a block
CLUSTER_MAX = 16
# a block's dynamic shared memory: a tile of 32 x 33 f32 terms per warp (16
# warps), then its share of the point fields staged up to STAGE_BYTES (17 B
# a point: int32 index, three f32, the valid byte)
TILE_BYTES = 16 * 32 * 33 * 4
STAGE_POINT_BYTES = 17
STAGE_BYTES = 140 * 1024
STAGE_CAP = STAGE_BYTES // STAGE_POINT_BYTES


class Params(ctypes.Structure):
    """The kernel's by-value constants (`Params` in csrc/lm_track.cu)."""

    _fields_ = [
        ("pts_stride", ctypes.c_longlong), ("quad_stride", ctypes.c_longlong),
        ("n_points", ctypes.c_int), ("quad_rows", ctypes.c_int),
        ("w", ctypes.c_int), ("h", ctypes.c_int),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("cx", ctypes.c_float), ("cy", ctypes.c_float),
        ("u_hi", ctypes.c_float), ("v_hi", ctypes.c_float),
        ("var_weight", ctypes.c_float), ("sigma2", ctypes.c_float),
        ("huber_half", ctypes.c_float), ("min_points", ctypes.c_float),
        ("conv_eps", ctypes.c_float), ("step_min", ctypes.c_float),
        ("lam0", ctypes.c_float), ("success_fac", ctypes.c_float),
        ("fail_fac", ctypes.c_float),
        ("max_its", ctypes.c_int), ("max_trials", ctypes.c_int),
        ("quick", ctypes.c_int), ("use_affine", ctypes.c_int),
        ("chunk", ctypes.c_int), ("leaves", ctypes.c_int),
        ("staged", ctypes.c_int),
    ]


def _f32(x) -> float:
    """A Python number rounded to f32 as torch rounds a scalar operand."""
    return float(np.float32(x))


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def tree_layout(n_points: int):
    """(leaves, chunk) of a lane's sum tree: the points cut into `leaves`
    (a power of two, at most LEAF_CAP) chunks of `chunk` consecutive
    points, the fewest with chunks of at most CHUNK_TARGET points. The
    point count alone decides it, never the cluster or the lane count, so
    every cluster size sums in one order and a lane's bits do not depend
    on its batch."""
    leaves = min(_pow2_at_least(-(-n_points // CHUNK_TARGET)), LEAF_CAP)
    return leaves, max(-(-n_points // leaves), 1)


def choose_cluster(lanes: int, n_points: int, sm_count: int,
                   max_cluster: int) -> int:
    """The blocks of a lane's cluster: the largest power of two C with
    C <= max_cluster (what the card schedules, at most CLUSTER_MAX),
    lanes * C <= sm_count (every cluster of the launch on the card at
    once) and C <= the sum tree's chunks (at least one a block)."""
    most = min(max_cluster, CLUSTER_MAX, tree_layout(n_points)[0])
    c = 1
    while 2 * c <= most and lanes * 2 * c <= sm_count:
        c *= 2
    return c


def launch_layout(n_points: int, cluster: int):
    """(chunk, leaves, staged, smem) of a launch at cluster size C: the
    tree padded to max(leaves, C) zero chunks, the points a block stages
    (its share, at most STAGE_CAP) and its dynamic shared memory bytes
    (the warps' tiles and the staged points)."""
    leaves, chunk = tree_layout(n_points)
    leaves = max(leaves, cluster)
    share = min(leaves // cluster * chunk, n_points)
    staged = min(share, STAGE_CAP)
    return chunk, leaves, staged, TILE_BYTES + _stage_bytes(staged)


def _stage_bytes(staged: int) -> int:
    return -(-staged * STAGE_POINT_BYTES // 16) * 16


_MAX_CLUSTER = {}


def max_cluster(device: torch.device) -> int:
    """The largest power-of-two cluster (up to CLUSTER_MAX) of which the
    card holds one at the largest staging size, asked of the card once per
    device."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    got = _MAX_CLUSTER.get(dev)
    if got is None:
        with torch.cuda.device(dev):
            fn = _library().lsd_lm_max_cluster
            fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
            got = fn(TILE_BYTES + _stage_bytes(STAGE_CAP))
        if got < 1:
            raise RuntimeError(f"lm_level: the card schedules no cluster "
                               f"of this kernel (cudaError {-got})")
        _MAX_CLUSTER[dev] = got
    return got


def make_params(cam: Camera, cfg: TrackerConfig, sigma2: float,
                schedule: Mapping, n_points: int, quad_rows: int,
                pts_stride: int, quad_stride: int, cluster: int = 1
                ) -> Params:
    """The constants of one launch; each float is the f32 the plain
    version's torch op uses for the same Python constant. `schedule` holds
    the loop's constants (the fields of tracking/lm.py `Schedule`);
    `cluster` the blocks per lane."""
    h, w = cam.height, cam.width
    chunk, leaves, staged, _ = launch_layout(n_points, cluster)
    sched = {k: schedule[k] for k in (
        "quick", "max_its", "max_trials", "conv_eps", "step_min",
        "use_affine", "lam0", "success_fac", "fail_fac")}
    return Params(
        pts_stride=pts_stride, quad_stride=quad_stride, n_points=n_points,
        quad_rows=quad_rows, w=w, h=h, fx=_f32(cam.fx), fy=_f32(cam.fy),
        cx=_f32(cam.cx), cy=_f32(cam.cy), u_hi=_f32(w - 1.001),
        v_hi=_f32(h - 1.001), var_weight=_f32(cfg.var_weight),
        sigma2=_f32(sigma2), huber_half=_f32(cfg.huber_d / 2.0),
        min_points=_f32(cfg.min_goodperall_pixel_absmin * h * w),
        conv_eps=_f32(sched["conv_eps"]), step_min=_f32(sched["step_min"]),
        lam0=_f32(sched["lam0"]), success_fac=_f32(sched["success_fac"]),
        fail_fac=_f32(sched["fail_fac"]), max_its=int(sched["max_its"]),
        max_trials=int(sched["max_trials"]), quick=int(sched["quick"]),
        use_affine=int(sched["use_affine"]), chunk=chunk, leaves=leaves,
        staged=staged)


_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p]


def _library():
    from lsd_slam_tpu_torch.ops.build import load
    return load("lm_track")


def _entry():
    fn = _library().lsd_lm_level
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    return fn


def _lanes_of(name: str, t: torch.Tensor, lanes: int, dtype, tail: int):
    """A field shared by every lane (tail dims only) or one per lane
    (lanes, *tail); returns (contiguous tensor, lane stride in elements)."""
    if t.dtype != dtype:
        raise TypeError(f"lm_level: {name} must be {dtype}, got {t.dtype}")
    if t.dim() == tail:
        return t.contiguous(), 0
    if t.dim() == tail + 1 and t.shape[0] == lanes:
        t = t.contiguous()
        return t, t[0].numel()
    raise ValueError(f"lm_level: {name} of shape {tuple(t.shape)} is "
                     f"neither shared nor one per lane of {lanes}")


def stamp_slots(schedule: Mapping) -> int:
    """Entries of a stamp buffer: 3 for each of the 1 + max_trials
    passes, and the end."""
    return 3 * (int(schedule["max_trials"]) + 1) + 1


POINT_FIELDS = ("idx", "ival", "idp", "ivr", "valid")
_POINT_DTYPES = (torch.int64, torch.float32, torch.float32, torch.float32,
                 torch.bool)


def lm_level(pose, aff_a, aff_b, points: Sequence[torch.Tensor], frame_quad,
             cam: Camera, cfg: TrackerConfig, sigma2: float,
             schedule: Mapping, stamps: torch.Tensor = None,
             cluster: int = None):
    """One launch of the level loop for the lanes of `pose` ((7,) or
    (B, 7) f32 on a CUDA device). The affine pair is a tensor of the
    pose's lane shape or a Python float; `points` the point fields
    (POINT_FIELDS), each (N,) shared or (B, N); the quad layout (H*W, 12)
    shared or (B, H*W, 12); `schedule` the loop's constants (see
    `make_params`). Returns (pose, aff_a, aff_b, last_err, diverged,
    trials, its), tensors of the pose's lane shape. `stamps`, for
    measurement only (the engine never passes it), is an int64 CUDA
    tensor of at least `stamp_slots(schedule)` entries: the first lane's
    leader thread writes `clock64()` there at the start, the end of its
    sweep and the end of the fold of every pass (3 slots a pass, pass 0
    first), and at the loop's end in the last slot. `cluster` forces the
    blocks per lane (a power of two up to the card's `max_cluster`), for
    measurement only; by default `choose_cluster` picks it."""
    global LAUNCHES
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"lm_level: unsupported device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return lm_level(pose, aff_a, aff_b, points, frame_quad, cam, cfg,
                            sigma2, schedule, stamps, cluster)
    if pose.dtype != torch.float32 or pose.shape[-1] != 7 or pose.dim() > 2:
        raise ValueError(f"lm_level: pose must be f32 (7,) or (B, 7), got "
                         f"{pose.dtype} {tuple(pose.shape)}")
    lead = pose.shape[:-1]
    pose2 = pose.reshape(-1, 7).contiguous()
    lanes = pose2.shape[0]

    def lane_values(x):
        if torch.is_tensor(x):
            return x.to(torch.float32).reshape(-1).expand(lanes).contiguous()
        return torch.full((lanes,), float(x), dtype=torch.float32, device=dev)

    a_in, b_in = lane_values(aff_a), lane_values(aff_b)
    if len(points) != len(POINT_FIELDS):
        raise ValueError(f"lm_level: {len(points)} point fields, expected "
                         f"{POINT_FIELDS}")
    idx, pstride = _lanes_of("idx", points[0], lanes, torch.int64, 1)
    fields = [idx]
    for name, dtype, given in zip(POINT_FIELDS[1:], _POINT_DTYPES[1:],
                                  points[1:]):
        t, stride = _lanes_of(name, given, lanes, dtype, 1)
        if stride != pstride or t.shape != idx.shape:
            raise ValueError(f"lm_level: {name} {tuple(t.shape)} does not "
                             f"match idx {tuple(idx.shape)}")
        fields.append(t)
    quad, qstride = _lanes_of("frame_quad", frame_quad, lanes, torch.float32,
                              2)
    if quad.shape[-1] != 12:
        raise ValueError(f"lm_level: quad rows of {quad.shape[-1]} floats, "
                         "expected 12 ([I, gx, gy] x 4 taps)")
    if quad.data_ptr() % 16:
        raise ValueError("lm_level: the quad layout must start on a 16-byte "
                         "boundary (the kernel reads rows as float4)")
    quad_rows = quad.shape[-2]
    if quad_rows * 12 >= 2 ** 31 or cam.width * cam.height >= 2 ** 31:
        raise ValueError("lm_level: image too large for 32-bit indices")
    for t in fields + [quad, a_in, b_in]:
        if t.device != dev:
            raise ValueError(f"lm_level: a tensor on {t.device}, pose on "
                             f"{dev}")

    n_points = idx.shape[-1]
    most = max_cluster(dev)
    if cluster is None:
        cluster = choose_cluster(lanes, n_points,
                                 torch.cuda.get_device_properties(
                                     dev).multi_processor_count, most)
    elif cluster < 1 or cluster & (cluster - 1) or cluster > most:
        raise ValueError(f"lm_level: cluster {cluster} is not a power of two "
                         f"up to {most}")
    prm = make_params(cam, cfg, sigma2, schedule, n_points, quad_rows,
                      pstride, qstride, cluster)
    smem = launch_layout(n_points, cluster)[3]
    out_pose = torch.empty_like(pose2)
    out_a = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_a)
    out_err = torch.empty_like(out_a)
    out_div = torch.empty(lanes, dtype=torch.bool, device=dev)
    out_trials = torch.empty(lanes, dtype=torch.int32, device=dev)
    out_its = torch.empty_like(out_trials)
    stamp_ptr = 0
    if stamps is not None:
        if (stamps.device != dev or stamps.dtype != torch.int64
                or not stamps.is_contiguous()
                or stamps.numel() < stamp_slots(schedule)):
            raise ValueError("lm_level: stamps must be a contiguous int64 "
                             f"tensor on {dev} of {stamp_slots(schedule)} "
                             "entries or more")
        stamp_ptr = stamps.data_ptr()
    rc = _entry()(*(t.data_ptr() for t in fields), quad.data_ptr(),
                  pose2.data_ptr(), a_in.data_ptr(), b_in.data_ptr(),
                  out_pose.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                  out_err.data_ptr(), out_div.data_ptr(),
                  out_trials.data_ptr(), out_its.data_ptr(), stamp_ptr, lanes,
                  cluster, smem, ctypes.byref(prm),
                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lm_level kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        CLUSTER_SIZES[cluster] += 1
    return (out_pose.reshape(pose.shape), out_a.reshape(lead),
            out_b.reshape(lead), out_err.reshape(lead), out_div.reshape(lead),
            out_trials.reshape(lead), out_its.reshape(lead))
