"""The trackers' LM level loops on the card: the CUDA kernels' wrappers.

`lm_level` replaces the XLA `lax.while_loop` programs `_track_level`
(lsd_slam_tpu/tracking/se3_tracker.py:184-253) and `_quick_impl`'s loop
(lsd_slam_tpu/tracking/quick_tracker.py:66-104). The kernel is
`csrc/lm_track.cu` (see its header for the design and the bound): one
cluster of C thread blocks per lane runs every trial of the level, so a
track pulls nothing to the host. Its plain version is `tracking/lm.py`
`level_plain`; `tracking.lm.level` sends CPU tensors there and CUDA
tensors here, and this wrapper launches the kernel or raises: it never
falls back.

`sim3_level` does the same for the Sim(3) tracker's loop
(lsd_slam_tpu/tracking/sim3_tracker.py:265-314) with the kernel
`csrc/sim3_track.cu`, of the same design, over a table of one or two lane
sets (a constraint stage's two directions in one launch), with the
tracker's final pass after the loop (with no trials, that pass alone).
Its plain versions are `tracking/sim3_tracker.py` `level_plain` and
`final_pass_plain`, and `levels` / `final_pass` there route as
`tracking.lm.level` does.

The launch's shape is pure functions of the inputs and the card, tested
on the CPU: `tree_layout` cuts a lane's points into the sum tree's
chunks (from the point count alone, so the bits do not depend on C),
`choose_cluster` picks C from the lane count, the point count, the SM
count, the largest cluster the card schedules (`max_cluster`, asked of
the card once per device) and, for `sim3_level`, how many clusters of
each size the card holds at once (`sim3_active_clusters`), and
`launch_layout` sizes each block's staged share of the points.

The wrapper takes tensors and scalars only (the point fields, the
schedule's constants as a mapping) and returns tensors; `tracking.lm`
builds its `LevelResult` from them. What `lm_level` takes for the SE(3)
track alone (`invert`, a None affine pair, `diverged`, `final_n_valid`:
the track's start, its diverged OR and its final pass, see csrc/lm_track.cu)
is written in terms of the launch; the final pass's pack is the one
layout this layer shares with a tracker (se3_tracker.HOST_PACK's order).

`LAUNCHES` counts `lm_level` launches, `FINAL_LAUNCHES` those that ran
the final pass and `CLUSTER_SIZES` the launches by C, `SIM3_LAUNCHES` and
`SIM3_CLUSTER_SIZES` those of `sim3_level`; the engine's worker threads
launch too, so all are bumped under a lock.
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
FINAL_LAUNCHES = 0
CLUSTER_SIZES = collections.Counter()
SIM3_LAUNCHES = 0
SIM3_CLUSTER_SIZES = collections.Counter()
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
# sim3_level: tiles of 32 x 43 f32 terms (8 warps), then 33 B a staged
# point (its eight pose-free f32 terms and the valid byte), up to 63 KB:
# with its ~6 KB of static shared memory a block then takes at most half
# of an SM's 227 KB, so two fit an SM (more clusters at once)
SIM3_TILE_BYTES = 8 * 32 * 43 * 4
SIM3_STAGE_POINT_BYTES = 33
SIM3_STAGE_BYTES = 63 * 1024
SIM3_STAGE_CAP = SIM3_STAGE_BYTES // SIM3_STAGE_POINT_BYTES
# the per-lane values a final pass returns: the coupled, depth and
# photometric mean residuals, the usage sum and A (7 x 7)
SIM3_FINAL = 4 + 49
# what `lm_level`'s final pass writes per lane: the pack (FINAL_PACK
# entries in the order of tracking/se3_tracker.py HOST_PACK, the SE(3)
# track's host pack), the good-pixel grid, tracking_good and the in-image,
# good and bad counts
FINAL_PACK = 23
FinalPass = collections.namedtuple(
    "FinalPass", "pack good_mask tracking_good counts")


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
        ("staged", ctypes.c_int), ("invert", ctypes.c_int),
        ("max_diff_const", ctypes.c_float), ("max_diff_grad", ctypes.c_float),
        ("min_gpa", ctypes.c_float), ("min_gpgb", ctypes.c_float),
    ]


class Final(ctypes.Structure):
    """The final pass's outputs (`LsdLmFinal` in csrc/lm_track.cu)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "good_mask", "pack", "tracking_good", "counts", "n_valid")] + [
        ("n_valid_stride", ctypes.c_longlong)]


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
                   max_cluster: int, active=None) -> int:
    """The blocks of a lane's cluster: the largest power of two C with
    C <= max_cluster (what the card schedules, at most CLUSTER_MAX),
    lanes * C <= sm_count, C <= the sum tree's chunks (at least one a
    block) and, given `active` (C -> the clusters of C blocks the card
    holds at once at this launch's shared memory), active(C) >= lanes:
    every cluster of the launch on the card at once."""
    most = min(max_cluster, CLUSTER_MAX, tree_layout(n_points)[0])
    c = 1
    while (2 * c <= most and lanes * 2 * c <= sm_count
           and (active is None or active(2 * c) >= lanes)):
        c *= 2
    return c


def launch_layout(n_points: int, cluster: int, sim3: bool = False):
    """(chunk, leaves, staged, smem) of a launch at cluster size C: the
    tree padded to max(leaves, C) zero chunks, the points a block stages
    (its share, at most STAGE_CAP, or SIM3_STAGE_CAP for `sim3_level`) and
    its dynamic shared memory bytes (the warps' tiles and the staged
    points)."""
    leaves, chunk = tree_layout(n_points)
    leaves = max(leaves, cluster)
    share = min(leaves // cluster * chunk, n_points)
    staged = min(share, SIM3_STAGE_CAP if sim3 else STAGE_CAP)
    tiles = SIM3_TILE_BYTES if sim3 else TILE_BYTES
    return chunk, leaves, staged, tiles + _stage_bytes(staged, sim3)


def _stage_bytes(staged: int, sim3: bool = False) -> int:
    per = SIM3_STAGE_POINT_BYTES if sim3 else STAGE_POINT_BYTES
    return -(-staged * per // 16) * 16


_MAX_CLUSTER = {}


def max_cluster(device: torch.device, sim3: bool = False) -> int:
    """The largest power-of-two cluster (up to CLUSTER_MAX) of which the
    card holds one at the largest staging size of `lm_level` (or of
    `sim3_level`), asked of the card once per device and kernel."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    got = _MAX_CLUSTER.get((dev, sim3))
    if got is None:
        if sim3:
            smem = SIM3_TILE_BYTES + _stage_bytes(SIM3_STAGE_CAP, True)
            got = next((c for c in (16, 8, 4, 2, 1) if c <= CLUSTER_MAX
                        and sim3_active_clusters(dev, c, smem) > 0), 0)
        else:
            with torch.cuda.device(dev):
                fn = _library().lsd_lm_max_cluster
                fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
                got = fn(TILE_BYTES + _stage_bytes(STAGE_CAP))
        if got < 1:
            name = "sim3_level" if sim3 else "lm_level"
            raise RuntimeError(f"{name}: the card schedules no cluster "
                               f"of this kernel (cudaError {-got})")
        _MAX_CLUSTER[(dev, sim3)] = got
    return got


def make_params(cam: Camera, cfg: TrackerConfig, sigma2: float,
                schedule: Mapping, n_points: int, quad_rows: int,
                pts_stride: int, quad_stride: int, cluster: int = 1,
                invert: bool = False) -> Params:
    """The constants of one launch; each float is the f32 the plain
    version's torch op uses for the same Python constant. `schedule` holds
    the loop's constants (the fields of tracking/lm.py `Schedule`);
    `cluster` the blocks per lane; `invert` starts at the pose's
    inverse."""
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
        staged=staged, invert=int(bool(invert)),
        max_diff_const=_f32(cfg.max_diff_constant),
        max_diff_grad=_f32(cfg.max_diff_grad_mult),
        min_gpa=_f32(cfg.min_goodperall_pixel),
        min_gpgb=_f32(cfg.min_goodpergoodbad_pixel))


# lsd_lm_level's arguments: 17 pointers, lanes, cluster, smem, the params,
# the stream, div_in and the final pass's outputs
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p] * 4


def _library(name: str = "lm_track"):
    from lsd_slam_tpu_torch.ops.build import load
    return load(name)


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
             cluster: int = None, invert: bool = False,
             diverged: torch.Tensor = None,
             final_n_valid: torch.Tensor = None):
    """One launch of the level loop for the lanes of `pose` ((7,) or
    (B, 7) f32 on a CUDA device). The affine pair is a tensor of the
    pose's lane shape, a Python float, or None for both (the pair starts
    at (1, 0) and no fill is launched); `points` the point fields
    (POINT_FIELDS), each (N,) shared or (B, N); the quad layout (H*W, 12)
    shared or (B, H*W, 12); `schedule` the loop's constants (see
    `make_params`). Returns (pose, aff_a, aff_b, last_err, diverged,
    trials, its), tensors of the pose's lane shape.

    For the SE(3) track: `invert` starts the loop at the inverse of
    `pose` (the track's frame_to_ref); `diverged` (bool, the lane shape)
    is OR-ed into the returned flags; `final_n_valid` (the point set's
    f32 valid count, () or (B,)) runs the final pass after the loop and
    appends a `FinalPass` to the result: the pack (lane shape + (23,),
    se3_tracker.HOST_PACK's order), the good-pixel grid (bool, lane shape
    + (h, w)), tracking_good (bool) and the in-image, good and bad counts
    (int64, lane shape + (3,)).

    `stamps`, for measurement only (the engine never passes it), is an
    int64 CUDA tensor of at least `stamp_slots(schedule)` entries: the
    first lane's leader thread writes `clock64()` there at the start, the
    end of its sweep and the end of the fold of every pass (3 slots a
    pass, pass 0 first), and at the launch's end in the last slot.
    `cluster` forces the blocks per lane (a power of two up to the card's
    `max_cluster`), for measurement only; by default `choose_cluster`
    picks it."""
    global LAUNCHES, FINAL_LAUNCHES
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"lm_level: unsupported device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return lm_level(pose, aff_a, aff_b, points, frame_quad, cam, cfg,
                            sigma2, schedule, stamps, cluster, invert,
                            diverged, final_n_valid)
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

    if (aff_a is None) != (aff_b is None):
        raise ValueError("lm_level: give both of the affine pair or neither")
    a_in, b_in = ((None, None) if aff_a is None
                  else (lane_values(aff_a), lane_values(aff_b)))
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
    div_in = None
    if diverged is not None:
        if diverged.dtype != torch.bool or diverged.numel() != lanes:
            raise ValueError(f"lm_level: diverged must be bool of {lanes} "
                             f"lanes, got {diverged.dtype} "
                             f"{tuple(diverged.shape)}")
        div_in = diverged.reshape(-1).contiguous()
    nv = nv_stride = None
    if final_n_valid is not None:
        nv, nv_stride = _lanes_of("n_valid", final_n_valid, lanes,
                                  torch.float32, 0)
    for t in fields + [quad, a_in, b_in, div_in, nv]:
        if t is not None and t.device != dev:
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
                      pstride, qstride, cluster, invert)
    smem = launch_layout(n_points, cluster)[3]
    out_pose = torch.empty_like(pose2)
    out_a = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_a)
    out_err = torch.empty_like(out_a)
    out_div = torch.empty(lanes, dtype=torch.bool, device=dev)
    out_trials = torch.empty(lanes, dtype=torch.int32, device=dev)
    out_its = torch.empty_like(out_trials)
    fin = fin_ptr = None
    if nv is not None:
        fin = FinalPass(
            torch.empty(lanes, FINAL_PACK, dtype=torch.float32, device=dev),
            torch.empty(lanes, cam.height * cam.width, dtype=torch.bool,
                        device=dev),
            torch.empty(lanes, dtype=torch.bool, device=dev),
            torch.empty(lanes, 3, dtype=torch.int64, device=dev))
        fin_ptr = ctypes.byref(Final(
            good_mask=fin.good_mask.data_ptr(), pack=fin.pack.data_ptr(),
            tracking_good=fin.tracking_good.data_ptr(),
            counts=fin.counts.data_ptr(), n_valid=nv.data_ptr(),
            n_valid_stride=nv_stride))
    stamp_ptr = 0
    if stamps is not None:
        if (stamps.device != dev or stamps.dtype != torch.int64
                or not stamps.is_contiguous()
                or stamps.numel() < stamp_slots(schedule)):
            raise ValueError("lm_level: stamps must be a contiguous int64 "
                             f"tensor on {dev} of {stamp_slots(schedule)} "
                             "entries or more")
        stamp_ptr = stamps.data_ptr()

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _entry()(*(t.data_ptr() for t in fields), quad.data_ptr(),
                  pose2.data_ptr(), ptr(a_in), ptr(b_in),
                  out_pose.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                  out_err.data_ptr(), out_div.data_ptr(),
                  out_trials.data_ptr(), out_its.data_ptr(), stamp_ptr, lanes,
                  cluster, smem, ctypes.byref(prm),
                  torch.cuda.current_stream().cuda_stream, ptr(div_in),
                  fin_ptr)
    if rc != 0:
        raise RuntimeError(f"lm_level kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        FINAL_LAUNCHES += fin is not None
        CLUSTER_SIZES[cluster] += 1
    out = (out_pose.reshape(pose.shape), out_a.reshape(lead),
           out_b.reshape(lead), out_err.reshape(lead), out_div.reshape(lead),
           out_trials.reshape(lead), out_its.reshape(lead))
    if fin is None:
        return out
    h, w = cam.height, cam.width
    return out + (FinalPass(fin.pack.reshape(lead + (FINAL_PACK,)),
                            fin.good_mask.reshape(lead + (h, w)),
                            fin.tracking_good.reshape(lead),
                            fin.counts.reshape(lead + (3,))),)


class Sim3Set(ctypes.Structure):
    """One set of `sim3_level`'s lane table (`LsdSim3Set` in
    csrc/sim3_track.cu): its point fields and quad layouts, each shared by
    the set's lanes (stride 0) or one per lane."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "idx", "ival", "gx", "gy", "idp", "ivr", "valid", "quad")] + [
        ("pts_stride", ctypes.c_longlong), ("pts_step", ctypes.c_longlong),
        ("quad_stride", ctypes.c_longlong), ("lanes", ctypes.c_int)]


# the lane table's sets: a constraint stage's two directions
SIM3_SETS = 2


class Sim3Params(ctypes.Structure):
    """`sim3_level`'s by-value constants (`LsdSim3Params` in
    csrc/sim3_track.cu)."""

    _fields_ = [
        ("sets", Sim3Set * SIM3_SETS),
        ("n_points", ctypes.c_int), ("quad_rows", ctypes.c_int),
        ("w", ctypes.c_int), ("h", ctypes.c_int),
        ("fx", ctypes.c_float), ("fy", ctypes.c_float),
        ("cx", ctypes.c_float), ("cy", ctypes.c_float),
        ("fx_half", ctypes.c_float), ("fy_half", ctypes.c_float),
        ("u_hi", ctypes.c_float), ("v_hi", ctypes.c_float),
        ("var_weight", ctypes.c_float), ("sigma2", ctypes.c_float),
        ("huber_d", ctypes.c_float), ("min_points", ctypes.c_float),
        ("conv_eps", ctypes.c_float), ("step_min", ctypes.c_float),
        ("lam0", ctypes.c_float), ("success_fac", ctypes.c_float),
        ("fail_fac", ctypes.c_float),
        ("max_its", ctypes.c_int), ("max_trials", ctypes.c_int),
        ("use_esm", ctypes.c_int),
        ("chunk", ctypes.c_int), ("leaves", ctypes.c_int),
        ("staged", ctypes.c_int),
    ]


def make_sim3_params(cam: Camera, cfg: TrackerConfig, sigma2: float,
                     min_points: float, max_its: int, max_trials: int,
                     n_points: int, quad_rows: int,
                     sets: Sequence[Sim3Set] = (), cluster: int = 1
                     ) -> Sim3Params:
    """The constants of one `sim3_level` launch; each float is the f32 the
    plain version's torch op uses for the same Python constant (the
    schedule's from `cfg`, as tracking/sim3_tracker.py `level_plain` reads
    them). `sets`: the lane table's sets in lane order (an absent set has
    no lanes)."""
    h, w = cam.height, cam.width
    chunk, leaves, staged, _ = launch_layout(n_points, cluster, sim3=True)
    if len(sets) > SIM3_SETS:
        raise ValueError(f"sim3_level: {len(sets)} lane sets, at most "
                         f"{SIM3_SETS}")
    return Sim3Params(
        sets=(Sim3Set * SIM3_SETS)(*sets), n_points=n_points,
        quad_rows=quad_rows, w=w, h=h,
        fx=_f32(cam.fx), fy=_f32(cam.fy), cx=_f32(cam.cx), cy=_f32(cam.cy),
        fx_half=_f32(cam.fx * 0.5), fy_half=_f32(cam.fy * 0.5),
        u_hi=_f32(w - 1.001), v_hi=_f32(h - 1.001),
        var_weight=_f32(cfg.var_weight), sigma2=_f32(sigma2),
        huber_d=_f32(cfg.huber_d), min_points=_f32(min_points),
        conv_eps=_f32(cfg.convergence_eps), step_min=_f32(cfg.step_size_min),
        lam0=_f32(cfg.lambda_initial), success_fac=_f32(cfg.lambda_success_fac),
        fail_fac=_f32(cfg.lambda_fail_fac), max_its=int(max_its),
        max_trials=int(max_trials), use_esm=int(bool(cfg.use_esm_sim3)),
        chunk=chunk, leaves=leaves, staged=staged)


_SIM3_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p]


def _sim3_entry():
    fn = _library("sim3_track").lsd_sim3_level
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIM3_ARGTYPES
    return fn


_ACTIVE = {}


def sim3_active_clusters(device: torch.device, cluster: int,
                         smem: int) -> int:
    """How many clusters of `cluster` blocks of `sim3_level`, at `smem`
    bytes of dynamic shared memory a block, the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: it schedules none), asked of the
    card once per device, size and shared memory."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    key = (dev, cluster, smem)
    got = _ACTIVE.get(key)
    if got is None:
        fn = _library("sim3_track").lsd_sim3_active_clusters
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        with torch.cuda.device(dev):
            got = fn(cluster, smem)
        if got < 0:
            raise RuntimeError(f"sim3_level: cudaOccupancyMaxActiveClusters "
                               f"failed (cudaError {-got})")
        _ACTIVE[key] = got
    return got


def sim3_stamp_slots(max_trials: int) -> int:
    """Entries of `sim3_level`'s stamp buffer: 3 for each of the
    1 + max_trials passes and the final pass, and the end."""
    return 3 * (int(max_trials) + 2) + 1


SIM3_POINT_FIELDS = ("idx", "ival", "gx", "gy", "idp", "ivr", "valid")
_SIM3_POINT_DTYPES = (torch.int64,) + (torch.float32,) * 5 + (torch.bool,)


def _sim3_points(points: Sequence[torch.Tensor], lanes: int):
    """The point fields as the kernel reads them: (tensors, lane stride,
    point step, point count), every field (N,) shared or (B, N) per lane,
    in elements; fields that do not share one layout are made
    contiguous."""
    if len(points) != len(SIM3_POINT_FIELDS):
        raise ValueError(f"sim3_level: {len(points)} point fields, expected "
                         f"{SIM3_POINT_FIELDS}")
    for name, dtype, t in zip(SIM3_POINT_FIELDS, _SIM3_POINT_DTYPES, points):
        if t.dtype != dtype:
            raise TypeError(f"sim3_level: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not (t.dim() == 1 or (t.dim() == 2 and t.shape[0] == lanes)):
            raise ValueError(f"sim3_level: {name} of shape "
                             f"{tuple(t.shape)} is neither shared nor one "
                             f"per lane of {lanes}")
        if t.shape != points[0].shape:
            raise ValueError(f"sim3_level: {name} {tuple(t.shape)} does not "
                             f"match idx {tuple(points[0].shape)}")
    fields = list(points)
    if len({t.stride() for t in fields}) != 1 or fields[0].stride(-1) < 1:
        fields = [t.contiguous() for t in fields]
    t = fields[0]
    lane_stride = t.stride(0) if t.dim() == 2 else 0
    return fields, lane_stride, t.stride(-1), t.shape[-1]


def _sim3_quad(quad: torch.Tensor, lanes: int):
    """The quad layout as the kernel reads it: (contiguous tensor, lane
    stride in floats), one (H*W, 20) layout shared or one per lane."""
    if quad.dtype != torch.float32:
        raise TypeError(f"sim3_level: frame_quad must be f32, got "
                        f"{quad.dtype}")
    if quad.dim() not in (2, 3) or quad.shape[-1] != 20 or (
            quad.dim() == 3 and quad.shape[0] != lanes):
        raise ValueError(f"sim3_level: frame_quad of shape "
                         f"{tuple(quad.shape)} is neither one (H*W, 20) "
                         f"layout nor one per lane of {lanes}")
    quad = quad.contiguous()
    if quad.data_ptr() % 16:
        raise ValueError("sim3_level: the quad layout must start on a "
                         "16-byte boundary (the kernel reads rows as float4)")
    return quad, quad[0].numel() if quad.dim() == 3 else 0


def sim3_level(pose, aff_a, aff_b, sets, cam: Camera, cfg: TrackerConfig,
               sigma2: float, min_points: float, max_its: int,
               max_trials: int, final: bool = False, cluster: int = None,
               stamps: torch.Tensor = None):
    """One launch of the Sim(3) level loop for the lanes of `pose` ((B, 8)
    f32 on a CUDA device), the affine pair (B,) f32 or a number. `sets` is
    the lane table, one or two (points, frame_quad, lanes) in the order of
    `pose`'s rows (their lanes add up to B): the point fields
    (SIM3_POINT_FIELDS), each (N,) shared by the set's lanes or (lanes, N),
    strided or not, N the same in every set (the level's compaction
    budget), and the quad layout (H*W, 20) shared or (lanes, H*W, 20).
    `cam` is the level's camera, `cfg` the tracker's constants,
    `min_points` the in-image count below which the level diverges,
    `max_its` / `max_trials` the loop's. Returns (pose, aff_a, aff_b,
    last_err, diverged, trials, its, final) over all B lanes with `final`
    None, or with `final=True` (B, SIM3_FINAL): the final pass's coupled,
    depth and photometric mean residuals, its usage sum and its A (7 x 7,
    symmetric), at the loop's result, run by the same launch after its
    loop (with max_trials = 0: the pass alone, at `pose`). `cluster`
    forces the blocks per lane (a power of two up to the card's
    `max_cluster(..., sim3=True)`) and `stamps` (int64,
    `sim3_stamp_slots(max_trials)` long) takes the first lane's leader
    thread's `clock64()` per pass (see csrc/sim3_track.cu), for
    measurement only."""
    global SIM3_LAUNCHES
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"sim3_level: unsupported device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return sim3_level(pose, aff_a, aff_b, sets, cam, cfg, sigma2,
                              min_points, max_its, max_trials, final,
                              cluster, stamps)
    if pose.dtype != torch.float32 or pose.dim() != 2 or pose.shape[-1] != 8:
        raise ValueError(f"sim3_level: pose must be f32 (B, 8), got "
                         f"{pose.dtype} {tuple(pose.shape)}")
    pose = pose.contiguous()
    lanes = pose.shape[0]
    a_in, b_in = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                  .reshape(-1).expand(lanes).contiguous()
                  for x in (aff_a, aff_b))
    if not 1 <= len(sets) <= SIM3_SETS:
        raise ValueError(f"sim3_level: {len(sets)} lane sets, expected 1 to "
                         f"{SIM3_SETS}")
    if sum(int(n) for _, _, n in sets) != lanes:
        raise ValueError(f"sim3_level: the lane sets hold "
                         f"{[int(n) for _, _, n in sets]} lanes, the pose "
                         f"{lanes}")
    # the table holds raw pointers: `keep` holds the tensors (contiguous
    # copies among them) until the launch is enqueued
    table, keep, shapes = [], [], set()
    for points, frame_quad, n in sets:
        fields, pstride, pstep, n_points = _sim3_points(points, int(n))
        quad, qstride = _sim3_quad(frame_quad, int(n))
        for t in fields + [quad]:
            if t.device != dev:
                raise ValueError(f"sim3_level: a tensor on {t.device}, pose "
                                 f"on {dev}")
        shapes.add((n_points, quad.shape[-2]))
        keep += fields + [quad]
        table.append(Sim3Set(*(t.data_ptr() for t in fields + [quad]),
                             pts_stride=pstride, pts_step=pstep,
                             quad_stride=qstride, lanes=int(n)))
    if len(shapes) != 1:
        raise ValueError(f"sim3_level: the lane sets' (points, quad rows) "
                         f"differ: {sorted(shapes)}; a launch runs one "
                         "level")
    (n_points, quad_rows), = shapes
    if quad_rows * 20 >= 2 ** 31 or cam.width * cam.height >= 2 ** 31:
        raise ValueError("sim3_level: image too large for 32-bit indices")

    most = max_cluster(dev, sim3=True)
    if cluster is None:
        cluster = choose_cluster(
            lanes, n_points,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            most, lambda c: sim3_active_clusters(
                dev, c, launch_layout(n_points, c, sim3=True)[3]))
    elif cluster < 1 or cluster & (cluster - 1) or cluster > most:
        raise ValueError(f"sim3_level: cluster {cluster} is not a power of "
                         f"two up to {most}")
    prm = make_sim3_params(cam, cfg, sigma2, min_points, max_its, max_trials,
                           n_points, quad_rows, table, cluster)
    smem = launch_layout(n_points, cluster, sim3=True)[3]
    out_pose = torch.empty_like(pose)
    out_a = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_a)
    out_err = torch.empty_like(out_a)
    out_div = torch.empty(lanes, dtype=torch.bool, device=dev)
    out_trials = torch.empty(lanes, dtype=torch.int32, device=dev)
    out_its = torch.empty_like(out_trials)
    out_final = (torch.empty(lanes, SIM3_FINAL, dtype=torch.float32,
                             device=dev) if final else None)
    stamp_ptr = 0
    if stamps is not None:
        slots = sim3_stamp_slots(max_trials)
        if (stamps.device != dev or stamps.dtype != torch.int64
                or not stamps.is_contiguous() or stamps.numel() < slots):
            raise ValueError("sim3_level: stamps must be a contiguous int64 "
                             f"tensor on {dev} of {slots} entries or more")
        stamp_ptr = stamps.data_ptr()
    rc = _sim3_entry()(
        pose.data_ptr(), a_in.data_ptr(), b_in.data_ptr(),
        out_pose.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        out_err.data_ptr(), out_div.data_ptr(), out_trials.data_ptr(),
        out_its.data_ptr(), 0 if out_final is None else out_final.data_ptr(),
        stamp_ptr, lanes, cluster, smem, ctypes.byref(prm),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sim3_level kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        SIM3_LAUNCHES += 1
        SIM3_CLUSTER_SIZES[cluster] += 1
    return (out_pose, out_a, out_b, out_err, out_div, out_trials, out_its,
            out_final)
