"""The trackers' LM level loop on the card: the CUDA kernel's wrapper.

Replaces the XLA `lax.while_loop` programs `_track_level`
(lsd_slam_tpu/tracking/se3_tracker.py:184-253) and `_quick_impl`'s loop
(lsd_slam_tpu/tracking/quick_tracker.py:66-104). The kernel is
`csrc/lm_track.cu` (see its header for the design and the bound): one
thread block per lane runs every trial of the level, so a track pulls
nothing to the host. Its plain version is `tracking/lm.py` `level_plain`;
`tracking.lm.level` sends CPU tensors there and CUDA tensors here, and
this wrapper launches the kernel or raises: it never falls back.

The wrapper takes tensors and scalars only (the point fields, the
schedule's constants as a mapping) and returns tensors; `tracking.lm`
builds its `LevelResult` from them, so this layer knows nothing of the
trackers.

`LAUNCHES` counts kernel launches; the engine's worker threads launch
too, so it is bumped under a lock.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig

# number of kernel launches (reset it to count a run)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


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
    ]


def _f32(x) -> float:
    """A Python number rounded to f32 as torch rounds a scalar operand."""
    return float(np.float32(x))


def make_params(cam: Camera, cfg: TrackerConfig, sigma2: float,
                schedule: Mapping, n_points: int, quad_rows: int,
                pts_stride: int, quad_stride: int) -> Params:
    """The constants of one launch; each float is the f32 the plain
    version's torch op uses for the same Python constant. `schedule` holds
    the loop's constants (the fields of tracking/lm.py `Schedule`)."""
    h, w = cam.height, cam.width
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
        use_affine=int(sched["use_affine"]))


_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p]


def _entry():
    from lsd_slam_tpu_torch.ops.build import load
    fn = load("lm_track").lsd_lm_level
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


POINT_FIELDS = ("idx", "ival", "idp", "ivr", "valid")
_POINT_DTYPES = (torch.int64, torch.float32, torch.float32, torch.float32,
                 torch.bool)


def lm_level(pose, aff_a, aff_b, points: Sequence[torch.Tensor], frame_quad,
             cam: Camera, cfg: TrackerConfig, sigma2: float,
             schedule: Mapping):
    """One launch of the level loop for the lanes of `pose` ((7,) or
    (B, 7) f32 on a CUDA device). The affine pair is a tensor of the
    pose's lane shape or a Python float; `points` the point fields
    (POINT_FIELDS), each (N,) shared or (B, N); the quad layout (H*W, 12)
    shared or (B, H*W, 12); `schedule` the loop's constants (see
    `make_params`). Returns (pose, aff_a, aff_b, last_err, diverged,
    trials, its), tensors of the pose's lane shape."""
    global LAUNCHES
    dev = pose.device
    if dev.type != "cuda":
        raise ValueError(f"lm_level: unsupported device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return lm_level(pose, aff_a, aff_b, points, frame_quad, cam, cfg,
                            sigma2, schedule)
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

    prm = make_params(cam, cfg, sigma2, schedule, idx.shape[-1], quad_rows,
                      pstride, qstride)
    out_pose = torch.empty_like(pose2)
    out_a = torch.empty(lanes, dtype=torch.float32, device=dev)
    out_b = torch.empty_like(out_a)
    out_err = torch.empty_like(out_a)
    out_div = torch.empty(lanes, dtype=torch.bool, device=dev)
    out_trials = torch.empty(lanes, dtype=torch.int32, device=dev)
    out_its = torch.empty_like(out_trials)
    rc = _entry()(*(t.data_ptr() for t in fields), quad.data_ptr(),
                  pose2.data_ptr(), a_in.data_ptr(), b_in.data_ptr(),
                  out_pose.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
                  out_err.data_ptr(), out_div.data_ptr(),
                  out_trials.data_ptr(), out_its.data_ptr(), lanes,
                  ctypes.byref(prm), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lm_level kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return (out_pose.reshape(pose.shape), out_a.reshape(lead),
            out_b.reshape(lead), out_err.reshape(lead), out_div.reshape(lead),
            out_trials.reshape(lead), out_its.reshape(lead))
