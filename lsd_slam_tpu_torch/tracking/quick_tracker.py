"""Coarse-level "permaRef" quick tracking for keyframe search and
relocalisation (torch).

Port of lsd_slam_tpu/tracking/quick_tracker.py (SE3Tracker::
trackFrameOnPermaref / checkPermaRefOverlap, SE3Tracker.cpp:121-272): a
single-level LM track with the quick test-track schedule
(maxItsTestTrack=5, eps 0.98, settings.h:379-382) on the level whose width
is closest to the reference's 40 px operating point. It reuses the SE(3)
tracker's residual, weights and normal equations.

The JAX package runs the LM as a device `while_loop`, vmapped for the
batched entries (N refs against one frame, one ref against N frames). Here
every entry is the batched loop `lm.level` with the quick schedule: on the
card one launch of the kernel `lm_level` with a block per lane (point sets
or quad layouts shared across lanes are read in place), pulling nothing
until the caller reads the (B, 11) pack; on the CPU the plain loop, whose
"any lane active" check per trial is counted in
`QuickTrackResult.n_syncs`. A single track is a batch of one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.tracking import lm
from lsd_slam_tpu_torch.tracking.reference import PointSet
from lsd_slam_tpu_torch.tracking.se3_tracker import (
    _residual_pass, _weights_pass)


@dataclass
class QuickTrackResult:
    ref_to_frame: torch.Tensor   # SE3 (..., 7)
    tracking_good: torch.Tensor
    diverged: torch.Tensor
    point_usage: torch.Tensor
    good_count: torch.Tensor
    bad_count: torch.Tensor
    residual: torch.Tensor
    n_syncs: int = 0

    def lane(self, i: int) -> "QuickTrackResult":
        return QuickTrackResult(
            self.ref_to_frame[i], self.tracking_good[i], self.diverged[i],
            self.point_usage[i], self.good_count[i], self.bad_count[i],
            self.residual[i], self.n_syncs)


POINT_FIELDS = ("idx", "ival", "gx", "gy", "idp", "ivr", "valid", "n_valid")


def stack_points(pts_list) -> PointSet:
    """Stack level-l PointSets of equal budget into one with (B, N) fields
    (n_valid (B,))."""
    return PointSet(*(torch.stack([getattr(p, f) for p in pts_list])
                      for f in POINT_FIELDS))


def zeros_like_points(p: PointSet) -> PointSet:
    return PointSet(*(torch.zeros_like(getattr(p, f)) for f in POINT_FIELDS))


def slice_points(p: PointSet, start: int, stop: int) -> PointSet:
    """Lanes [start, stop) of stacked PointSets."""
    return PointSet(*(getattr(p, f)[start:stop] for f in POINT_FIELDS))


def points_to(p: PointSet, device) -> PointSet:
    return PointSet(*(getattr(p, f).to(device) for f in POINT_FIELDS))


def _overlap_impl(cam, cfg, level, pts, frame_quad, pose):
    _, stats = _residual_pass(pose, 1.0, 0.0, pts, frame_quad,
                              cam.level(level), cfg)
    return stats["usage"] / torch.clamp_min(pts.n_valid, 1.0)


def _quick_impl(cam: Camera, cfg: TrackerConfig, sigma2: float, level: int,
                ref_pts: PointSet, frame_quad, init_ref_to_frame):
    """The batched quick track. init_ref_to_frame (B, 7); ref_pts fields
    (N,) shared or (B, N); frame_quad (H*W, 12) shared or (B, H*W, 12)."""
    caml = cam.level(level)
    h, w = caml.height, caml.width

    def res(pose):
        return _residual_pass(pose, 1.0, 0.0, ref_pts, frame_quad, caml, cfg)

    out = lm.level(init_ref_to_frame, 1.0, 0.0, ref_pts, frame_quad, caml,
                   cfg, sigma2, lm.quick_schedule(cfg))
    pose, diverged = out.pose, out.diverged
    buffers, stats = res(pose)
    _, final_err = _weights_pass(pose, buffers, cfg, sigma2)
    good = stats["good_count"].to(torch.float32)
    bad = stats["bad_count"].to(torch.float32)
    n_pix = float(h * w)
    ref_num = torch.clamp_min(ref_pts.n_valid, 1.0)
    tracking_good = (~diverged
                     & (good / n_pix > cfg.min_goodperall_pixel)
                     & (good / torch.clamp_min(good + bad, 1.0)
                        > cfg.min_goodpergoodbad_pixel))
    return QuickTrackResult(
        ref_to_frame=pose, tracking_good=tracking_good, diverged=diverged,
        point_usage=stats["usage"] / ref_num,
        good_count=stats["good_count"], bad_count=stats["bad_count"],
        residual=final_err, n_syncs=out.n_syncs)


def pack_result(res: QuickTrackResult) -> torch.Tensor:
    """The (B, 11) pack [ref_to_frame (7), good, usage, good_count,
    bad_count] the keyframe graph pulls once per batch."""
    f32 = torch.float32
    return torch.cat([res.ref_to_frame, res.tracking_good.to(f32)[:, None],
                      res.point_usage[:, None],
                      res.good_count.to(f32)[:, None],
                      res.bad_count.to(f32)[:, None]], dim=1)


class QuickTracker:
    def __init__(self, cam: Camera, cfg: TrackerConfig = TrackerConfig(),
                 sigma2: float = 16.0):
        self.cam = cam
        self.cfg = cfg
        self.sigma2 = float(sigma2)
        # resolution-adaptive level: the one whose width is closest to the
        # reference's 40 px operating point (QUICK_KF_CHECK_LVL=4 at
        # 640x480), floored at 1, the finest level keyframe refs compact
        lvl = int(round(math.log2(max(cam.width, 40) / 40.0)))
        self.level = max(1, min(cfg.quick_kf_check_level, lvl))

    def _run(self, pts, quad, inits) -> QuickTrackResult:
        inits = torch.as_tensor(inits, dtype=torch.float32,
                                device=quad.device)
        return _quick_impl(self.cam, self.cfg, self.sigma2, self.level, pts,
                           quad, inits)

    def track(self, ref, frame_pyr, init_ref_to_frame) -> QuickTrackResult:
        """== trackFrameOnPermaref; init/result are ref->frame SE3."""
        return self.track_pts(ref.pts[self.level], frame_pyr.quad[self.level],
                              init_ref_to_frame)

    def track_pts(self, ref_pts, frame_quad, init_ref_to_frame
                  ) -> QuickTrackResult:
        """trackFrameOnPermaref on a raw level-l PointSet + quad layout."""
        init = torch.as_tensor(init_ref_to_frame, dtype=torch.float32,
                               device=frame_quad.device).reshape(1, 7)
        return self._run(ref_pts, frame_quad, init).lane(0)

    def check_overlap(self, ref, frame_pyr, ref_to_frame):
        """== checkPermaRefOverlap: pointUsage at a fixed pose
        (SE3Tracker.cpp:121-158)."""
        return self.check_overlap_pts(ref.pts[self.level],
                                      frame_pyr.quad[self.level],
                                      ref_to_frame)

    def check_overlap_pts(self, pts, frame_quad, ref_to_frame) -> float:
        return float(self.overlap_pts(pts, frame_quad, ref_to_frame))

    def overlap_pts(self, pts, frame_quad, ref_to_frame) -> torch.Tensor:
        """`check_overlap_pts` left on the device (an f32 scalar)."""
        pose = torch.as_tensor(ref_to_frame, dtype=torch.float32,
                               device=frame_quad.device)
        return _overlap_impl(self.cam, self.cfg, self.level, pts, frame_quad,
                             pose)

    def track_batch_pts(self, refs_stacked, frame_quad, init_poses
                        ) -> QuickTrackResult:
        """One frame quad layout against N stacked keyframe point sets."""
        return self._run(refs_stacked, frame_quad, init_poses)

    def track_batch_frames(self, ref_pts, frames_quads, init_poses
                           ) -> QuickTrackResult:
        """ONE reference point set against N stacked frame quad layouts."""
        return self._run(ref_pts, frames_quads, init_poses)
