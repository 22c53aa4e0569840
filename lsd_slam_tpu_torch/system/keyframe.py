"""Keyframe container: pyramid + exported depth + tracking reference, with
device-memory minimization.

Port of lsd_slam_tpu/system/keyframe.py (Frame's keyframe role plus
FrameMemory's active-frame LRU, FrameMemory.cpp:129-166): a minimized
keyframe keeps only host (numpy) copies of its level-0 image and depth;
the pyramids and the tracking reference are rebuilt on next access. The
Sim3 reference layouts (`sim3_ref`) belong to the SLAM back-end and are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Keyframe:
    def __init__(self, frame_id: int, timestamp: float, pyr,
                 pose, levels: int = 5, min_use_grad: float = 5.0):
        self.id = frame_id
        self.timestamp = timestamp
        self.pose = pose
        self.levels = levels
        self.min_use_grad = min_use_grad
        self.device = pyr.images[0].device

        self._pyr = pyr
        self._depth = None
        self._tracking_ref = None
        # host copies (authoritative once minimized)
        self._host_image: Optional[np.ndarray] = None
        self._host_idepth: Optional[np.ndarray] = None
        self._host_ivar: Optional[np.ndarray] = None

        self.mean_idepth: float = 1.0
        self.num_points: int = 0
        self.num_frames_tracked_on_this = 0
        self.num_mapped_on_this = 0
        self.num_mapped_on_this_total = 0
        self.idx_in_keyframes = -1
        self.last_use_counter = 0

        self.reactivation: Optional[tuple] = None
        self.initial_tracked_residual = 1.0

    # ------------------------------------------------------------ access

    @property
    def pyr(self):
        if self._pyr is None:
            self._restore()
        return self._pyr

    @property
    def depth(self):
        if self._depth is None and self._host_idepth is not None:
            self._restore()
        return self._depth

    @property
    def tracking_ref(self):
        if self._tracking_ref is None:
            self._restore()
        return self._tracking_ref

    @property
    def is_minimized(self) -> bool:
        return self._pyr is None

    # ------------------------------------------------------------ depth

    def set_depth(self, idepth0, ivar0, mean_idepth: float, num_points: int,
                  levels: int):
        """== Frame::setDepth + buildIDepthAndIDepthVar."""
        self._host_idepth = None
        self._host_ivar = None
        self.mean_idepth = float(mean_idepth)
        self.num_points = int(num_points)
        self._build_depth(idepth0, ivar0, levels)

    def _build_depth(self, idepth0, ivar0, levels):
        from lsd_slam_tpu_torch.frames import build_depth_pyramid
        from lsd_slam_tpu_torch.tracking import make_tracking_ref

        self._depth = build_depth_pyramid(idepth0, ivar0, levels)
        self._tracking_ref = make_tracking_ref(self.pyr, self._depth,
                                               min_level=1)

    # ------------------------------------------------------------ memory

    def minimize(self):
        """Drop device pyramids; keep host copies (Frame::minimizeInMemory)."""
        if self._pyr is None:
            return
        self._host_image = self._pyr.images[0].cpu().numpy()
        if self._depth is not None and self._host_idepth is None:
            self._host_idepth = self._depth.idepth[0].cpu().numpy()
            self._host_ivar = self._depth.ivar[0].cpu().numpy()
        if self.reactivation is not None:
            self.reactivation = tuple(a.cpu().numpy() if torch.is_tensor(a)
                                      else a for a in self.reactivation)
        self._pyr = None
        self._depth = None
        self._tracking_ref = None

    def _restore(self):
        """Rebuild pyramids from host copies (== Frame::require/build*)."""
        from lsd_slam_tpu_torch.frames import build_frame, build_depth_pyramid
        from lsd_slam_tpu_torch.tracking import make_tracking_ref

        if self._pyr is None:
            if self._host_image is None:
                raise RuntimeError(f"keyframe {self.id} has no image data")
            self._pyr = build_frame(
                torch.as_tensor(self._host_image, device=self.device),
                self.levels, self.min_use_grad)
        if self._depth is None and self._host_idepth is not None:
            self._depth = build_depth_pyramid(
                torch.as_tensor(self._host_idepth, device=self.device),
                torch.as_tensor(self._host_ivar, device=self.device),
                self.levels)
            self._tracking_ref = make_tracking_ref(self._pyr, self._depth,
                                                   min_level=1)

    def cam_to_world(self) -> np.ndarray:
        return self.pose.cam_to_world()


class KeyframeMemory:
    """Active-keyframe LRU (== FrameMemory::pruneActiveFrames,
    FrameMemory.cpp:129-166): keyframes beyond the active budget get
    minimized; access through the Keyframe properties restores them."""

    def __init__(self, max_active: int = 30):
        self.max_active = max_active
        self._counter = 0

    def touch(self, kf: Keyframe):
        self._counter += 1
        kf.last_use_counter = self._counter

    def prune(self, keyframes, current_kf: Optional[Keyframe]):
        active = [kf for kf in keyframes
                  if not kf.is_minimized and kf is not current_kf]
        if len(active) <= self.max_active:
            return 0
        active.sort(key=lambda kf: kf.last_use_counter)
        n = 0
        for kf in active[:len(active) - self.max_active]:
            kf.minimize()
            n += 1
        return n
