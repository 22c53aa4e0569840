"""Keyframe container: pyramid + exported depth + tracking reference, with
device-memory minimization.

Port of lsd_slam_tpu/system/keyframe.py (Frame's keyframe role plus
FrameMemory's active-frame LRU, FrameMemory.cpp:129-166): a minimized
keyframe keeps only host (numpy) copies of its level-0 image and depth;
the pyramids and the tracking reference are rebuilt on next access.
`sim3_ref` (the tracking reference with the Sim3 target layouts) is built
lazily for constraint search and dropped by every depth refresh.

Deferred depth (`set_depth(defer=True)`, the pipelined frame loop): the
level-0 pair is stored and the depth pyramid and tracking reference are
built on first access. Several threads read those properties (tracking,
mapping, constraint search), so the build and every depth refresh hold
the keyframe's lock: a reader never sees a half-built pair, and a refresh
never lands in the middle of a build.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from lsd_slam_tpu_torch.utils.stats import NULL_TIMERS


class Keyframe:
    def __init__(self, frame_id: int, timestamp: float, pyr,
                 pose, levels: int = 5, min_use_grad: float = 5.0,
                 device=None):
        """`pyr` None makes a minimized keyframe (a checkpoint's), whose
        host copies the caller fills and which restores onto `device`."""
        self.id = frame_id
        self.timestamp = timestamp
        self.pose = pose
        self.levels = levels
        self.min_use_grad = min_use_grad
        self.device = (pyr.images[0].device if pyr is not None
                       else torch.device(device))

        self._pyr = pyr
        self._depth = None
        self._tracking_ref = None
        self._sim3_ref = None
        self._pending_depth = None  # deferred (idepth0, ivar0, levels)
        self._depth_lock = threading.Lock()
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
        self.tracking_failed: dict = {}
        self.initial_tracked_residual = 1.0
        self.edge_error_sum = 1.0
        self.edges_num = 1

    # ------------------------------------------------------------ access

    @property
    def pyr(self):
        if self._pyr is None:
            self._restore()
        return self._pyr

    @property
    def depth(self):
        if self._pending_depth is not None:
            self._materialize_depth()
        if self._depth is None and self._host_idepth is not None:
            self._restore()
        return self._depth

    @property
    def tracking_ref(self):
        if self._pending_depth is not None:
            self._materialize_depth()
        if self._tracking_ref is None:
            self._restore()
        return self._tracking_ref

    @property
    def sim3_ref(self):
        """tracking_ref with the Sim3 target layouts filled, built lazily
        and cached: only keyframes entering constraint search pay for it."""
        if self._sim3_ref is None:
            from lsd_slam_tpu_torch.tracking import add_sim3_quads
            self._sim3_ref = add_sim3_quads(self.tracking_ref, self.pyr,
                                            self.depth)
        return self._sim3_ref

    @property
    def is_minimized(self) -> bool:
        return self._pyr is None

    # ------------------------------------------------------------ depth

    def set_depth(self, idepth0, ivar0, mean_idepth: float, num_points: int,
                  levels: int, defer: bool = False):
        """== Frame::setDepth + buildIDepthAndIDepthVar. defer=True stores
        the level-0 pair and builds the depth pyramid / tracking reference
        on first access: the pipelined loop refreshes depth every frame but
        chains the tracking reference on the device, so only keyframe
        switches and constraint search read these products."""
        with self._depth_lock:
            self._host_idepth = None
            self._host_ivar = None
            self._sim3_ref = None
            self.mean_idepth = float(mean_idepth)
            self.num_points = int(num_points)
            if defer:
                self._pending_depth = (idepth0, ivar0, levels)
                self._depth = None
                self._tracking_ref = None
                return
            self._pending_depth = None
            self._build_depth(idepth0, ivar0, levels)

    def _build_depth(self, idepth0, ivar0, levels):
        from lsd_slam_tpu_torch.frames import build_depth_pyramid
        from lsd_slam_tpu_torch.tracking import make_tracking_ref

        depth = build_depth_pyramid(idepth0, ivar0, levels)
        ref = make_tracking_ref(self.pyr, depth, min_level=1,
                                with_sim3=False)
        self._depth, self._tracking_ref = depth, ref

    def _materialize_depth(self):
        """Build the deferred pair once; a reader that finds another one
        building waits for it, then finds nothing left to do."""
        with self._depth_lock:
            pending = self._pending_depth
            if pending is None:
                return
            self._build_depth(*pending)
            self._pending_depth = None

    # ------------------------------------------------------------ memory

    def minimize(self):
        """Drop device pyramids; keep host copies (Frame::minimizeInMemory)."""
        if self._pyr is None:
            return
        self._host_image = self._pyr.images[0].cpu().numpy()
        if self._pending_depth is not None:
            idepth0, ivar0, _ = self._pending_depth
            self._host_idepth = idepth0.cpu().numpy()
            self._host_ivar = ivar0.cpu().numpy()
            self._pending_depth = None
        elif self._depth is not None and self._host_idepth is None:
            self._host_idepth = self._depth.idepth[0].cpu().numpy()
            self._host_ivar = self._depth.ivar[0].cpu().numpy()
        if self.reactivation is not None:
            self.reactivation = tuple(a.cpu().numpy() if torch.is_tensor(a)
                                      else a for a in self.reactivation)
        self._pyr = None
        self._depth = None
        self._tracking_ref = None
        self._sim3_ref = None

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
            self._tracking_ref = make_tracking_ref(
                self._pyr, self._depth, min_level=1, with_sim3=False)

    def cam_to_world(self) -> np.ndarray:
        return self.pose.cam_to_world()


class KeyframeMemory:
    """Active-keyframe LRU (== FrameMemory::pruneActiveFrames,
    FrameMemory.cpp:129-166): keyframes beyond the active budget get
    minimized; access through the Keyframe properties restores them."""

    def __init__(self, max_active: int = 30, timers=None):
        self.max_active = max_active
        self._counter = 0
        # the engine's StageTimers: a minimization's pulls are spans
        self.timers = timers if timers is not None else NULL_TIMERS

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
            with self.timers.span("pull.minimize"):
                kf.minimize()
            n += 1
        return n
