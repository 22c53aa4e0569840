"""Live SLAM wrapper: camera stream -> engine, with reset & pose logging.

Port of lsd_slam_tpu/io/live.py (== LiveSLAMWrapper,
src/LiveSLAMWrapper.{h,cpp}, + main_live_odometry): an input thread pushes
timestamped frames into a bounded NotifyQueue(8) (== ROSImageStreamThread's
buffer, ROSImageStreamThread.cpp:63-98); `loop` drains it, grayscale
floats go to random_init/track_frame, a full reset recreates the
SlamSystem (fullResetRequested, LiveSLAMWrapper.cpp:169-187), and every
pose is logged in TUM format (logCameraPose, LiveSLAMWrapper.cpp:141-161).
The engine runs on `device` (the CUDA device unless the caller names
one).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.utils.native import NotifyQueue


class LiveSLAMWrapper:
    def __init__(self, cam: Camera, cfg: LSDConfig = None,
                 enable_slam: bool = True, output=None,
                 queue_capacity: int = 8, device=None):
        from lsd_slam_tpu_torch.system import SlamSystem

        self.cam = cam
        self.cfg = cfg or LSDConfig(width=cam.width, height=cam.height)
        self.enable_slam = enable_slam
        self.output = output
        self.queue = NotifyQueue(queue_capacity)
        self.system = SlamSystem(cam, self.cfg, enable_slam, device=device)
        self.device = self.system.device
        self._running = False
        self._initialized = False
        self.full_reset_requested = False
        self._frame_count = 0

    # ------------------------------------------------------------ producer

    def push_image(self, image: np.ndarray, timestamp: float) -> bool:
        """Called by the capture thread; drops when the engine lags
        (NotifyBuffer drop-on-full semantics)."""
        return self.queue.push((np.asarray(image, np.float32), timestamp))

    def request_reset(self):
        """== fullResetRequested (hotkey 'r', settings.cpp:124-127)."""
        self.full_reset_requested = True

    # ------------------------------------------------------------ consumer

    def loop(self, stop_condition: Optional[Callable[[], bool]] = None):
        """Drain the queue until stopped (== LiveSLAMWrapper::Loop,
        LiveSLAMWrapper.cpp:84-139)."""
        self._running = True
        while self._running:
            if stop_condition is not None and stop_condition():
                break
            item = self.queue.pop(0.1)
            if item is None:
                continue
            self.process_frame(*item)

    def process_frame(self, image: np.ndarray, timestamp: float):
        if self.full_reset_requested:
            self._reset_all()
        fid = self._frame_count
        self._frame_count += 1
        if not self._initialized:
            self.system.random_init(image, fid, timestamp)
            self._initialized = True
            return
        pose = self.system.track_frame(image, fid, timestamp)
        if pose is not None and self.output is not None:
            self.output.publish_tracked_frame(fid, timestamp, pose)

    def _reset_all(self):
        """Destroy & recreate the engine (LiveSLAMWrapper.cpp:169-187)."""
        from lsd_slam_tpu_torch.system import SlamSystem

        self.system.finalize()
        self.system = SlamSystem(self.cam, self.cfg, self.enable_slam,
                                 device=self.device)
        self._initialized = False
        self.full_reset_requested = False

    def stop(self):
        self._running = False

    def save_trajectory(self, path: str):
        from lsd_slam_tpu_torch.io.trajectory import save_tum_trajectory

        save_tum_trajectory(path, self.system.trajectory)
