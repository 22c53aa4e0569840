"""An undistorted pinhole camera (the TUM RGB-D benchmark publishes its
images so): the generator renders the pinhole image itself, the program
takes the camera as it is, and there is nothing to undistort."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Pinhole(NamedTuple):
    """Intrinsics in pixels, pixel centres at whole numbers (OpenCV's and
    the TUM benchmark's convention), and the image size."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Setup:
    """A configuration's camera: `raw` is the size the generator renders,
    `pinhole` the camera of the images the program tracks, `dirs_cam` the
    raw image's ray directions (None: the pinhole's own)."""

    undistorts = False

    def __init__(self, cam: dict):
        self.pinhole = Pinhole(float(cam["fx"]), float(cam["fy"]),
                               float(cam["cx"]), float(cam["cy"]),
                               int(cam["width"]), int(cam["height"]))
        self.raw = (self.pinhole.width, self.pinhole.height)

    def dirs_cam(self, device) -> Optional[object]:
        return None

    def program(self, device):
        """(the program's Camera, its undistorter or None)."""
        from lsd_slam_tpu_torch.camera import Camera
        p = self.pinhole
        return Camera(p.fx, p.fy, p.cx, p.cy, p.width, p.height), None

    def reference_undistort(self, raw: np.ndarray):
        raise NotImplementedError("a pinhole camera undistorts nothing")
