"""Dataset input: image folders (+ undistortion).

Port of lsd_slam_tpu/io/dataset.py (== the input side of
main_on_images.cpp: file list + undistort + feed, and InputImageStream).
Images decode through `utils.image_io` (PNG and PGM/PPM without Pillow);
undistortion is the device gather of `lsd_slam_tpu_torch.camera`.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from lsd_slam_tpu_torch.camera import Undistorter, undistorter_for_file
from lsd_slam_tpu_torch.utils import image_io

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".bmp", ".tif"}


class ImageFolderSource:
    """Sorted image files from a directory, grayscale, undistorted.

    == main_on_images.cpp:222-268 (getdir + imread + undistort). With an
    undistorter, `read` returns the undistorted image as a float32 tensor
    on the undistorter's device, which `SlamSystem.track_frame` takes as
    it is (the JAX package pulls it back to the host and the engine
    uploads it again; the values are the same). Without one it returns
    the host float32 array. Iteration decodes `read_ahead` files at a
    time (`image_io.read_gray_many`: PNGs of one size undo their row
    filters in one pass, which costs less per image than one pass each)
    and undistorts each frame as it is handed out."""

    read_ahead = 8

    def __init__(self, image_dir: str, calib_file: Optional[str] = None,
                 undistorter: Optional[Undistorter] = None, device=None):
        self.image_dir = image_dir
        self.files: List[str] = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if os.path.splitext(f)[1].lower() in _IMAGE_EXTS)
        if undistorter is None and calib_file is not None:
            undistorter = undistorter_for_file(calib_file, device=device)
        self.undistorter = undistorter
        self.camera = undistorter.camera if undistorter else None

    def __len__(self) -> int:
        return len(self.files)

    def read(self, idx: int):
        return self._prepare(image_io.read_gray(self.files[idx]))

    def _prepare(self, gray: np.ndarray):
        arr = gray.astype(np.float32)
        if self.undistorter is not None:
            return self.undistorter(arr)
        return arr

    def _timestamp(self, i: int) -> float:
        # timestamps from filename if numeric, else index/30s
        stem = os.path.splitext(os.path.basename(self.files[i]))[0]
        try:
            return float(stem)
        except ValueError:
            return i / 30.0

    def __iter__(self) -> Iterator[Tuple[int, float, object]]:
        for start in range(0, len(self.files), self.read_ahead):
            grays = image_io.read_gray_many(
                self.files[start:start + self.read_ahead])
            for i, gray in enumerate(grays, start):
                yield i, self._timestamp(i), self._prepare(gray)
