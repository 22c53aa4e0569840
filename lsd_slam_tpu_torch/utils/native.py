"""Host helpers: the bounded notify-queue, binary PLY, the CPU remap.

Copies of the pure-Python / numpy branches of lsd_slam_tpu/utils/native.py:
`NotifyQueue` (== NotifyBuffer<T>, IOWrapper/NotifyBuffer.h),
`write_ply_binary` (:161-181) and `remap_bilinear_cpu` (:184-203). The
JAX package can also back them by its native host library; the port loads
no native library.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


class NotifyQueue:
    """Bounded drop-on-full queue of Python objects with a blocking pop."""

    def __init__(self, capacity: int = 8):
        self._capacity = capacity
        self._dq = deque()
        self._cv = threading.Condition()
        self._dropped = 0

    def push(self, item) -> bool:
        """Queue `item`; False (and one more `dropped`) when full."""
        with self._cv:
            if len(self._dq) >= self._capacity:
                self._dropped += 1
                return False
            self._dq.append(item)
            self._cv.notify()
            return True

    def pop(self, timeout: float = 1.0):
        """The oldest item, waiting up to `timeout` s for one; else None."""
        with self._cv:
            if not self._dq:
                self._cv.wait(timeout)
            if self._dq:
                return self._dq.popleft()
            return None

    def size(self) -> int:
        with self._cv:
            return len(self._dq)

    @property
    def dropped(self) -> int:
        return self._dropped


def write_ply_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY: float32 x, y, z and uchar r, g, b per
    vertex."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(xyz)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n").encode())
        rec = np.zeros(len(xyz), dtype=[("xyz", np.float32, 3),
                                        ("rgb", np.uint8, 3)])
        rec["xyz"] = xyz
        rec["rgb"] = rgb
        f.write(rec.tobytes())


def remap_bilinear_cpu(img: np.ndarray, rx: np.ndarray,
                       ry: np.ndarray) -> np.ndarray:
    """CPU undistortion remap (negative map coordinates -> 0). Its border
    rule clips x0 to w-2 and y0 to h-2, unlike the undistorter's device
    remap (camera/undistort.py), which clips x0+1 and y0+1."""
    img = np.ascontiguousarray(img, np.float32)
    rx = np.ascontiguousarray(rx, np.float32)
    ry = np.ascontiguousarray(ry, np.float32)
    h, w = img.shape
    x0 = np.clip(np.floor(rx).astype(np.int32), 0, w - 2)
    y0 = np.clip(np.floor(ry).astype(np.int32), 0, h - 2)
    wx = rx - x0
    wy = ry - y0
    v = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x0 + 1] * wx * (1 - wy)
         + img[y0 + 1, x0] * (1 - wx) * wy + img[y0 + 1, x0 + 1] * wx * wy)
    return np.where((rx < 0) | (ry < 0), 0.0, v).astype(np.float32)
