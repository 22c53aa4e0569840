"""Pinhole camera model with the reference's pyramid-level convention.

A copy of lsd_slam_tpu/camera/model.py (the port never imports the JAX
package).

Per-level intrinsics follow Frame.cpp:445-459:
    fx_l = fx_{l-1} / 2,   cx_l = (cx_0 + 0.5) / 2^l - 0.5
(the +0.5/-0.5 keeps pixel centers aligned across the 2x2 box downsample).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Camera:
    """Level-0 intrinsics + image size. Frozen/hashable: safe as a static
    jit argument, so fx/fy/cx/cy are compile-time constants in kernels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def level(self, l: int) -> "Camera":
        if l == 0:
            return self
        f = float(1 << l)
        return Camera(
            fx=self.fx / f,
            fy=self.fy / f,
            cx=(self.cx + 0.5) / f - 0.5,
            cy=(self.cy + 0.5) / f - 0.5,
            width=self.width >> l,
            height=self.height >> l,
        )

    @property
    def fxi(self) -> float:
        return 1.0 / self.fx

    @property
    def fyi(self) -> float:
        return 1.0 / self.fy

    @property
    def cxi(self) -> float:
        return -self.cx / self.fx

    @property
    def cyi(self) -> float:
        return -self.cy / self.fy

    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], dtype=np.float64
        )
