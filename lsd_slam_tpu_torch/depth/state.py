"""Per-keyframe depth-hypothesis state as a dataclass of (H, W) tensors.

Port of lsd_slam_tpu/depth/state.py: the SoA replacement of the reference's
DepthMapPixelHypothesis grid (DepthMapPixelHypothesis.h:41-60), with the
same field names and dtypes (bool / f32 / int32).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class DepthMapState:
    valid: torch.Tensor            # bool  — isValid
    idepth: torch.Tensor           # f32   — raw filtered inverse depth
    var: torch.Tensor              # f32   — idepth variance
    idepth_smoothed: torch.Tensor  # f32   — regularized (-1 until regularized)
    var_smoothed: torch.Tensor     # f32
    validity: torch.Tensor         # f32   — validity_counter
    blacklisted: torch.Tensor      # i32   — starts 0, decremented on failures
    next_min_id: torch.Tensor      # f32   — nextStereoFrameMinID

    def replace(self, **kw) -> "DepthMapState":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(h: int, w: int, device=None) -> "DepthMapState":
        f32 = dict(dtype=torch.float32, device=device)
        return DepthMapState(
            valid=torch.zeros((h, w), dtype=torch.bool, device=device),
            idepth=torch.zeros((h, w), **f32),
            var=torch.zeros((h, w), **f32),
            idepth_smoothed=torch.full((h, w), -1.0, **f32),
            var_smoothed=torch.full((h, w), -1.0, **f32),
            validity=torch.zeros((h, w), **f32),
            blacklisted=torch.zeros((h, w), dtype=torch.int32, device=device),
            next_min_id=torch.zeros((h, w), **f32),
        )
