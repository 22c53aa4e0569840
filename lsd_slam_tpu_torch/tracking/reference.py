"""Per-keyframe tracking reference: compacted semi-dense point sets.

Port of lsd_slam_tpu/tracking/reference.py (TrackingReference.cpp:96-147):
valid semi-dense pixels of each level are compacted into a fixed-budget
buffer with a validity mask. Pixels are visited in a golden-stride order
before the cumsum compaction so that truncation above the budget
subsamples the image evenly. The compaction is cumsum + scatter with
static shapes — `torch.nonzero` would sync to the host on the card — and
gives the same slot order as the JAX version.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from lsd_slam_tpu_torch.frames.pyramid import FramePyramid, DepthPyramid

# Fraction of the level grid kept as the point budget, per pyramid level.
DEFAULT_BUDGET_FRAC = (0.35, 0.5, 0.65, 1.0, 1.0, 1.0, 1.0, 1.0)


@dataclass
class PointSet:
    """Compacted semi-dense points of one pyramid level (all (N,) tensors).

    idx is the flat pixel index y*W + x (int64); padding slots have
    valid=False and idx 0."""

    idx: torch.Tensor
    ival: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    idp: torch.Tensor
    ivr: torch.Tensor
    valid: torch.Tensor
    n_valid: torch.Tensor  # scalar f32: number of real (non-padding) points


@dataclass
class TrackingRef:
    """Per-level reference data for direct alignment. pts[l] is None below
    the min level; sim3_quad holds None at every level (the Sim3 target
    layouts belong to the SLAM back-end, not yet ported)."""

    pts: Tuple[PointSet, ...]
    sim3_quad: Tuple[torch.Tensor, ...]


@functools.lru_cache(maxsize=None)
def _golden_perm(m: int) -> np.ndarray:
    """Deterministic spatially-uniform visiting order of m flat indices."""
    s = int(round(m * 0.6180339887))
    s = max(s, 1)
    while np.gcd(s, m) != 1:
        s += 1
    return ((np.arange(m, dtype=np.int64) * s) % m).astype(np.int32)


def level_budget(h: int, w: int, level: int,
                 frac: Tuple[float, ...] = DEFAULT_BUDGET_FRAC) -> int:
    m = h * w
    f = frac[level] if level < len(frac) else 1.0
    if f >= 1.0:
        return m
    return min(m, max(256, ((int(m * f) + 255) // 256) * 256))


def compact_points(valid: torch.Tensor, fields: torch.Tensor,
                   budget: int) -> Tuple[torch.Tensor, ...]:
    """Compact flat `fields` (M, C) rows where `valid` (H, W) into a
    (budget, C) buffer. Returns (idx, vals, slot_valid, n_valid)."""
    h, w = valid.shape
    m = h * w
    dev = valid.device
    vflat = valid.reshape(-1)
    if budget >= m:
        slot = torch.arange(m, dtype=torch.int64, device=dev)
        return slot, fields, vflat, torch.sum(vflat.to(torch.float32))
    perm = torch.as_tensor(_golden_perm(m), device=dev).to(torch.int64)
    vp = vflat[perm]
    pos = torch.cumsum(vp.to(torch.int64), 0) - 1
    # invalid or over budget -> dump slot `budget`, sliced off (the JAX
    # version drops these out-of-bounds scatters)
    dest = torch.where(vp & (pos < budget), pos, budget)
    buf = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    buf.scatter_(0, dest, perm)
    idx = buf[:budget]
    n_valid = torch.clamp(torch.sum(vp.to(torch.int64)), max=budget)
    slot_valid = torch.arange(budget, device=dev) < n_valid
    vals = fields[idx]
    return idx, vals, slot_valid, n_valid.to(torch.float32)


def make_tracking_ref(pyr: FramePyramid, depth: DepthPyramid,
                      budget_frac: Tuple[float, ...] = DEFAULT_BUDGET_FRAC,
                      min_level: int = 0) -> TrackingRef:
    """Per-level compaction of the pixels with ivar > 0 & idepth != 0 on
    the 1-px interior (TrackingReference.cpp:127-135); levels below
    `min_level` hold None (the JAX `with_sim3=False` layout)."""
    pts = []
    for lvl in range(len(pyr.images)):
        if lvl < min_level:
            pts.append(None)
            continue
        iv = depth.ivar[lvl]
        idp = depth.idepth[lvl]
        img = pyr.images[lvl]
        h, w = img.shape
        interior = torch.zeros_like(iv, dtype=torch.bool)
        interior[1:-1, 1:-1] = True
        valid = (iv > 0) & (idp != 0) & interior
        fields = torch.stack(
            [img, pyr.gx[lvl], pyr.gy[lvl], idp, iv], dim=-1).reshape(-1, 5)
        budget = level_budget(h, w, lvl, budget_frac)
        idx, vals, slot_valid, n_valid = compact_points(valid, fields, budget)
        pts.append(PointSet(
            idx=idx, ival=vals[:, 0], gx=vals[:, 1], gy=vals[:, 2],
            idp=vals[:, 3], ivr=vals[:, 4], valid=slot_valid,
            n_valid=n_valid))
    return TrackingRef(pts=tuple(pts), sim3_quad=(None,) * len(pts))
