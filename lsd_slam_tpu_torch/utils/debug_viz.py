"""Debug visualizations: depth rainbow maps, residual/variance plots.

A numpy copy of lsd_slam_tpu/utils/debug_viz.py (== the reference's debug
imagery: DepthMapPixelHypothesis::getVisualizationColor rainbow mapping,
DepthMapPixelHypothesis.cpp:29-90; tracker residual plots,
SE3Tracker.cpp:793-852). Produces uint8 RGB numpy arrays; `save_png`
writes them through utils.image_io (no Pillow).
"""

from __future__ import annotations

import numpy as np


def rainbow_depth(idepth: np.ndarray, valid: np.ndarray,
                  background: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """Inverse depth -> rainbow RGB (DepthMapPixelHypothesis.cpp:37-63:
    id = idepth*scale; r/g/b ramps at 0..4 cycle)."""
    h, w = idepth.shape
    if background is not None:
        img = np.stack([np.clip(background, 0, 255).astype(np.uint8)] * 3, -1)
    else:
        img = np.zeros((h, w, 3), np.uint8)

    did = idepth * scale
    r = np.clip((0.0 - did) * 255.0 / 1.0, 0, 255)
    r = np.where(did > 0, np.clip((1.0 - np.abs(did - 0.0)) * 255, 0, 255), r)
    # classic 4-phase rainbow
    x = np.clip(did, 0, 4)
    rr = np.clip(np.where(x < 1, 255 * (1 - x),
                          np.where(x < 3, 0, 255 * (x - 3))), 0, 255)
    gg = np.clip(np.where(x < 1, 255 * x,
                          np.where(x < 2, 255, 255 * (3 - x))), 0, 255)
    bb = np.clip(np.where(x < 2, 0,
                          np.where(x < 3, 255 * (x - 2), 255 * (4 - x))), 0, 255)
    col = np.stack([rr, gg, bb], -1).astype(np.uint8)
    return np.where(valid[..., None], col, img)


def variance_map(var: np.ndarray, valid: np.ndarray,
                 max_var: float = 0.25) -> np.ndarray:
    """Variance as green (certain) -> red (uncertain)
    (DepthMapPixelHypothesis.cpp:66-90)."""
    h, w = var.shape
    f = np.clip(np.sqrt(np.maximum(var, 0) / max_var), 0, 1)
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = (255 * f).astype(np.uint8)
    img[..., 1] = (255 * (1 - f)).astype(np.uint8)
    return np.where(valid[..., None], img, 0)


def residual_map(residual: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Signed residual centered at gray 128 (SE3Tracker.cpp:1007-1013)."""
    v = np.clip(residual + 128.0, 0, 255).astype(np.uint8)
    img = np.stack([v, v, v], -1)
    img[~mask] = (255, 0, 0)
    return img


def save_png(path: str, rgb: np.ndarray) -> None:
    from lsd_slam_tpu_torch.utils.image_io import write_png

    write_png(path, rgb)
