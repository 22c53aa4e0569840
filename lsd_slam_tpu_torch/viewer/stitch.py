"""Offline comparison-video compositor.

A numpy copy of lsd_slam_tpu/viewer/stitch.py. Frames are read and written
through utils.image_io, and `scale:` resizes with `resize_bicubic`, a
numpy copy of the resampling that Pillow's `Image.resize` does for RGB
images (bicubic, a = -0.5, 22-bit fixed-point weights). Only the pane
labels need Pillow (its ImageDraw text).

Equivalent of the reference's stitching utility
(lsd_slam_viewer/src/main_stitchVideos.cpp): take N directories of
numbered frame images (as dumped by the viewer's video mode,
PointCloudViewer.cpp:251), compose each frame index side-by-side /
grid-wise with optional per-pane labels, and write the stitched frames
to an output directory (encode with any external tool afterwards).

Usage:
    python -m lsd_slam_tpu_torch.viewer.stitch out:/tmp/stitched \
        /run1/frames /run2/frames [cols:2] [label:run1,run2] [scale:0.5]
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from lsd_slam_tpu_torch.utils import image_io

# Pillow's fixed-point resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _load(path: str) -> np.ndarray:
    return image_io.read_rgb(path)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_coeffs(in_size: int, out_size: int):
    """(first input index, fixed-point weights (out, k)) of each output
    sample along one axis, as Pillow's precompute_coeffs and
    normalize_coeffs_8bpc compute them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):        # summed in Pillow's order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    xmin, k = _resample_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    n = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, n - 1)
        kt = k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx] * kt
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(h, w, c) uint8 -> (height, width, c), as Pillow's
    `Image.fromarray(img).resize((width, height))` gives it: horizontal
    pass, then vertical, each rounded to uint8."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def _frame_list(d: str) -> List[str]:
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    return sorted(f for f in os.listdir(d) if f.lower().endswith(exts))


def _label(img: np.ndarray, text: str) -> np.ndarray:
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise RuntimeError("stitch labels (label:) draw text with Pillow, "
                           "which is not installed") from e
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    draw.rectangle([4, 4, 10 + 7 * len(text), 22], fill=(0, 0, 0))
    draw.text((8, 6), text, fill=(255, 255, 255))
    return np.asarray(pil)


def stitch_grid(frames: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """Compose frames into a row-major grid, padding panes to the max
    pane size and the last row with black."""
    h = max(f.shape[0] for f in frames)
    w = max(f.shape[1] for f in frames)
    padded = []
    for f in frames:
        p = np.zeros((h, w, 3), np.uint8)
        p[: f.shape[0], : f.shape[1]] = f
        padded.append(p)
    rows = (len(padded) + cols - 1) // cols
    while len(padded) < rows * cols:
        padded.append(np.zeros((h, w, 3), np.uint8))
    return np.concatenate(
        [np.concatenate(padded[r * cols:(r + 1) * cols], axis=1)
         for r in range(rows)], axis=0)


def stitch_dirs(dirs: Sequence[str], out_dir: str, cols: int = 0,
                labels: Optional[Sequence[str]] = None,
                scale: float = 1.0) -> int:
    """Stitch per-index frames from `dirs` into out_dir/%05d.png.

    Frame count = min over inputs (the reference holds the shorter video's
    last frame; truncating keeps all panes live). Returns frames written."""
    lists = [_frame_list(d) for d in dirs]
    n = min(len(l) for l in lists)
    if n == 0:
        return 0
    cols = cols or len(dirs)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        panes = []
        for k, d in enumerate(dirs):
            img = _load(os.path.join(d, lists[k][i]))
            if scale != 1.0:
                img = resize_bicubic(img, max(1, int(img.shape[1] * scale)),
                                     max(1, int(img.shape[0] * scale)))
            if labels and k < len(labels) and labels[k]:
                img = _label(img, labels[k])
            panes.append(img)
        image_io.write_png(os.path.join(out_dir, f"{i:05d}.png"),
                           stitch_grid(panes, cols))
    return n


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out, cols, scale, labels, dirs = "", 0, 1.0, None, []
    for a in argv:
        if a.startswith("out:"):
            out = a[4:]
        elif a.startswith("cols:"):
            cols = int(a[5:])
        elif a.startswith("scale:"):
            scale = float(a[6:])
        elif a.startswith("label:"):
            labels = a[6:].split(",")
        else:
            dirs.append(a)
    if not out or not dirs:
        print(__doc__)
        return 2
    n = stitch_dirs(dirs, out, cols=cols, labels=labels, scale=scale)
    print(f"stitched {n} frames x {len(dirs)} panes -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
