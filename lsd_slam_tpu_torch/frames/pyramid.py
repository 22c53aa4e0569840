"""Image / gradient / depth pyramids as dataclasses of tensors.

Port of lsd_slam_tpu/frames/pyramid.py (same field names and semantics):
  * image downsample: 2x2 box average (Frame.cpp:491-630);
  * gradients: central differences 0.5(I[x+1]-I[x-1]), zero on the border
    ring (Frame.cpp:643-680);
  * max-gradient: 3x3 max of |grad| via two separable max passes, border
    ring zeroed, plus the mappable-pixel count at level 0 (Frame.cpp:690-767);
  * inverse-depth downsample: 2x2 inverse-variance-weighted fusion of valid
    (var>0) hypotheses; invalid pixels carry -1 (Frame.cpp:775-877).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from lsd_slam_tpu_torch.ops.interp import quad_pack


@dataclass
class FramePyramid:
    """Per-level image data; images[l] has shape (H >> l, W >> l), f32.

    quad[l] is the (H*W, 12) quad-packed [image, gx, gy] layout the
    tracker samples with one row gather."""

    images: Tuple[torch.Tensor, ...]
    gx: Tuple[torch.Tensor, ...]
    gy: Tuple[torch.Tensor, ...]
    max_grad: Tuple[torch.Tensor, ...]
    quad: Tuple[torch.Tensor, ...]
    num_mappable: torch.Tensor  # scalar: level-0 pixels with max_grad >= thresh


@dataclass
class DepthPyramid:
    """Per-level semi-dense inverse depth. Invalid pixels: ivar <= 0."""

    idepth: Tuple[torch.Tensor, ...]
    ivar: Tuple[torch.Tensor, ...]


def num_levels(pyr: FramePyramid) -> int:
    return len(pyr.images)


def _box_down2(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _central_gradients(img: torch.Tensor):
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _max3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """3-tap max along a dim (edge-clamped)."""
    n = x.shape[dim]
    lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return torch.maximum(torch.maximum(lo, x), hi)


def build_frame(image: torch.Tensor, levels: int = 5,
                min_abs_grad: float = 5.0) -> FramePyramid:
    """Build the full pyramid for one grayscale image (H, W)."""
    img = image.to(torch.float32)
    images, gxs, gys, mgs, packs = [], [], [], [], []
    num_mappable = torch.zeros((), dtype=torch.float32, device=img.device)
    for lvl in range(levels):
        if lvl > 0:
            img = _box_down2(img)
        gx, gy = _central_gradients(img)
        mag = torch.sqrt(gx * gx + gy * gy)
        mg = _max3(_max3(mag, 0), 1)
        mask = torch.zeros_like(mg)
        mask[1:-1, 1:-1] = 1.0
        mg = mg * mask
        if lvl == 0:
            num_mappable = torch.sum((mg >= min_abs_grad).to(torch.float32))
        images.append(img)
        gxs.append(gx)
        gys.append(gy)
        mgs.append(mg)
        packs.append(quad_pack((img, gx, gy)))
    return FramePyramid(
        images=tuple(images), gx=tuple(gxs), gy=tuple(gys),
        max_grad=tuple(mgs), quad=tuple(packs), num_mappable=num_mappable,
    )


def _idepth_down2(idepth: torch.Tensor, ivar: torch.Tensor):
    """2x2 inverse-variance-weighted fusion (Frame.cpp:806-874)."""
    h, w = idepth.shape
    d = idepth.reshape(h // 2, 2, w // 2, 2)
    v = ivar.reshape(h // 2, 2, w // 2, 2)
    valid = v > 0
    zero = torch.zeros_like(v)
    iv = torch.where(valid, 1.0 / torch.where(valid, v, torch.ones_like(v)),
                     zero)
    ivar_sum = iv.sum(dim=(1, 3))
    id_sum = (iv * torch.where(valid, d, zero)).sum(dim=(1, 3))
    num = valid.sum(dim=(1, 3)).to(idepth.dtype)
    any_valid = num > 0
    safe = torch.where(any_valid, ivar_sum, torch.ones_like(ivar_sum))
    neg = torch.full_like(ivar_sum, -1.0)
    out_id = torch.where(any_valid, id_sum / safe, neg)
    out_var = torch.where(any_valid, num / safe, neg)
    return out_id, out_var


def build_depth_pyramid(idepth0: torch.Tensor, ivar0: torch.Tensor,
                        levels: int = 5) -> DepthPyramid:
    ids = [idepth0.to(torch.float32)]
    ivs = [ivar0.to(torch.float32)]
    for _ in range(1, levels):
        i, v = _idepth_down2(ids[-1], ivs[-1])
        ids.append(i)
        ivs.append(v)
    return DepthPyramid(idepth=tuple(ids), ivar=tuple(ivs))
