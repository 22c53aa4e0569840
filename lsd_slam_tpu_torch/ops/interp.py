"""Bilinear interpolation as clamped flat gathers (torch).

Port of lsd_slam_tpu/ops/interp.py. Coordinates are pixel-centered like
the reference (integer coordinate == pixel center). The JAX package packs
the bilinear footprint into gather rows because a TPU gather costs per row;
the port keeps the same packed layouts (`quad_pack`, `patch16_pack`) so the
two packages can be compared value for value, clamps included.

Two framework differences are handled explicitly here:
  * JAX clamps out-of-bounds gathers (`jnp.take(mode="clip")`); torch
    raises on the CPU and faults on the card, so every gather index is
    clamped first;
  * XLA converts NaN to integer 0 and saturates out-of-range floats, while
    torch's float->int cast is undefined there — `trunc_int` reproduces
    XLA's conversion.
"""

from __future__ import annotations

import torch

_I32_MIN = -2147483648.0
_I32_MAX = 2147483647.0


def trunc_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int64 with XLA's f32->s32 semantics: truncate toward zero,
    NaN -> 0, saturate to the int32 range."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=_I32_MAX,
                         neginf=_I32_MIN)
    return torch.clamp(x, _I32_MIN, _I32_MAX).to(torch.int64)


def _take_clip(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1)]


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample img (H, W) at float coords u (x), v (y); clamped at borders."""
    h, w = img.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    idx = (trunc_int(v0) * w + trunc_int(u0)).reshape(-1)
    flat = img.reshape(-1)
    shape = u.shape
    i00 = _take_clip(flat, idx).reshape(shape)
    i01 = _take_clip(flat, idx + 1).reshape(shape)
    i10 = _take_clip(flat, idx + w).reshape(shape)
    i11 = _take_clip(flat, idx + w + 1).reshape(shape)
    return (i00 * (1 - fu) + i01 * fu) * (1 - fv) \
        + (i10 * (1 - fu) + i11 * fu) * fv


def quad_pack(channels) -> torch.Tensor:
    """Pack C channels of an (H, W) image into the (H*W, 4*C) quad layout:
    row y*W + x = [p00 ch.. | p01 .. | p10 .. | p11 ..] (rolls: the last
    row/column wrap, callers never address them)."""
    base = torch.stack(list(channels), dim=-1)  # (H, W, C)
    h, w, c = base.shape
    p01 = torch.roll(base, -1, dims=1)
    p10 = torch.roll(base, -1, dims=0)
    p11 = torch.roll(p10, -1, dims=1)
    return torch.cat([base, p01, p10, p11], dim=-1).reshape(h * w, 4 * c)


def quad_coords(h: int, w: int, u, v):
    """Clamp (u, v), split into (flat row index, fu, fv)."""
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    idx = trunc_int(v0) * w + trunc_int(u0)
    return idx, u - u0, v - v0


def quad_sample(quad: torch.Tensor, h: int, w: int, u, v):
    """Bilinear-sample a quad-packed image with one row gather.

    Returns (channels, raw_rows, (fu, fv)) like the JAX version."""
    c = quad.shape[1] // 4
    idx, fu, fv = quad_coords(h, w, u, v)
    g = _take_clip(quad, idx.reshape(-1))  # (N, 4C)
    w00 = ((1 - fu) * (1 - fv)).reshape(-1)
    w01 = (fu * (1 - fv)).reshape(-1)
    w10 = ((1 - fu) * fv).reshape(-1)
    w11 = (fu * fv).reshape(-1)
    outs = [
        (g[:, k] * w00 + g[:, c + k] * w01
         + g[:, 2 * c + k] * w10 + g[:, 3 * c + k] * w11).reshape(u.shape)
        for k in range(c)
    ]
    return outs, g, (fu, fv)


def patch16_pack(img: torch.Tensor) -> torch.Tensor:
    """Pack an (H, W) image into the (H*W, 16) 4x4-patch layout: row
    y*W + x holds img[y:y+4, x:x+4] row-major (lane 4*dy+dx). Built with
    rolls; callers clamp the patch base to <= (H-4, W-4)."""
    h, w = img.shape
    chans = []
    for dy in range(4):
        r = torch.roll(img, -dy, dims=0) if dy else img
        for dx in range(4):
            chans.append(torch.roll(r, -dx, dims=1) if dx else r)
    return torch.stack(chans, dim=-1).reshape(h * w, 16)


def patch16_sample(patch: torch.Tensor, h: int, w: int, us, vs):
    """Bilinear-sample grouped positions with one row gather per group.

    us/vs: (..., M) float coords whose trailing group spans at most 2 px
    per axis. Same clamps as the JAX version (interp.py:131-143): the
    coords clamp to [0, W-1.001], the patch base to [0, W-4], and the
    in-patch corner to [0, 2]. The four taps are read from the corner's
    lanes and weighted with the JAX weight formula."""
    us = torch.clamp(us, 0.0, w - 1.001)
    vs = torch.clamp(vs, 0.0, h - 1.001)
    bx = torch.clamp(torch.amin(us, dim=-1), 0.0, w - 4.0)
    by = torch.clamp(torch.amin(vs, dim=-1), 0.0, h - 4.0)
    bx = trunc_int(torch.floor(bx))
    by = trunc_int(torch.floor(by))
    idx = by * w + bx
    g = _take_clip(patch, idx.reshape(-1))
    g = g.reshape(idx.shape + (16,))                         # (..., 16)
    lx = us - bx[..., None].to(us.dtype)                     # [0, 3.x)
    ly = vs - by[..., None].to(vs.dtype)
    u0 = torch.clamp(torch.floor(lx), 0.0, 2.0)
    v0 = torch.clamp(torch.floor(ly), 0.0, 2.0)
    fu = lx - u0
    fv = ly - v0
    corner_f = v0 * 4.0 + u0                                 # (..., M)
    corner = trunc_int(corner_f)
    m = us.shape[-1]
    lanes = torch.stack([corner, corner + 1, corner + 4, corner + 5], -1)
    taps = torch.gather(g.unsqueeze(-2).expand(g.shape[:-1] + (m, 16)), -1,
                        lanes)                               # (..., M, 4)
    out = (taps[..., 0] * ((1 - fu) * (1 - fv))
           + taps[..., 1] * (fu * (1 - fv))
           + taps[..., 2] * ((1 - fu) * fv)
           + taps[..., 3] * (fu * fv))
    # a NaN coordinate matches no lane in the JAX lane-equality weights
    # (select semantics), so its sample is 0, not NaN
    return torch.where(torch.isnan(corner_f), torch.zeros_like(out), out)
