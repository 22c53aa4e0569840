"""Appearance-based loop-closure retrieval, the FabMap slot (torch).

Port of lsd_slam_tpu/mapping/appearance.py (which replaces the gated
openFabMap integration, src/GlobalMapping/FabMap.{h,cpp}):

  * every keyframe gets a tiled gradient descriptor: a TILES x TILES grid
    of soft-binned gradient-orientation histograms plus normalized tile
    mean intensities, from one pyramid level, with one bilinear gather and
    scatter-adds through the order-fixed `ops.scatter.ordered_index_add`
    (so a descriptor has the same bits on every run);
  * in-plane rotation is marginalized: a query is described at
    N_ROTATIONS rolls in one batched pass (JAX's vmap is the leading batch
    dimension here), and its scores are the max over rolls of one
    (R, D) x (D, N) matmul against the stored keyframe descriptors;
  * a best-to-second ratio test accepts a match, the analog of FabMap's
    p >= 0.8 gate (FabMap.cpp:126-204).

The descriptor matrix lives on the index's device in a buffer padded to a
power of two: `add` sets one row, a query is one batched pass and one
(N,) pull. Temporal neighbours are excluded by insertion index. Optional,
as in the reference (`cfg.system.use_fabmap`).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.ops.interp import trunc_int
from lsd_slam_tpu_torch.ops.scatter import ordered_index_add

TILES = 4           # TxT tile grid
ORI_BINS = 8        # orientation histogram bins per tile
N_ROTATIONS = 16    # query roll marginalization steps (22.5 deg apart)


def _descriptor_rotations(img, gx, gy, thetas, tiles: int = TILES,
                          ori_bins: int = ORI_BINS):
    """(R, D) descriptors of the image as seen under in-plane rolls of
    -thetas (R,): the tile grid samples along axes rotated by theta about
    the image centre and gradient orientations are taken relative to theta.
    Each row is a unit vector of length tiles*tiles*(ori_bins+1)."""
    h, w = img.shape
    dev = img.device
    n_rot = thetas.shape[0]
    zero = torch.zeros((), device=dev)
    mag = torch.sqrt(gx * gx + gy * gy)
    big = mag > 1e-6
    cos_a = torch.where(big, gx / torch.clamp_min(mag, 1e-6),
                        torch.ones((), device=dev))
    sin_a = torch.where(big, gy / torch.clamp_min(mag, 1e-6), zero)

    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    th = thetas.reshape(n_rot, 1, 1)
    c, s = torch.cos(th), torch.sin(th)
    xr = cx + c * (xs - cx) - s * (ys - cy)                      # (R, h, w)
    yr = cy + s * (xs - cx) + c * (ys - cy)
    inb = (xr >= 0) & (xr <= w - 1.001) & (yr >= 0) & (yr <= h - 1.001)
    # the inscribed disc, so every rotation sees the same support
    r0 = min(cx, cy)
    dx, dy = (xs - cx) / r0, (ys - cy) / r0
    inb = inb & (dx * dx + dy * dy <= 1.0)
    x0 = torch.clamp(trunc_int(xr), 0, w - 2)
    y0 = torch.clamp(trunc_int(yr), 0, h - 2)
    fx = torch.clamp(xr - x0, 0.0, 1.0)
    fy = torch.clamp(yr - y0, 0.0, 1.0)
    i00 = y0 * w + x0

    def bilerp(a):
        flat = a.reshape(-1)
        a00, a01 = flat[i00], flat[i00 + 1]
        a10, a11 = flat[i00 + w], flat[i00 + w + 1]
        return ((1 - fy) * ((1 - fx) * a00 + fx * a01)
                + fy * ((1 - fx) * a10 + fx * a11))

    img_r = torch.where(inb, bilerp(img), zero)
    mag_r = torch.where(inb, bilerp(mag), zero)
    rel = torch.atan2(bilerp(sin_a), bilerp(cos_a)) - th

    # soft-binned orientation histogram per tile: one ordered scatter of
    # the lower bins, then the upper ones, as the JAX package's two adds
    ty = torch.clamp(trunc_int(ys * tiles / h), 0, tiles - 1)
    tx = torch.clamp(trunc_int(xs * tiles / w), 0, tiles - 1)
    tile = (ty * tiles + tx).expand(n_rot, h, w)
    b = torch.remainder(rel / np.float32(2 * math.pi) * ori_bins, ori_bins)
    b0 = torch.floor(b)
    fb = b - b0
    b0i = torch.remainder(b0.to(torch.int64), ori_bins)
    b1i = torch.remainder(b0i + 1, ori_bins)
    n_tiles = tiles * tiles
    rot = torch.arange(n_rot, device=dev).reshape(n_rot, 1, 1)
    base = (rot * n_tiles + tile) * ori_bins
    hist = ordered_index_add(
        torch.zeros((n_rot * n_tiles * ori_bins,), device=dev),
        torch.cat([(base + b0i).reshape(-1), (base + b1i).reshape(-1)]),
        torch.cat([(mag_r * (1 - fb)).reshape(-1),
                   (mag_r * fb).reshape(-1)]))
    hist = hist.reshape(n_rot, n_tiles, ori_bins)
    hist = hist / torch.clamp_min(
        torch.sqrt(torch.sum(hist * hist, dim=2, keepdim=True)), 1e-6)

    # normalized tile mean intensities (a lighting-invariant layout cue)
    cell = (rot * n_tiles + tile).reshape(-1)
    wsum, isum = ordered_index_add(
        torch.zeros((n_rot * n_tiles, 2), device=dev), cell,
        torch.stack([inb.to(torch.float32).reshape(-1), img_r.reshape(-1)],
                    dim=1)).unbind(1)
    imean = (isum / torch.clamp_min(wsum, 1.0)).reshape(n_rot, n_tiles)
    imean = imean - torch.mean(imean, dim=1, keepdim=True)
    imean = imean / torch.clamp_min(
        torch.sqrt(torch.sum(imean * imean, dim=1, keepdim=True)), 1e-6)

    d = torch.cat([hist.reshape(n_rot, -1) / np.float32(math.sqrt(n_tiles)),
                   imean], dim=1)
    return d / torch.clamp_min(torch.sqrt(torch.sum(d * d, dim=1,
                                                    keepdim=True)), 1e-6)


def _descriptor_at(img, gx, gy, theta: float = 0.0):
    """The (D,) descriptor at one roll angle."""
    return _descriptor_rotations(
        img, gx, gy, torch.full((1,), theta, dtype=torch.float32,
                                device=img.device))[0]


def _score_rotations(queries, descs):
    """Max-over-rolls cosine scores: (R, D) x (N, D) -> (N,)."""
    return torch.max(queries @ descs.T, dim=0).values


def _query_scores(mat, img, gx, gy, thetas):
    """R roll descriptors and one (R, D) x (D, N) matmul."""
    return _score_rotations(_descriptor_rotations(img, gx, gy, thetas), mat)


class AppearanceIndex:
    """Keyframe descriptor store and rotation-marginalized retrieval.

    The descriptor matrix lives on the device in a power-of-two-padded
    buffer: `add` sets one row (growth is a rare pad-copy), a query is one
    batched pass and one (N,) host pull whatever N. Temporal exclusion is
    by keyframe insertion index. `n_queries` counts the queries that
    scored the index, `n_hits` those that returned a keyframe."""

    def __init__(self, accept_score: float = 0.6, ratio: float = 1.08,
                 min_index_gap: int = 5, level: int = 2,
                 n_rotations: int = N_ROTATIONS, initial_capacity: int = 32,
                 device=None):
        self.accept_score = accept_score
        self.ratio = ratio
        self.min_index_gap = min_index_gap
        self.level = level
        self.device = resolve_device(device)
        self._thetas = torch.as_tensor(
            np.linspace(0.0, 2 * np.pi, n_rotations, endpoint=False),
            dtype=torch.float32, device=self.device)
        self._ids: List[int] = []
        self._index_of = {}                    # kf_id -> insertion index
        self._capacity = initial_capacity
        self._mat: Optional[torch.Tensor] = None  # (capacity, D) padded
        self.n_queries = self.n_hits = 0

    def __len__(self) -> int:
        return len(self._ids)

    def _level(self, pyr):
        lvl = self.level
        return pyr.images[lvl], pyr.gx[lvl], pyr.gy[lvl]

    def compute_descriptor(self, pyr) -> np.ndarray:
        return _descriptor_at(*self._level(pyr)).cpu().numpy()

    def add(self, kf_id: int, pyr) -> None:
        """== FabMap::compareAndAdd's add half (FabMap.cpp:126-204)."""
        desc = _descriptor_at(*self._level(pyr))
        i = len(self._ids)
        if self._mat is None:
            self._mat = torch.zeros((self._capacity, desc.shape[0]),
                                    device=desc.device)
        if i >= self._capacity:
            self._capacity *= 2
            self._mat = torch.cat([self._mat, torch.zeros_like(self._mat)])
        self._mat[i] = desc
        self._index_of[kf_id] = i
        self._ids.append(kf_id)

    def query(self, pyr, query_id: int) -> Optional[int]:
        """Best-matching keyframe id, or None if no confident match."""
        n = len(self._ids)
        if n < 2:
            return None
        self.n_queries += 1
        scores = _query_scores(self._mat, *self._level(pyr),
                               self._thetas)[:n].cpu().numpy()   # one pull
        # exclude temporally-near keyframes: for a keyframe in the index by
        # insertion order; for an unknown query frame over min_index_gap
        # keyframe intervals, measured from the index's own id spacing
        qi = self._index_of.get(query_id)
        ids = np.asarray(self._ids)
        if qi is not None:
            lo = max(0, qi - self.min_index_gap)
            hi = min(n, qi + self.min_index_gap + 1)
            scores[lo:hi] = -1.0
        else:
            cadence = float(np.median(np.diff(ids))) if n > 1 else 1.0
            window = self.min_index_gap * max(cadence, 1.0)
            scores[np.abs(ids - query_id) < window] = -1.0
        order = np.argsort(scores)[::-1]
        best, second = order[0], (order[1] if len(order) > 1 else order[0])
        if scores[best] < self.accept_score:
            return None
        if scores[second] > 0 and scores[best] < self.ratio * scores[second]:
            return None  # ambiguous place
        self.n_hits += 1
        return int(self._ids[best])
