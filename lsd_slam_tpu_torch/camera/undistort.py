"""Calibration-file parsing + undistortion as a device gather (torch).

Port of lsd_slam_tpu/camera/undistort.py. The reference's calibration
formats (README.md:142-170, util/Undistorter.cpp:38-88):

  * 5-parameter ATAN/FOV ("PTAM") model: ``fx fy cx cy omega`` (relative),
    with output spec ``crop`` / ``full`` / ``none`` / explicit 5 params;
  * 8-parameter OpenCV model: ``fx fy cx cy k1 k2 p1 p2`` (relative) with
    iterative inverse distortion (no OpenCV dependency).

The remap table (output pixel -> distorted input pixel) is built once on the
host in float64 numpy, as in the JAX package (the table code below is a
copy); applying it is a bilinear gather in torch ops on the undistorter's
device. The JAX version is a jitted `jnp` program with no Pallas source,
so it is ported as torch ops. Its border rule clips y0+1 and x0+1 to h-1
and w-1; the host remap `utils.native.remap_bilinear_cpu` clips x0 and y0
instead, as in the JAX package; the two are kept apart.
FOV forward model (distorted radius from undistorted):
    r_d = atan(r_u * 2 tan(omega/2)) / omega           (Undistorter.cpp:293-296)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.camera.model import Camera


class Undistorter:
    """Precomputed remap undistorter.

    remap_x/remap_y hold, for every output pixel, the (sub-pixel) source
    coordinate in the distorted input image; -1 marks invalid pixels
    (outside the input), matching Undistorter.cpp:297-312. The tables live
    as tensors on `device` (the CUDA device unless the caller names one).
    """

    def __init__(self, camera: Camera, remap_x: np.ndarray, remap_y: np.ndarray,
                 input_size: tuple, original_params: Optional[np.ndarray] = None,
                 device=None):
        self.camera = camera
        self.input_size = input_size  # (in_width, in_height)
        self.original_params = original_params
        self.device = resolve_device(device)
        valid = (remap_x >= 0) & (remap_y >= 0)
        self._rx = torch.as_tensor(
            np.where(valid, remap_x, 0.0).astype(np.float32),
            device=self.device)
        self._ry = torch.as_tensor(
            np.where(valid, remap_y, 0.0).astype(np.float32),
            device=self.device)
        self._valid = torch.as_tensor(valid, device=self.device)
        self._identity = bool(
            input_size == (camera.width, camera.height)
            and np.allclose(remap_x, np.arange(camera.width)[None, :], atol=1e-9)
            and np.allclose(remap_y, np.arange(camera.height)[:, None], atol=1e-9)
        )

    def __call__(self, image) -> torch.Tensor:
        """Undistort one grayscale image (in_h, in_w) -> (out_h, out_w) f32
        on the undistorter's device."""
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        if self._identity:
            return img
        return _remap_bilinear(img, self._rx, self._ry, self._valid)


def _remap_bilinear(img, rx, ry, valid):
    x0 = torch.floor(rx)
    y0 = torch.floor(ry)
    wx = rx - x0
    wy = ry - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    h, w = img.shape

    def at(yy, xx):
        return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    v = (
        at(y0i, x0i) * (1 - wx) * (1 - wy)
        + at(y0i, x0i + 1) * wx * (1 - wy)
        + at(y0i + 1, x0i) * (1 - wx) * wy
        + at(y0i + 1, x0i + 1) * wx * wy
    )
    return torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))


# ---------------------------------------------------------------------------
# FOV / ATAN ("PTAM") model
# ---------------------------------------------------------------------------

def _fov_distort_radius(r_u: np.ndarray, omega: float) -> np.ndarray:
    """r_d = atan(r_u * 2 tan(omega/2)) / omega."""
    if omega == 0:
        return r_u
    return np.arctan(r_u * 2.0 * np.tan(omega / 2.0)) / omega


def _fov_undistort_radius(r_d: np.ndarray, omega: float) -> np.ndarray:
    """Inverse of the above: r_u = tan(r_d * omega) / (2 tan(omega/2))."""
    if omega == 0:
        return r_d
    return np.tan(r_d * omega) / (2.0 * np.tan(omega / 2.0))


def make_fov_undistorter(
    rel_params: Sequence[float],
    in_size: tuple,
    out_spec,
    out_size: tuple,
    device=None,
) -> Undistorter:
    """Build an FOV-model undistorter.

    rel_params: (fx, fy, cx, cy, omega) relative to image size.
    out_spec: "crop" | "full" | "none" | 5-tuple of relative output params.
    Mirrors UndistorterPTAM (Undistorter.cpp:90-345) including the crop/full
    output-K computation.
    """
    in_w, in_h = in_size
    out_w, out_h = out_size
    rfx, rfy, rcx, rcy, omega = [float(v) for v in rel_params]

    fx = rfx * in_w
    fy = rfy * in_h
    cx = rcx * in_w - 0.5
    cy = rcy * in_h - 0.5

    if out_spec == "none" or omega == 0 and out_spec == "crop":
        pass

    if out_spec == "none":
        cam = Camera(fx, fy, cx, cy, in_w, in_h)
        gx, gy = np.meshgrid(np.arange(in_w, dtype=np.float64),
                             np.arange(in_h, dtype=np.float64))
        return Undistorter(cam, gx, gy, in_size,
                           np.array([rfx, rfy, rcx, rcy, omega]), device)

    if omega == 0:
        ofx, ofy = rfx * out_w, rfy * out_h
        ocx, ocy = rcx * out_w - 0.5, rcy * out_h - 0.5
    elif out_spec == "crop":
        # scale output focal lengths so the (distorted) input edges map onto
        # the output edges; Undistorter.cpp:201-228
        left_r = cx / fx
        right_r = (in_w - 1 - cx) / fx
        top_r = cy / fy
        bottom_r = (in_h - 1 - cy) / fy
        tl, tr_, tp, bt = [
            _fov_undistort_radius(np.asarray(r), omega)
            for r in (left_r, right_r, top_r, bottom_r)
        ]
        ofy = fy * ((top_r + bottom_r) / (tp + bt)) * (out_h / in_h)
        ocy = (tp / top_r) * ofy * cy / fy
        ofx = fx * ((left_r + right_r) / (tl + tr_)) * (out_w / in_w)
        ocx = (tl / left_r) * ofx * cx / fx
    elif out_spec == "full":
        # Undistorter.cpp:230-268: fit the full (diagonal) field of view
        lr = cx / fx
        rr = (in_w - 1 - cx) / fx
        tr0 = cy / fy
        br0 = (in_h - 1 - cy) / fy
        tl_r = np.hypot(lr, tr0)
        tr_r = np.hypot(rr, tr0)
        bl_r = np.hypot(lr, br0)
        br_r = np.hypot(rr, br0)
        t_tl, t_tr, t_bl, t_br = [
            _fov_undistort_radius(np.asarray(r), omega)
            for r in (tl_r, tr_r, bl_r, br_r)
        ]
        hor = max(br_r, tr_r) + max(bl_r, tl_r)
        vert = max(tr_r, tl_r) + max(bl_r, br_r)
        t_hor = max(t_br, t_tr) + max(t_bl, t_tl)
        t_vert = max(t_tr, t_tl) + max(t_bl, t_br)
        ofy = fy * (vert / t_vert) * (out_h / in_h)
        ocy = max(t_tl / tl_r, t_tr / tr_r) * ofy * cy / fy
        ofx = fx * (hor / t_hor) * (out_w / in_w)
        ocx = max(t_bl / bl_r, t_tl / tl_r) * ofx * cx / fx
    else:
        o = [float(v) for v in out_spec]
        ofx, ofy = o[0] * out_w, o[1] * out_h
        ocx, ocy = o[2] * out_w - 0.5, o[3] * out_h - 0.5

    # remap: output pixel -> input pixel through the forward FOV distortion
    # (Undistorter.cpp:288-314)
    xs = np.arange(out_w, dtype=np.float64)
    ys = np.arange(out_h, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    ix = (gx - ocx) / ofx
    iy = (gy - ocy) / ofy
    r = np.hypot(ix, iy)
    with np.errstate(invalid="ignore", divide="ignore"):
        if omega == 0:
            fac = np.ones_like(r)
        else:
            d2t = 2.0 * np.tan(omega / 2.0)
            fac = np.where(r == 0, 1.0, np.arctan(r * d2t) / (omega * np.maximum(r, 1e-12)))
    sx = fx * fac * ix + cx
    sy = fy * fac * iy + cy
    invalid = ~((sx > 0) & (sy > 0) & (sx < in_w - 1) & (sy < in_h - 1))
    sx = np.where(invalid, -1.0, sx)
    sy = np.where(invalid, -1.0, sy)

    cam = Camera(float(ofx), float(ofy), float(ocx), float(ocy), out_w, out_h)
    return Undistorter(cam, sx, sy, in_size,
                       np.array([rfx, rfy, rcx, rcy, omega]), device)


# ---------------------------------------------------------------------------
# OpenCV radial-tangential model (k1 k2 p1 p2), no OpenCV dependency
# ---------------------------------------------------------------------------

def _opencv_distort(xn, yn, k1, k2, p1, p2):
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def make_opencv_undistorter(
    rel_params: Sequence[float], in_size: tuple, out_spec, out_size: tuple,
    device=None,
) -> Undistorter:
    """Radial-tangential model a la UndistorterOpenCV (Undistorter.cpp:414-603).

    The output K for "crop" keeps the central valid region (equivalent to
    cv::getOptimalNewCameraMatrix(alpha=0)); implemented here by scanning the
    undistorted positions of the input border.
    """
    in_w, in_h = in_size
    out_w, out_h = out_size
    rfx, rfy, rcx, rcy, k1, k2, p1, p2 = [float(v) for v in rel_params]
    fx, fy = rfx * in_w, rfy * in_h
    cx, cy = rcx * in_w - 0.5, rcy * in_h - 0.5

    if out_spec == "none" or (k1 == 0 and k2 == 0 and p1 == 0 and p2 == 0):
        cam = Camera(fx, fy, cx, cy, in_w, in_h)
        gx, gy = np.meshgrid(np.arange(in_w, dtype=np.float64),
                             np.arange(in_h, dtype=np.float64))
        return Undistorter(cam, gx, gy, in_size, device=device)

    # undistort the input border to find the valid output region
    bx = np.concatenate([
        np.linspace(0, in_w - 1, 256), np.linspace(0, in_w - 1, 256),
        np.zeros(256), np.full(256, in_w - 1.0)])
    by = np.concatenate([
        np.zeros(256), np.full(256, in_h - 1.0),
        np.linspace(0, in_h - 1, 256), np.linspace(0, in_h - 1, 256)])
    xn = (bx - cx) / fx
    yn = (by - cy) / fy
    # iterative undistort (Gauss fixed point)
    xu, yu = xn.copy(), yn.copy()
    for _ in range(20):
        xd, yd = _opencv_distort(xu, yu, k1, k2, p1, p2)
        xu += xn - xd
        yu += yn - yd

    if out_spec == "crop":
        # inner rectangle: max of left/top border coords, min of right/bottom
        left = np.max(xu[512:768])
        right = np.min(xu[768:1024])
        top = np.max(yu[0:256])
        bottom = np.min(yu[256:512])
    else:  # "full" or explicit
        if isinstance(out_spec, (list, tuple)):
            o = [float(v) for v in out_spec]
            ofx, ofy = o[0] * out_w, o[1] * out_h
            ocx, ocy = o[2] * out_w - 0.5, o[3] * out_h - 0.5
            return _finish_opencv(fx, fy, cx, cy, k1, k2, p1, p2,
                                  ofx, ofy, ocx, ocy, in_size, out_size,
                                  device)
        left, right = np.min(xu), np.max(xu)
        top, bottom = np.min(yu), np.max(yu)

    ofx = (out_w - 1) / (right - left)
    ofy = (out_h - 1) / (bottom - top)
    ocx = -left * ofx
    ocy = -top * ofy
    return _finish_opencv(fx, fy, cx, cy, k1, k2, p1, p2,
                          ofx, ofy, ocx, ocy, in_size, out_size, device)


def _finish_opencv(fx, fy, cx, cy, k1, k2, p1, p2, ofx, ofy, ocx, ocy,
                   in_size, out_size, device):
    in_w, in_h = in_size
    out_w, out_h = out_size
    gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                         np.arange(out_h, dtype=np.float64))
    xn = (gx - ocx) / ofx
    yn = (gy - ocy) / ofy
    xd, yd = _opencv_distort(xn, yn, k1, k2, p1, p2)
    sx = fx * xd + cx
    sy = fy * yd + cy
    invalid = ~((sx > 0) & (sy > 0) & (sx < in_w - 1) & (sy < in_h - 1))
    sx = np.where(invalid, -1.0, sx)
    sy = np.where(invalid, -1.0, sy)
    cam = Camera(float(ofx), float(ofy), float(ocx), float(ocy), out_w, out_h)
    return Undistorter(cam, sx, sy, in_size, device=device)


# ---------------------------------------------------------------------------
# calibration file parsing (auto-detects model; Undistorter.cpp:38-88)
# ---------------------------------------------------------------------------

def undistorter_for_params(params, in_size, out_spec, out_size,
                           device=None) -> Undistorter:
    if len(params) == 5:
        return make_fov_undistorter(params, in_size, out_spec, out_size,
                                    device)
    if len(params) == 8:
        return make_opencv_undistorter(params, in_size, out_spec, out_size,
                                       device)
    raise ValueError(f"expected 5 (FOV) or 8 (OpenCV) params, got {len(params)}")


def undistorter_for_file(path: str, device=None) -> Undistorter:
    """Parse the 4-line calibration format (README.md:142-170)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines() if ln.strip()]
    params = [float(v) for v in lines[0].split()]
    in_w, in_h = [int(v) for v in lines[1].split()]
    spec_line = lines[2]
    if spec_line in ("crop", "full", "none"):
        out_spec = spec_line
    else:
        out_spec = [float(v) for v in spec_line.split()]
    out_w, out_h = [int(v) for v in lines[3].split()]
    return undistorter_for_params(params, (in_w, in_h), out_spec,
                                  (out_w, out_h), device)
