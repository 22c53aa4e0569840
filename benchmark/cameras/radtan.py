"""OpenCV's radial-tangential model (k1 k2 p1 p2), as LSD-SLAM reads an
8-parameter calibration: the generator renders the raw, distorted image
along the model's rays; the program undistorts each frame with its
`Undistorter` (`camera/undistort.make_opencv_undistorter`, output "crop")
before it tracks it; and the plain reference below works out the output
camera and the remap itself, in float64.

The reference's crop rule, border scan and fixed-point inverse are a
frozen copy of `lsd_slam_tpu_torch/camera/undistort.py` at commit 30445d6
(`_opencv_distort`, lines 218-223; `make_opencv_undistorter`, 226-289;
`_finish_opencv`, 292-310), and its bilinear gather keeps that file's
border rule (`_remap_bilinear`, 71-89: y0 + 1 and x0 + 1 clipped to the
last row and column). It imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.cameras.pinhole import Pinhole


def distort(xn, yn, k1, k2, p1, p2):
    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return xd, yd


def undistort_points(xn, yn, k, iterations):
    """Fixed-point inverse of `distort` (works on numpy or torch)."""
    xu, yu = xn + 0.0, yn + 0.0
    for _ in range(iterations):
        xd, yd = distort(xu, yu, *k)
        xu = xu + (xn - xd)
        yu = yu + (yn - yd)
    return xu, yu


class Setup:
    undistorts = True

    def __init__(self, cam: dict):
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.k = tuple(float(cam[n]) for n in ("k1", "k2", "p1", "p2"))
        self.raw = (int(cam["width"]), int(cam["height"]))
        if cam.get("output", "crop") != "crop":
            raise ValueError("only LSD-SLAM's 'crop' output is modelled")
        self.out = (int(cam["out_width"]), int(cam["out_height"]))
        self.pinhole, self.map_x, self.map_y = self._reference_tables()

    # ---------------------------------------------------------- generator
    def dirs_cam(self, device):
        """Ray directions (H, W, 3) f32 of the raw image's pixels: each
        pixel's normalised coordinates, undistorted in float64."""
        w, h = self.raw
        dev = torch.device(device)
        ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
        xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
        xn = ((xs - self.cx) / self.fx).expand(h, w)
        yn = ((ys - self.cy) / self.fy).expand(h, w)
        xu, yu = undistort_points(xn, yn, self.k, 200)
        return torch.stack([xu, yu, torch.ones_like(xu)],
                           dim=-1).to(torch.float32)

    # ---------------------------------------------------------- program
    def program(self, device):
        """(the program's Camera, its Undistorter) from the calibration as
        LSD-SLAM's file gives it: relative intrinsics, input size, crop,
        output size."""
        from lsd_slam_tpu_torch.camera.undistort import \
            make_opencv_undistorter
        w, h = self.raw
        rel = [self.fx / w, self.fy / h, (self.cx + 0.5) / w,
               (self.cy + 0.5) / h, *self.k]
        und = make_opencv_undistorter(rel, self.raw, "crop", self.out,
                                      device=device)
        return und.camera, und

    # ---------------------------------------------------------- reference
    def _reference_tables(self):
        in_w, in_h = self.raw
        out_w, out_h = self.out
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        bx = np.concatenate([
            np.linspace(0, in_w - 1, 256), np.linspace(0, in_w - 1, 256),
            np.zeros(256), np.full(256, in_w - 1.0)])
        by = np.concatenate([
            np.zeros(256), np.full(256, in_h - 1.0),
            np.linspace(0, in_h - 1, 256), np.linspace(0, in_h - 1, 256)])
        xu, yu = undistort_points((bx - cx) / fx, (by - cy) / fy, self.k, 20)
        left, right = np.max(xu[512:768]), np.min(xu[768:1024])
        top, bottom = np.max(yu[0:256]), np.min(yu[256:512])
        ofx = (out_w - 1) / (right - left)
        ofy = (out_h - 1) / (bottom - top)
        ocx, ocy = -left * ofx, -top * ofy
        gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                             np.arange(out_h, dtype=np.float64))
        xd, yd = distort((gx - ocx) / ofx, (gy - ocy) / ofy, *self.k)
        sx, sy = fx * xd + cx, fy * yd + cy
        invalid = ~((sx > 0) & (sy > 0) & (sx < in_w - 1) & (sy < in_h - 1))
        sx = np.where(invalid, -1.0, sx)
        sy = np.where(invalid, -1.0, sy)
        return (Pinhole(float(ofx), float(ofy), float(ocx), float(ocy),
                        out_w, out_h), sx, sy)

    def reference_undistort(self, raw: np.ndarray, dtype=torch.float64):
        """(image float64, valid) of one raw frame, bilinear through the
        reference's table, computed in `dtype` (float64; the control
        computes in bfloat16)."""
        valid = (self.map_x >= 0) & (self.map_y >= 0)
        rx = np.where(valid, self.map_x, 0.0)
        ry = np.where(valid, self.map_y, 0.0)
        img = torch.as_tensor(np.asarray(raw, np.float64)).to(dtype)
        rx = torch.as_tensor(rx).to(dtype)
        ry = torch.as_tensor(ry).to(dtype)
        x0, y0 = torch.floor(rx), torch.floor(ry)
        wx, wy = rx - x0, ry - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        h, w = img.shape

        def at(yy, xx):
            return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

        v = (at(y0i, x0i) * (1 - wx) * (1 - wy)
             + at(y0i, x0i + 1) * wx * (1 - wy)
             + at(y0i + 1, x0i) * (1 - wx) * wy
             + at(y0i + 1, x0i + 1) * wx * wy)
        v = torch.where(torch.as_tensor(valid), v, torch.zeros_like(v))
        return v.to(torch.float64).numpy(), valid
