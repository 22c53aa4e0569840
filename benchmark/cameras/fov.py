"""The FOV ("ATAN", PTAM) lens model, LSD-SLAM's own 5-parameter
calibration (relative fx fy cx cy and omega): the generator renders the
raw, distorted image along the model's rays; the program undistorts each
frame with its `Undistorter` (`camera/undistort.make_fov_undistorter`,
output "crop") before it tracks it; and the plain reference below works
out the output camera and the remap itself, in float64.

The model: a ray at angle theta from the optical axis, r_u = tan(theta)
in the normalised image plane, lands at the distorted radius
    r_d = atan(r_u * 2 tan(omega / 2)) / omega,
so r_u = tan(r_d * omega) / (2 tan(omega / 2)).

The reference's crop rule and remap are a frozen copy of
`lsd_slam_tpu_torch/camera/undistort.py` at commit 80f3ef0
(`_fov_undistort_radius`, lines 105-109; `make_fov_undistorter`'s
intrinsics, 126-133, crop branch, 148-162 (UndistorterPTAM,
Undistorter.cpp:201-228), and remap, 190-208 (Undistorter.cpp:288-314)),
and its bilinear gather keeps that file's border rule (`_remap_bilinear`,
72-89: y0 + 1 and x0 + 1 clipped to the last row and column), written out
again as in `cameras/radtan.py`. It imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.cameras.pinhole import Pinhole


def undistort_radius(r_d, omega: float):
    """r_u of a distorted radius r_d (float64)."""
    return np.tan(r_d * omega) / (2.0 * np.tan(omega / 2.0))


class Setup:
    undistorts = True

    def __init__(self, cam: dict):
        self.rel = tuple(float(cam[n])
                         for n in ("rfx", "rfy", "rcx", "rcy", "omega"))
        self.raw = (int(cam["width"]), int(cam["height"]))
        if cam.get("output", "crop") != "crop":
            raise ValueError("only LSD-SLAM's 'crop' output is modelled")
        self.out = (int(cam["out_width"]), int(cam["out_height"]))
        w, h = self.raw
        rfx, rfy, rcx, rcy, self.omega = self.rel
        # pixel centres at whole numbers
        self.fx, self.fy = rfx * w, rfy * h
        self.cx, self.cy = rcx * w - 0.5, rcy * h - 0.5
        self.pinhole, self.map_x, self.map_y = self._reference_tables()

    # ---------------------------------------------------------- generator
    def dirs_cam(self, device):
        """Ray directions (H, W, 3) f32 of the raw image's pixels, unit
        length, worked out in float64. A pixel past the model's 90 degrees
        (r_d * omega > pi / 2, the raw image's corners, which no output
        pixel of the crop reads) keeps its angle beyond 90 degrees."""
        w, h = self.raw
        dev = torch.device(device)
        ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
        xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
        xd = ((xs - self.cx) / self.fx).expand(h, w)
        yd = ((ys - self.cy) / self.fy).expand(h, w)
        r_d = torch.hypot(xd, yd)
        a = r_d * self.omega
        # theta = atan(r_u), continued past 90 degrees
        theta = torch.atan2(torch.sin(a), 2.0 * np.tan(self.omega / 2.0)
                            * torch.cos(a))
        safe = torch.where(r_d > 0, r_d, torch.ones_like(r_d))
        s = torch.sin(theta) / safe
        return torch.stack([xd * s, yd * s, torch.cos(theta)],
                           dim=-1).to(torch.float32)

    # ---------------------------------------------------------- program
    def program(self, device):
        """(the program's Camera, its Undistorter) from the calibration as
        LSD-SLAM's file gives it: relative intrinsics and omega, input
        size, crop, output size."""
        from lsd_slam_tpu_torch.camera.undistort import make_fov_undistorter
        und = make_fov_undistorter(list(self.rel), self.raw, "crop",
                                   self.out, device=device)
        return und.camera, und

    # ---------------------------------------------------------- reference
    def _reference_tables(self):
        in_w, in_h = self.raw
        out_w, out_h = self.out
        fx, fy, cx, cy, om = self.fx, self.fy, self.cx, self.cy, self.omega
        # crop: the input's edges, on the axes through the principal point,
        # land on the output's edges
        left, right = cx / fx, (in_w - 1 - cx) / fx
        top, bottom = cy / fy, (in_h - 1 - cy) / fy
        tl, tr, tt, tb = (undistort_radius(r, om)
                          for r in (left, right, top, bottom))
        ofy = fy * ((top + bottom) / (tt + tb)) * (out_h / in_h)
        ocy = (tt / top) * ofy * cy / fy
        ofx = fx * ((left + right) / (tl + tr)) * (out_w / in_w)
        ocx = (tl / left) * ofx * cx / fx
        # each output pixel's source through the forward model
        gx, gy = np.meshgrid(np.arange(out_w, dtype=np.float64),
                             np.arange(out_h, dtype=np.float64))
        ix, iy = (gx - ocx) / ofx, (gy - ocy) / ofy
        r = np.hypot(ix, iy)
        d2t = 2.0 * np.tan(om / 2.0)
        fac = np.arctan(r * d2t) / (om * np.where(r > 0, r, 1.0))
        fac = np.where(r > 0, fac, 1.0)
        sx, sy = fx * fac * ix + cx, fy * fac * iy + cy
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
