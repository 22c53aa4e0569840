"""Headless point-cloud renderer (numpy z-buffer splatting).

A numpy copy of lsd_slam_tpu/viewer/render.py; keyframe buffers are pulled
from the engine's device once per keyframe (`io.output.host_keyframe`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from lsd_slam_tpu_torch.io.output import host_keyframe
from lsd_slam_tpu_torch.lie import np_sim3 as nps


def collect_points(keyframes, cam, scaled_var_th: float = 0.02,
                   abs_var_th: float = 0.1, sparsify: int = 1):
    """World-frame points+colors with the viewer's filters
    (KeyFrameDisplay.cpp:149-222)."""
    pts, cols = [], []
    rng = np.random.default_rng(0)
    for kf in keyframes:
        idepth, var, color = host_keyframe(kf)
        valid = (var > 0) & (idepth > 0)
        c2w = kf.pose.cam_to_world()
        scale = c2w[7]
        depth = np.where(valid, 1.0 / np.maximum(idepth, 1e-9), 0.0)
        valid &= (var * depth ** 4 * scale ** 2 < scaled_var_th) \
            & (var < abs_var_th)
        ys, xs = np.nonzero(valid)
        if sparsify > 1 and len(ys):
            keep = rng.random(len(ys)) < 1.0 / sparsify
            ys, xs = ys[keep], xs[keep]
        if not len(ys):
            continue
        z = 1.0 / idepth[ys, xs]
        local = np.stack([(xs - cam.cx) / cam.fx * z,
                          (ys - cam.cy) / cam.fy * z, z], -1)
        rot = nps.quat_to_matrix(c2w[0:4])
        pts.append(scale * local @ rot.T + c2w[4:7])
        cols.append(color[ys, xs])
    if not pts:
        return np.zeros((0, 3)), np.zeros((0,))
    return np.concatenate(pts), np.concatenate(cols)


class MapRenderer:
    """Z-buffered splat renderer of a world point cloud."""

    def __init__(self, width: int = 960, height: int = 720,
                 focal: float = 700.0):
        self.w = width
        self.h = height
        self.f = focal

    def render(self, points: np.ndarray, colors: np.ndarray,
               view_w2c: np.ndarray, splat: int = 1) -> np.ndarray:
        """Render points under a world->camera Sim3/SE3 pose -> RGB u8."""
        img = np.zeros((self.h, self.w, 3), np.uint8)
        if len(points) == 0:
            return img
        view_w2c = np.asarray(view_w2c, np.float64)
        rot = nps.quat_to_matrix(view_w2c[0:4])
        s = view_w2c[7] if view_w2c.shape[-1] == 8 else 1.0
        p = s * points @ rot.T + view_w2c[4:7]
        z = p[:, 2]
        front = z > 0.05
        p, z = p[front], z[front]
        c = colors[front]
        u = (p[:, 0] / z * self.f + self.w / 2).astype(np.int32)
        v = (p[:, 1] / z * self.f + self.h / 2).astype(np.int32)
        inb = (u >= 0) & (u < self.w) & (v >= 0) & (v < self.h)
        u, v, z, c = u[inb], v[inb], z[inb], c[inb]
        # z-buffer via sort (far to near) so near points overwrite
        order = np.argsort(-z)
        u, v, c = u[order], v[order], c[order]
        ci = np.clip(c, 0, 255).astype(np.uint8)
        for dy in range(splat):
            for dx in range(splat):
                uu = np.clip(u + dx, 0, self.w - 1)
                vv = np.clip(v + dy, 0, self.h - 1)
                img[vv, uu, 0] = ci
                img[vv, uu, 1] = ci
                img[vv, uu, 2] = ci
        return img


def render_map_view(keyframes, cam, view_w2c=None, out_path: Optional[str] = None,
                    width: int = 960, height: int = 720):
    """One rendered view of the whole map; defaults to a pulled-back view
    behind the first keyframe."""
    pts, cols = collect_points(keyframes, cam)
    if view_w2c is None:
        view_w2c = np.array([1, 0, 0, 0, 0, 0, 1.5, 1.0])  # behind origin
    r = MapRenderer(width, height)
    img = r.render(pts, cols, view_w2c, splat=2)
    if out_path:
        from lsd_slam_tpu_torch.utils.debug_viz import save_png

        save_png(out_path, img)
    return img


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def animate_camera_path(keyframes, cam, out_dir: str, n_frames: int = 60,
                        width: int = 640, height: int = 480) -> int:
    """Interpolated fly-through along the keyframe trajectory, one PNG per
    frame (== the viewer's animation + saveAllVideo,
    PointCloudViewer.cpp:178-298). Returns frames written."""
    from lsd_slam_tpu_torch.utils.debug_viz import save_png

    if len(keyframes) < 2:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    pts, cols = collect_points(keyframes, cam)
    r = MapRenderer(width, height)
    anchors = [kf.pose.cam_to_world() for kf in keyframes]
    n_seg = len(anchors) - 1
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1) * n_seg
        seg = min(int(a), n_seg - 1)
        t = a - seg
        q = _slerp(anchors[seg][0:4], anchors[seg + 1][0:4], t)
        pos = (1 - t) * anchors[seg][4:7] + t * anchors[seg + 1][4:7]
        c2w = np.concatenate([q, pos, [1.0]])
        save_png(os.path.join(out_dir, f"anim_{i:04d}.png"),
                 r.render(pts, cols, nps.sim3_inverse(c2w)))
    return n_frames
