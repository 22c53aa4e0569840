"""Analytic synthetic scenes (torch): the subset the VO smoke run needs.

The port of lsd_slam_tpu/utils/synth.py's `default_camera`, `PlaneScene`,
`render` and `orbit_trajectory`: a procedurally textured multi-plane
scene (band-limited sum of sinusoids, drawn from a numpy seed exactly as
the JAX package draws it) rendered along a known trajectory, so ground
truth depth and poses come for free. Poses are world->camera SE3; depth is
the camera-frame z; intensities are in [0, 255].
"""

from __future__ import annotations

import numpy as np
import torch

from lsd_slam_tpu_torch import lie, resolve_device
from lsd_slam_tpu_torch.camera import Camera


def default_camera(width: int = 640, height: int = 480) -> Camera:
    return Camera(fx=0.7 * width, fy=0.7 * width, cx=(width - 1) / 2.0,
                  cy=(height - 1) / 2.0, width=width, height=height)


class PlaneScene:
    """A handful of textured planes n . p = d (world frame); the numbers
    are drawn from `np.random.default_rng(seed)` in the JAX package's order
    and stored as f32 CPU tensors."""

    def __init__(self, seed: int = 0, n_waves: int = 64,
                 max_freq: float = 40.0, contrast: float = 40.0):
        rng = np.random.default_rng(seed)
        normals = np.array(
            [
                [0.0, 0.0, -1.0],
                [0.0, -1.0, -0.15],
                [0.0, 1.0, -0.15],
                [-0.55, 0.1, -1.0],
            ]
        )
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        offsets = np.array([-4.0, -1.6, -1.6, -2.6])
        self.normals = torch.as_tensor(normals, dtype=torch.float32)
        self.offsets = torch.as_tensor(offsets, dtype=torch.float32)
        dirs = rng.normal(size=(n_waves, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        mags = np.exp(rng.uniform(np.log(0.8), np.log(max_freq), n_waves))
        self.freqs = torch.as_tensor(dirs * mags[:, None], dtype=torch.float32)
        self.phases = torch.as_tensor(rng.uniform(0, 2 * np.pi, n_waves),
                                      dtype=torch.float32)
        amps = mags ** -0.3
        amps *= contrast / np.sqrt(np.sum(amps**2) / 2.0)
        self.amps = torch.as_tensor(amps, dtype=torch.float32)
        self.base = 120.0

    def texture(self, p):
        """Analytic intensity at world points p (..., 3)."""
        dev = p.device
        phase = p @ self.freqs.to(dev).T + self.phases.to(dev)
        return self.base + torch.sum(self.amps.to(dev) * torch.sin(phase),
                                     dim=-1)


def render(scene: PlaneScene, camera: Camera, pose_w2c, device=None):
    """Render (image (H,W) f32 in [0,255], depth (H,W) f32 camera z) at a
    world->camera pose (SE3 (7,)) on `device` (the CUDA device unless the
    caller names another)."""
    dev = resolve_device(device)
    h, w = camera.height, camera.width
    pose = torch.as_tensor(np.asarray(pose_w2c, np.float32), device=dev)
    c2w = lie.se3_inverse(pose)
    center = c2w[4:7]
    rot = lie.quat_to_matrix(c2w[0:4])

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    dx = (xs - camera.cx) / camera.fx
    dy = (ys - camera.cy) / camera.fy
    dirs_cam = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    dirs_world = dirs_cam @ rot.T

    normals = scene.normals.to(dev)
    ndir = dirs_world @ normals.T
    t = (scene.offsets.to(dev) - normals @ center) / torch.where(
        torch.abs(ndir) < 1e-8, torch.full_like(ndir, 1e-8), ndir)
    t = torch.where(t > 0.05, t, torch.full_like(t, float("inf")))
    depth = torch.amin(t, dim=-1)
    depth = torch.where(torch.isfinite(depth), depth,
                        torch.zeros_like(depth))

    points = center + depth[..., None] * dirs_world
    img = scene.texture(points)
    img = torch.where(depth > 0, img, torch.zeros_like(img))
    return img.to(torch.float32), depth.to(torch.float32)


def orbit_trajectory(n_frames: int, radius: float = 0.10,
                     fwd: float = 0.012, yaw: float = 0.0015) -> np.ndarray:
    """A smooth sideways-arc trajectory with small rotations (n, 7) w2c,
    computed with the f32 torch Lie ops on the CPU."""
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        cx = radius * np.sin(2 * np.pi * a * 0.75)
        cy = 0.3 * radius * np.sin(2 * np.pi * a * 1.5)
        cz = fwd * i
        yaw_i = yaw * i * 15
        pitch_i = 0.3 * yaw * i * 7
        t_c2w = np.array([cx, cy, cz])
        tangent = torch.tensor([0, 0, 0, pitch_i, yaw_i, 0.0],
                               dtype=torch.float32)
        q = lie.se3_exp(tangent)[0:4].numpy()
        c2w = np.concatenate([q, t_c2w]).astype(np.float32)
        poses.append(lie.se3_inverse(torch.as_tensor(c2w)).numpy())
    return np.stack(poses)
