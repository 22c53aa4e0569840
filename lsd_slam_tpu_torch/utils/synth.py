"""Analytic synthetic scenes (torch).

The port of lsd_slam_tpu/utils/synth.py's `default_camera`, `PlaneScene`,
`render`, `orbit_trajectory`, `loop_trajectory`, `BenchScene`,
`render_bench`, `render_realistic`, `bench_trajectory` and
`make_sequence`: procedurally textured multi-plane scenes (band-limited
sums of sinusoids, drawn from a numpy seed exactly as the JAX package
draws them) rendered along known trajectories, so ground-truth depth and
poses come for free. Poses are
world->camera SE3; depth is the camera-frame z; intensities are in
[0, 255].
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

    def wave(self, p, phase_off=None):
        """Raw band-limited wave sum at world points p (..., 3), each point
        optionally phase-shifted by phase_off (...)."""
        dev = p.device
        phase = p @ self.freqs.to(dev).T + self.phases.to(dev)
        if phase_off is not None:
            phase = phase + phase_off[..., None]
        return torch.sum(self.amps.to(dev) * torch.sin(phase), dim=-1)

    def shade(self, t):
        """Map the raw wave to intensity."""
        return self.base + t

    def texture(self, p):
        """Analytic intensity at world points p (..., 3)."""
        return self.shade(self.wave(p))


def _rays(camera: Camera, pose_w2c, dev):
    """(camera centre (3,), world ray directions (H, W, 3)) of a
    world->camera pose."""
    h, w = camera.height, camera.width
    pose = torch.as_tensor(np.asarray(pose_w2c, np.float32), device=dev)
    c2w = lie.se3_inverse(pose)
    rot = lie.quat_to_matrix(c2w[0:4])
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    dx = (xs - camera.cx) / camera.fx
    dy = (ys - camera.cy) / camera.fy
    dirs_cam = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    return c2w[4:7], dirs_cam @ rot.T


def _background_t(scene: PlaneScene, center, dirs_world):
    """Ray parameter of the nearest background plane (inf where none)."""
    normals = scene.normals.to(center.device)
    ndir = dirs_world @ normals.T
    t = (scene.offsets.to(center.device) - normals @ center) / torch.where(
        torch.abs(ndir) < 1e-8, torch.full_like(ndir, 1e-8), ndir)
    t = torch.where(t > 0.05, t, torch.full_like(t, float("inf")))
    return torch.amin(t, dim=-1)


def render(scene: PlaneScene, camera: Camera, pose_w2c, device=None):
    """Render (image (H,W) f32 in [0,255], depth (H,W) f32 camera z) at a
    world->camera pose (SE3 (7,)) on `device` (the CUDA device unless the
    caller names another)."""
    dev = resolve_device(device)
    center, dirs_world = _rays(camera, pose_w2c, dev)
    depth = _background_t(scene, center, dirs_world)
    depth = torch.where(torch.isfinite(depth), depth,
                        torch.zeros_like(depth))

    points = center + depth[..., None] * dirs_world
    img = scene.texture(points)
    img = torch.where(depth > 0, img, torch.zeros_like(img))
    return img.to(torch.float32), depth.to(torch.float32)


class BenchScene(PlaneScene):
    """PlaneScene plus side and rear walls and three bounded occluder
    panels, with a finer, denser texture and an edge-rich shading (the JAX
    package's bench scene, drawn from the same seed in the same order)."""

    def __init__(self, seed: int = 0, **kw):
        kw.setdefault("n_waves", 96)
        kw.setdefault("max_freq", 120.0)
        kw.setdefault("contrast", 45.0)
        super().__init__(seed=seed, **kw)
        f32 = torch.float32
        extra_n = torch.tensor([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                [0.0, 0.0, 1.0]], dtype=f32)
        extra_d = torch.tensor([-3.2, -3.2, -2.5], dtype=f32)
        self.normals = torch.cat([self.normals, extra_n])
        self.offsets = torch.cat([self.offsets, extra_d])
        self.panel_c = torch.tensor([[-0.9, 0.15, 2.2], [0.95, -0.25, 2.7],
                                     [0.1, 0.45, 1.8]], dtype=f32)
        n = np.array([[0.25, 0.0, -1.0], [-0.2, 0.1, -1.0],
                      [0.05, -0.3, -1.0]])
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        self.panel_n = torch.as_tensor(n, dtype=f32)
        up = np.array([0.0, 1.0, 0.0])
        u = np.cross(n, up)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        v = np.cross(n, u)
        self.panel_u = torch.as_tensor(u, dtype=f32)
        self.panel_v = torch.as_tensor(v, dtype=f32)
        self.panel_hu = torch.tensor([0.45, 0.4, 0.35], dtype=f32)
        self.panel_hv = torch.tensor([0.6, 0.5, 0.3], dtype=f32)
        self.panel_phase = torch.tensor([1.7, 3.1, 4.6], dtype=f32)

    def shade(self, t):
        """Soft-threshold shading: plateaus separated by sharp edges."""
        s = 24.0
        return self.base + 0.35 * t + 0.95 * s * torch.tanh(t * (2.5 / s))


def render_bench(scene: BenchScene, camera: Camera, pose_w2c, device=None):
    """Render BenchScene: background planes + bounded occluder panels."""
    dev = resolve_device(device)
    center, dirs_world = _rays(camera, pose_w2c, dev)
    t_bg = _background_t(scene, center, dirs_world)

    pn, pc = scene.panel_n.to(dev), scene.panel_c.to(dev)
    ndp = dirs_world @ pn.T
    dpl = torch.sum(pc * pn, dim=-1)
    tp = (dpl - pn @ center) / torch.where(
        torch.abs(ndp) < 1e-8, torch.full_like(ndp, 1e-8), ndp)
    hit = center + tp[..., None] * dirs_world[..., None, :]   # (H, W, P, 3)
    rel = hit - pc
    uu = torch.sum(rel * scene.panel_u.to(dev), dim=-1)
    vv = torch.sum(rel * scene.panel_v.to(dev), dim=-1)
    inside = ((torch.abs(uu) < scene.panel_hu.to(dev))
              & (torch.abs(vv) < scene.panel_hv.to(dev)) & (tp > 0.05))
    tp = torch.where(inside, tp, torch.full_like(tp, float("inf")))
    t_panel, panel_id = torch.min(tp, dim=-1)

    use_panel = t_panel < t_bg
    depth = torch.where(use_panel, t_panel, t_bg)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    points = center + depth[..., None] * dirs_world
    phase_off = torch.where(use_panel, scene.panel_phase.to(dev)[panel_id],
                            torch.zeros_like(depth))
    img = scene.shade(scene.wave(points, phase_off))
    img = torch.where(depth > 0, img, torch.zeros_like(img))
    return img.to(torch.float32), depth.to(torch.float32)


def render_realistic(scene: PlaneScene, camera: Camera, pose_w2c,
                     frame_index: int = 0, noise_sigma: float = 1.5,
                     device=None):
    """Render + camera realism, deterministic per frame_index: a 3x3
    binomial blur, a fixed radial vignette (~12% at the corners), per-frame
    gain and bias drift with a rolling (top-to-bottom) gain component, and
    additive Gaussian sensor noise of `noise_sigma` gray levels. The noise
    comes from a torch.Generator on `device` seeded with 1234 + frame_index:
    it cannot reproduce the JAX package's `jax.random` stream, so parity
    runs use noise_sigma=0."""
    dev = resolve_device(device)
    if isinstance(scene, BenchScene):
        img, depth = render_bench(scene, camera, pose_w2c, device=dev)
    else:
        img, depth = render(scene, camera, pose_w2c, device=dev)
    h, w = img.shape
    i = float(np.float32(frame_index))
    k = (0.25, 0.5, 0.25)
    pad = torch.nn.functional.pad(img[None, None], (1, 1, 0, 0),
                                  mode="replicate")[0, 0]
    img = pad[:, :-2] * k[0] + img * k[1] + pad[:, 2:] * k[2]
    pad = torch.nn.functional.pad(img[None, None], (0, 0, 1, 1),
                                  mode="replicate")[0, 0]
    img = pad[:-2, :] * k[0] + img * k[1] + pad[2:, :] * k[2]
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) \
        / (h / 2)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) \
        / (w / 2)
    r2 = (ys[:, None] ** 2 + xs[None, :] ** 2) / 2.0
    vignette = 1.0 - 0.12 * r2
    f32 = np.float32
    gain = float(f32(1.0) + f32(0.06) * np.sin(f32(0.21) * f32(i))
                 + f32(0.02) * np.sin(f32(0.047) * f32(i)))
    rolling = 1.0 + float(f32(0.01) * np.sin(f32(0.21) * f32(i) + f32(0.9))) \
        * (ys[:, None] * torch.ones((1, w), device=dev))
    bias = float(f32(3.0) * np.sin(f32(0.13) * f32(i)))
    out = gain * rolling * vignette * img + bias
    if noise_sigma:
        generator = torch.Generator(device=dev)
        generator.manual_seed(1234 + int(frame_index))
        out = out + float(noise_sigma) * torch.randn(
            img.shape, generator=generator, device=dev)
    out = torch.clamp(out, 0.0, 255.0)
    out = torch.where(depth > 0, out, torch.zeros_like(out))
    return out.to(torch.float32), depth


def loop_trajectory(n_frames: int, span: float = 0.55,
                    yaw_amp: float = 0.06) -> np.ndarray:
    """Out-and-back loop-closing trajectory (n, 7) w2c: the camera slides
    right and returns, so late frames revisit early views."""
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        x = span * np.sin(np.pi * a)
        yaw = yaw_amp * np.sin(2 * np.pi * a)
        t = lie.se3_exp(torch.tensor([0, 0, 0, 0, yaw, 0],
                                     dtype=torch.float32)).numpy()
        c2w = np.concatenate(
            [t[0:4], [x, 0.0, 0.015 * np.sin(np.pi * a)]]).astype(np.float32)
        poses.append(lie.se3_inverse(torch.as_tensor(c2w)).numpy())
    return np.stack(poses)


def bench_trajectory(n_frames: int, span: float = 1.8,
                     yaw_amp: float = 0.75, seed: int = 2) -> np.ndarray:
    """Reference-scale out-and-back loop (n, 7) w2c: a wide lateral sweep
    with a +-~25 deg yaw pan and gentle bobbing, symmetric in time so the
    return leg revisits the outbound views, plus a small smooth jitter
    drawn from `np.random.default_rng(seed)` as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    n_j = 6
    jf = rng.uniform(2.0, 9.0, (n_j, 3))
    jp = rng.uniform(0, 2 * np.pi, (n_j, 3))
    ja = rng.uniform(0.002, 0.008, (n_j, 3)) / np.arange(1, n_j + 1)[:, None]
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        sa = np.sin(np.pi * a)
        jitter = np.sum(ja * np.sin(jf * a * 2 * np.pi + jp), axis=0)
        x = span * sa
        z = 0.45 * sa * sa
        y = 0.05 * sa * sa + jitter[2] * 2.0
        yaw = yaw_amp * sa + jitter[0]
        pitch = 0.06 * sa + jitter[1]
        roll = 0.04 * sa * jitter[2] * 10.0
        t = lie.se3_exp(torch.tensor([0, 0, 0, pitch, yaw, roll],
                                     dtype=torch.float32)).numpy()
        c2w = np.concatenate([t[0:4], [x, y, z]]).astype(np.float32)
        poses.append(lie.se3_inverse(torch.as_tensor(c2w)).numpy())
    return np.stack(poses)


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


def make_sequence(n_frames: int = 30, width: int = 320, height: int = 240,
                  seed: int = 0, device=None):
    """Convenience: (camera, images (n, h, w), depths (n, h, w), poses_w2c
    (n, 7)); images and depths are stacked tensors on `device` (the CUDA
    device unless the caller names another), poses a numpy array."""
    dev = resolve_device(device)
    cam = default_camera(width, height)
    scene = PlaneScene(seed=seed)
    poses = orbit_trajectory(n_frames)
    imgs, deps = [], []
    for i in range(n_frames):
        img, dep = render(scene, cam, poses[i], device=dev)
        imgs.append(img)
        deps.append(dep)
    return cam, torch.stack(imgs), torch.stack(deps), poses
