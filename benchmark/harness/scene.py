"""The benchmark's traffic generator: procedurally textured scenes rendered
along known trajectories, so every frame comes with its true pose and depth.

A frozen copy, so that a later change to the program cannot move the
yardstick. Copied at commit 30445d6 from
- `lsd_slam_tpu_torch/utils/synth.py`: `PlaneScene` (lines 27-73),
  `_rays` (76-89), `_background_t` (92-101), `BenchScene` (119-153),
  `render_bench` (156-186), `render_realistic` (189-236),
  `bench_trajectory` (257-284);
- `lsd_slam_tpu_torch/lie/groups.py`: `_cross`, `quat_normalize`,
  `quat_conj`, `quat_rotate`, `quat_to_matrix`, `hat`, `so3_exp`,
  `_w_matrix`, `se3_exp`, `se3_inverse` (lines 22-201), which the renderer
  and the trajectory use.
The code is unchanged but for three additions, each off by default, so
the defaults give the program's generator bit for bit
(`benchmark/tests/test_bench_scene.py`):
- `render_realistic(..., noise_seed=...)`: the base of the per-frame noise
  seed (the original's 1234), so each stream draws its own noise;
- `render_bench(..., dirs_cam=...)` and `render_realistic(...,
  dirs_cam=...)`: camera-frame ray directions per pixel in place of the
  pinhole's, so a distorting camera renders its raw (distorted) image;
- `render_realistic(..., render=...)`: the function that renders the
  clean image and depth in place of `render_bench` (`room.render_room`).
Poses are world->camera SE3 `[qw, qx, qy, qz, tx, ty, tz]`; depth is the
camera-frame z; intensities are in [0, 255]. Imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-6
_W_SERIES_TERMS = 16


# --------------------------------------------------------------- Lie ops

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_rotate(q, p):
    w = q[..., 0:1]
    v = q[..., 1:4]
    vxp = _cross(v, p)
    return p + 2.0 * (w * vxp + _cross(v, vxp))


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(omega):
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(
        small,
        0.5 - theta_sq / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(theta), theta),
    )
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * omega], dim=-1)


def _w_matrix(omega, sigma):
    batch = torch.broadcast_shapes(omega.shape[:-1], sigma.shape)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(
        batch + (3, 3))
    m = (sigma[..., None, None] * eye + hat(omega)).expand(batch + (3, 3))
    w = eye
    for k in range(_W_SERIES_TERMS, 0, -1):
        w = eye + torch.matmul(m, w) / float(k + 1)
    return w


def se3_exp(tangent):
    ups, omega = tangent[..., 0:3], tangent[..., 3:6]
    q = so3_exp(omega)
    wm = _w_matrix(omega, torch.zeros(omega.shape[:-1], dtype=omega.dtype,
                                      device=omega.device))
    t = torch.matmul(wm, ups.unsqueeze(-1)).squeeze(-1)
    return torch.cat([q, t], dim=-1)


def se3_inverse(g):
    q, t = g[..., 0:4], g[..., 4:7]
    qi = quat_conj(q)
    return torch.cat([qi, -quat_rotate(qi, t)], dim=-1)


# --------------------------------------------------------------- scenes

class PlaneScene:
    """A handful of textured planes n . p = d (world frame), drawn from
    `np.random.default_rng(seed)`."""

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
        dev = p.device
        phase = p @ self.freqs.to(dev).T + self.phases.to(dev)
        if phase_off is not None:
            phase = phase + phase_off[..., None]
        return torch.sum(self.amps.to(dev) * torch.sin(phase), dim=-1)

    def shade(self, t):
        return self.base + t


class BenchScene(PlaneScene):
    """PlaneScene plus side and rear walls and three bounded occluder
    panels, with a finer, denser texture and an edge-rich shading."""

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
        s = 24.0
        return self.base + 0.35 * t + 0.95 * s * torch.tanh(t * (2.5 / s))


def pinhole_dirs(fx, fy, cx, cy, width, height, dev):
    """Camera-frame ray directions (H, W, 3) of a pinhole camera."""
    ys = torch.arange(height, dtype=torch.float32,
                      device=dev)[:, None].expand(height, width)
    xs = torch.arange(width, dtype=torch.float32,
                      device=dev)[None, :].expand(height, width)
    dx = (xs - cx) / fx
    dy = (ys - cy) / fy
    return torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)


def _rays(camera, pose_w2c, dev, dirs_cam=None):
    """(camera centre (3,), world ray directions (H, W, 3)). `camera` has
    fx, fy, cx, cy, width, height."""
    pose = torch.as_tensor(np.asarray(pose_w2c, np.float32), device=dev)
    c2w = se3_inverse(pose)
    rot = quat_to_matrix(c2w[0:4])
    if dirs_cam is None:
        dirs_cam = pinhole_dirs(camera.fx, camera.fy, camera.cx, camera.cy,
                                camera.width, camera.height, dev)
    return c2w[4:7], dirs_cam @ rot.T


def _background_t(scene, center, dirs_world):
    normals = scene.normals.to(center.device)
    ndir = dirs_world @ normals.T
    t = (scene.offsets.to(center.device) - normals @ center) / torch.where(
        torch.abs(ndir) < 1e-8, torch.full_like(ndir, 1e-8), ndir)
    t = torch.where(t > 0.05, t, torch.full_like(t, float("inf")))
    return torch.amin(t, dim=-1)


def render_bench(scene: BenchScene, camera, pose_w2c, device,
                 dirs_cam=None):
    """(image (H, W) f32, depth (H, W) f32 camera z) of the bench scene:
    background planes + bounded occluder panels. `dirs_cam` (H, W, 3), if
    given, replaces the pinhole's rays (a distorting camera's raw image);
    the depth is then the camera z along those rays."""
    dev = torch.device(device)
    center, dirs_world = _rays(camera, pose_w2c, dev, dirs_cam)
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


def render_realistic(scene: BenchScene, camera, pose_w2c,
                     frame_index: int = 0, noise_sigma: float = 1.5,
                     device="cpu", noise_seed: int = 1234, dirs_cam=None,
                     render=None):
    """Render + camera realism, deterministic per frame_index: a 3x3
    binomial blur, a fixed radial vignette, per-frame gain and bias drift
    with a rolling gain component, and Gaussian sensor noise of
    `noise_sigma` gray levels from a torch.Generator on `device` seeded
    with noise_seed + frame_index."""
    dev = torch.device(device)
    img, depth = (render or render_bench)(scene, camera, pose_w2c, dev,
                                          dirs_cam)
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
        generator.manual_seed(int(noise_seed) + int(frame_index))
        out = out + float(noise_sigma) * torch.randn(
            img.shape, generator=generator, device=dev)
    out = torch.clamp(out, 0.0, 255.0)
    out = torch.where(depth > 0, out, torch.zeros_like(out))
    return out.to(torch.float32), depth


def bench_trajectory(n_frames: int, span: float = 1.8,
                     yaw_amp: float = 0.75, seed: int = 2) -> np.ndarray:
    """Out-and-back lap (n, 7) w2c: a lateral sweep of `span` metres with a
    yaw pan of `yaw_amp` radians and gentle bobbing, symmetric in time so
    the return leg revisits the outbound views, plus a small smooth jitter
    drawn from `np.random.default_rng(seed)`. The lap's shape does not
    depend on n_frames: more frames make a slower lap."""
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
        t = se3_exp(torch.tensor([0, 0, 0, pitch, yaw, roll],
                                 dtype=torch.float32)).numpy()
        c2w = np.concatenate([t[0:4], [x, y, z]]).astype(np.float32)
        poses.append(se3_inverse(torch.as_tensor(c2w)).numpy())
    return np.stack(poses)
