"""A scene of the benchmark's, built on the frozen generator (`scene.py`).

The scene is `scene.BenchScene`'s room (back, side and rear walls, floor,
ceiling, a slanted wall) and its three occluder panels, but every surface
carries a texture of its own, drawn in the surface's own plane
coordinates. `BenchScene` evaluates one 3-D wave field on every surface,
so a wave whose direction lies near a surface's normal is nearly constant
there and pushes its shading into saturation: with the texture drawn
from a seed, some seeds leave a wall with few pixels of usable gradient,
and the JAX engine and the port alike lose the track there (PERF.md). Here
every surface, for every seed, gets the same set of in-plane spatial
frequencies and amplitudes; the seed draws only their directions and
phases, so every seed gives the same kind of work. (Some seeds still
lose the track at [slam]'s pace, the JAX engine alike: PERF.md.)
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import scene


class RoomScene(scene.BenchScene):
    """BenchScene's geometry with an in-plane texture per surface: the
    room's planes first, then the panels."""

    def __init__(self, seed: int = 0, n_waves: int = 96,
                 min_freq: float = 0.8, max_freq: float = 120.0,
                 contrast: float = 45.0):
        super().__init__(seed=0)      # the geometry; its 3-D waves unused
        planes = self.normals.numpy().astype(np.float64)
        basis = [_plane_basis(n) for n in planes]
        basis += [np.stack([u, v]) for u, v in
                  zip(self.panel_u.numpy().astype(np.float64),
                      self.panel_v.numpy().astype(np.float64))]
        self.n_planes = len(planes)
        n_surf = len(basis)
        self.basis = torch.as_tensor(np.stack(basis), dtype=torch.float32)
        mags = np.geomspace(min_freq, max_freq, n_waves)
        amps = mags ** -0.3
        amps *= contrast / np.sqrt(np.sum(amps ** 2) / 2.0)
        rng = np.random.default_rng(seed)
        theta = rng.uniform(0.0, 2 * np.pi, (n_surf, n_waves))
        phase = rng.uniform(0.0, 2 * np.pi, (n_surf, n_waves))
        freq = mags[None, :, None] * np.stack([np.cos(theta),
                                               np.sin(theta)], axis=-1)
        self.freq2 = torch.as_tensor(freq, dtype=torch.float32)
        self.phase2 = torch.as_tensor(phase, dtype=torch.float32)
        self.amps2 = torch.as_tensor(amps, dtype=torch.float32)

    def texture(self, points, surface):
        """The texture value at world `points` (..., 3) lying on surfaces
        `surface` (..., int); 0 where `surface` is -1."""
        dev = points.device
        out = torch.zeros(points.shape[:-1], dtype=torch.float32,
                          device=dev)
        basis, freq = self.basis.to(dev), self.freq2.to(dev)
        phase, amps = self.phase2.to(dev), self.amps2.to(dev)
        for s in range(len(basis)):
            m = surface == s
            uv = points[m] @ basis[s].T
            out[m] = torch.sum(amps * torch.sin(uv @ freq[s].T + phase[s]),
                               dim=-1)
        return out


def _plane_basis(n: np.ndarray) -> np.ndarray:
    """(2, 3): two unit vectors spanning the plane of unit normal n."""
    ref = np.array([0.0, 1.0, 0.0])
    if abs(n @ ref) > 0.9:
        ref = np.array([1.0, 0.0, 0.0])
    u = np.cross(n, ref)
    u /= np.linalg.norm(u)
    return np.stack([u, np.cross(n, u)])


def render_room(room: RoomScene, camera, pose_w2c, device, dirs_cam=None):
    """(image (H, W) f32, depth (H, W) f32 camera z): `scene.render_bench`'s
    ray casting, with each pixel shaded by the texture of the surface it
    hits."""
    dev = torch.device(device)
    center, dirs = scene._rays(camera, pose_w2c, dev, dirs_cam)
    normals = room.normals.to(dev)
    ndir = dirs @ normals.T
    tb = (room.offsets.to(dev) - normals @ center) / torch.where(
        torch.abs(ndir) < 1e-8, torch.full_like(ndir, 1e-8), ndir)
    tb = torch.where(tb > 0.05, tb, torch.full_like(tb, float("inf")))
    t_bg, plane_id = torch.min(tb, dim=-1)

    pn, pc = room.panel_n.to(dev), room.panel_c.to(dev)
    ndp = dirs @ pn.T
    tp = (torch.sum(pc * pn, dim=-1) - pn @ center) / torch.where(
        torch.abs(ndp) < 1e-8, torch.full_like(ndp, 1e-8), ndp)
    rel = center + tp[..., None] * dirs[..., None, :] - pc
    uu = torch.sum(rel * room.panel_u.to(dev), dim=-1)
    vv = torch.sum(rel * room.panel_v.to(dev), dim=-1)
    inside = ((torch.abs(uu) < room.panel_hu.to(dev))
              & (torch.abs(vv) < room.panel_hv.to(dev)) & (tp > 0.05))
    tp = torch.where(inside, tp, torch.full_like(tp, float("inf")))
    t_panel, panel_id = torch.min(tp, dim=-1)

    use_panel = t_panel < t_bg
    depth = torch.where(use_panel, t_panel, t_bg)
    hit = torch.isfinite(depth)
    depth = torch.where(hit, depth, torch.zeros_like(depth))
    surface = torch.where(use_panel, room.n_planes + panel_id, plane_id)
    surface = torch.where(hit, surface, torch.full_like(surface, -1))
    points = center + depth[..., None] * dirs
    img = room.shade(room.texture(points, surface))
    img = torch.where(depth > 0, img, torch.zeros_like(img))
    return img.to(torch.float32), depth.to(torch.float32)

