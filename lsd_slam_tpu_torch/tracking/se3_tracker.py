"""SE(3) direct image alignment — the per-frame hot path (torch).

Port of lsd_slam_tpu/tracking/se3_tracker.py (SE3Tracker.cpp:280-487):
  * `_residual_pass`: warp the compacted points, one quad-packed row gather
    of [I, gx, gy], residuals, affine-lighting moments and the good/bad
    counts (calcResidualAndBuffers, SE3Tracker.cpp:885-1029);
  * `_weights_pass`: variance-weighted Huber weights
    (calcWeightsAndResidual, SE3Tracker.cpp:749-790);
  * `_normal_equations`: LGS6 as one (6,N)x(N,6) f32 matmul;
  * `_track_level`: the LM accept/reject loop (SE3Tracker.cpp:343-448),
    `lm.level` with the SE(3) schedule.

The JAX loop is a device `lax.while_loop`, so a whole track is one program
with one host transfer. The port keeps that contract on the card: a track
is four launches of the hand-written kernel `lm_level` (ops/lm_track.py)
and nothing else. The first inverts the initial pose, each ORs the
previous level's `diverged` into its own, and the last runs the final
pass and the track's tail after its loop and writes every output
(`track_fused`). Nothing is pulled until the caller reads `host_pack`
(`TrackResult.n_syncs` is 0). CPU tensors take `track_plain`: the level
loops on the plain loop (`lm.level_plain`, which checks "any lane
active" once per trial; those checks are what `n_syncs` counts there),
then `final_pass_plain` and the tail in torch ops, the kernel's plain
version. The 6x6 solve uses `solve_ex` without error checks, like
`jnp.linalg.solve`, which never raises.

Jacobian ordering is [tx ty tz rx ry rz] (the tangent [upsilon, omega]).

Masking: where the JAX code multiplies by `mask.astype(f32)`, XLA rewrites
the product into `select(mask, x, 0)`, so masked-out NaN/inf terms vanish
instead of poisoning a sum. The port writes those products as
`torch.where(mask, x, 0)` to keep the same semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.frames.pyramid import FramePyramid
from lsd_slam_tpu_torch.ops.interp import quad_sample
from lsd_slam_tpu_torch.tracking import lm
from lsd_slam_tpu_torch.tracking.reference import TrackingRef, PointSet


@dataclass
class TrackResult:
    """Everything SlamSystem needs from one track (SE3Tracker.h:65-110)."""

    ref_to_frame: torch.Tensor      # SE3 (7,)
    frame_to_ref: torch.Tensor      # SE3 (7,)
    diverged: torch.Tensor          # bool
    tracking_good: torch.Tensor     # bool
    last_residual: torch.Tensor
    point_usage: torch.Tensor
    good_count: torch.Tensor
    bad_count: torch.Tensor
    affine_a: torch.Tensor
    affine_b: torch.Tensor
    good_mask: torch.Tensor         # (H_min, W_min) bool, ref-pixel isGood
    initial_residual: torch.Tensor
    host_pack: torch.Tensor         # (23,) see HOST_PACK
    n_syncs: int = 0                # host syncs the LM loops made
    final_fused: bool = False       # the final pass ran inside `lm_level`


# host_pack layout (index -> field), identical to the JAX package
HOST_PACK = dict(ref_to_frame=slice(0, 7), frame_to_ref=slice(7, 14),
                 diverged=14, tracking_good=15, last_residual=16,
                 point_usage=17, good_count=18, bad_count=19,
                 affine_a=20, affine_b=21, initial_residual=22)


def _col(x):
    """A per-lane value (B,) as a column (B, 1) that broadcasts over the
    points; scalars and 0-d tensors pass through."""
    return x.unsqueeze(-1) if torch.is_tensor(x) and x.dim() > 0 else x


def _residual_pass(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                   cam: Camera, cfg: TrackerConfig):
    """One warp + gather + residual sweep (== calcResidualAndBuffers).

    Batched as `jax.vmap` of the JAX function: pose (..., 7) and the affine
    pair (...) may carry lanes, the point fields (..., N) and the quad
    layout ((H*W, 12) shared or (B, H*W, 12) per lane) broadcast against
    them; every sum reduces the last (point) axis."""
    h, w = cam.height, cam.width
    rot = lie.quat_to_matrix(pose[..., 0:4])
    t = pose[..., 4:7]
    r_ = [[rot[..., i, j, None] for j in range(3)] for i in range(3)]
    t_ = [t[..., i, None] for i in range(3)]

    xs = (pts.idx % w).to(torch.float32)
    ys = torch.div(pts.idx, w, rounding_mode="floor").to(torch.float32)
    safe_id = torch.where(pts.valid, pts.idp, torch.ones_like(pts.idp))
    z_ref = 1.0 / safe_id
    px = (xs - cam.cx) / cam.fx * z_ref
    py = (ys - cam.cy) / cam.fy * z_ref
    wx = r_[0][0] * px + r_[0][1] * py + r_[0][2] * z_ref + t_[0]
    wy = r_[1][0] * px + r_[1][1] * py + r_[1][2] * z_ref + t_[1]
    wz = r_[2][0] * px + r_[2][1] * py + r_[2][2] * z_ref + t_[2]

    safe_wz = torch.where(wz == 0, torch.full_like(wz, 1e-9), wz)
    u = wx / safe_wz * cam.fx + cam.cx
    v = wy / safe_wz * cam.fy + cam.cy
    in_img = (u > 1) & (v > 1) & (u < w - 2) & (v < h - 2) & pts.valid

    (i_new, gxn, gyn), _, _ = quad_sample(frame_quad, h, w, u, v)

    c1 = _col(aff_a) * pts.ival + _col(aff_b)
    r = c1 - i_new

    zero = torch.zeros_like(r)
    ar = torch.abs(r)
    wa = torch.where(in_img, torch.where(ar < 5.0, torch.ones_like(r),
                                         5.0 / torch.clamp_min(ar, 1e-6)),
                     zero)
    sxx = torch.sum(c1 * c1 * wa, dim=-1)
    syy = torch.sum(i_new * i_new * wa, dim=-1)
    sx = torch.sum(c1 * wa, dim=-1)
    sy = torch.sum(i_new * wa, dim=-1)
    sw = torch.sum(wa, dim=-1)
    var_c1 = torch.clamp_min(sxx - sx * sx / sw, 1e-6)
    var_c2 = torch.clamp_min(syy - sy * sy / sw, 1e-6)
    # composed (not replaced) affine update, as in the JAX package
    aff_a_inc = torch.sqrt(var_c2 / var_c1)
    aff_b_inc = (sy - aff_a_inc * sx) / sw
    aff_a_new = aff_a_inc * aff_a
    aff_b_new = aff_a_inc * aff_b + aff_b_inc

    good = (r * r / (cfg.max_diff_constant
                     + cfg.max_diff_grad_mult * (gxn * gxn + gyn * gyn))) < 1.0

    in_count = torch.sum(in_img.to(torch.float32), dim=-1)
    good_count = torch.sum(good & in_img, dim=-1)
    bad_count = torch.sum(~good & in_img, dim=-1)
    usage = torch.sum(torch.where(in_img, torch.clamp_max(
        z_ref / torch.where(in_img, safe_wz, torch.ones_like(safe_wz)), 1.0),
        zero), dim=-1)

    buffers = dict(
        px=wx, py=wy, pz=torch.where(in_img, wz, torch.ones_like(wz)),
        dx=cam.fx * gxn, dy=cam.fy * gyn, r=r,
        d=pts.idp, var=pts.ivr, mask=in_img,
    )
    stats = dict(
        in_count=in_count, good_count=good_count, bad_count=bad_count,
        usage=usage, aff_a_new=aff_a_new, aff_b_new=aff_b_new, good=good,
    )
    return buffers, stats


def _weights_pass(pose, buffers, cfg: TrackerConfig, sigma2: float):
    """Variance-weighted Huber weights (== calcWeightsAndResidual)."""
    t = pose[..., 4:7]
    t0, t1, t2 = t[..., 0, None], t[..., 1, None], t[..., 2, None]
    px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
    d = torch.where(buffers["mask"], buffers["d"], torch.ones_like(pz))
    r = buffers["r"]
    m = buffers["mask"].to(torch.float32)

    g0 = (t0 * pz - t2 * px) / (pz * pz * d)
    g1 = (t1 * pz - t2 * py) / (pz * pz * d)
    drpdd = buffers["dx"] * g0 + buffers["dy"] * g1
    s = cfg.var_weight * buffers["var"]
    w_p = 1.0 / (sigma2 + s * drpdd * drpdd)
    weighted_rp = torch.abs(r) * torch.sqrt(w_p)
    hd = cfg.huber_d / 2.0
    wh = torch.where(weighted_rp < hd, torch.ones_like(r),
                     hd / torch.clamp_min(weighted_rp, 1e-9))
    weight = torch.where(buffers["mask"], wh * w_p, torch.zeros_like(r))
    err_sum = torch.sum(weight * r * r, dim=-1)
    error = err_sum / torch.clamp_min(torch.sum(m, dim=-1), 1.0)
    return weight, error


def _normal_equations(buffers, weight):
    """LGS6 accumulate as a matmul (== calculateWarpUpdate + LGSX.h)."""
    px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
    gx, gy, r = buffers["dx"], buffers["dy"], buffers["r"]
    z = 1.0 / pz
    z2 = z * z
    j0 = z * gx
    j1 = z * gy
    j2 = -px * z2 * gx - py * z2 * gy
    j3 = -px * py * z2 * gx - (1.0 + py * py * z2) * gy
    j4 = (1.0 + px * px * z2) * gx + px * py * z2 * gy
    j5 = -py * z * gx + px * z * gy
    J = torch.stack([j0, j1, j2, j3, j4, j5], dim=-1)      # (..., N, 6)
    n = torch.clamp_min(torch.sum(buffers["mask"], dim=-1),
                        1).to(torch.float32)
    Jw = J * weight.unsqueeze(-1)
    JwT = Jw.transpose(-1, -2)
    A = (JwT @ J) / n[..., None, None]
    if r.dim() == 1:
        g = (JwT @ r) / n
    else:
        g = (JwT @ r.unsqueeze(-1)).squeeze(-1) / n[..., None]
    return A, g


def _track_level(pose, aff_a, aff_b, pts, frame_quad, cam, cfg: TrackerConfig,
                 max_its: int, sigma2: float, use_affine: bool):
    """Full LM minimization on one pyramid level (`lm.level`: the kernel on
    the card, the plain loop on the CPU). Returns (pose, aff_a, aff_b,
    last_err, diverged (device bool), host syncs, trials (device int32))."""
    out = lm.level(pose, aff_a, aff_b, pts, frame_quad, cam, cfg, sigma2,
                   lm.se3_schedule(cfg, max_its, use_affine))
    return (out.pose, out.aff_a, out.aff_b, out.last_err, out.diverged,
            out.n_syncs, out.trials)


def track(cam: Camera, cfg: TrackerConfig, sigma2: float, use_affine: bool,
          ref: TrackingRef, frame: FramePyramid,
          init_frame_to_ref: torch.Tensor,
          level_trials: Optional[list] = None) -> TrackResult:
    """The whole pyramidal track (== _track_impl of the JAX package):
    `track_fused` for CUDA tensors, `track_plain` for CPU ones. A list
    given as `level_trials` receives each level's LM trials (device
    int32), from max_level down."""
    if init_frame_to_ref.device.type == "cpu":
        return track_plain(cam, cfg, sigma2, use_affine, ref, frame,
                           init_frame_to_ref, level_trials)
    return track_fused(cam, cfg, sigma2, use_affine, ref, frame,
                       init_frame_to_ref, level_trials)


def track_fused(cam: Camera, cfg: TrackerConfig, sigma2: float,
                use_affine: bool, ref: TrackingRef, frame: FramePyramid,
                init_frame_to_ref: torch.Tensor,
                level_trials: Optional[list] = None) -> TrackResult:
    """The track as `lm_level` launches alone, one a level: the first
    inverts the initial pose and starts the affine pair at (1, 0), each
    ORs the previous level's flag into its `diverged`, the last runs the
    final pass and the tail and writes every output (csrc/lm_track.cu).
    Its fields are views of those outputs."""
    pose, aff_a, aff_b, diverged = init_frame_to_ref, None, None, None
    for lvl in range(cfg.max_level, cfg.min_level - 1, -1):
        out = lm.level(pose, aff_a, aff_b, ref.pts[lvl], frame.quad[lvl],
                       cam.level(lvl), cfg, sigma2,
                       lm.se3_schedule(cfg, cfg.max_iterations[lvl],
                                       use_affine),
                       invert=lvl == cfg.max_level, diverged=diverged,
                       final=lvl == cfg.min_level)
        pose, aff_a, aff_b, diverged = (out.pose, out.aff_a, out.aff_b,
                                        out.diverged)
        if level_trials is not None:
            level_trials.append(out.trials)
    fin = out.final
    pack = fin.pack
    return TrackResult(
        ref_to_frame=pack[HOST_PACK["ref_to_frame"]],
        frame_to_ref=pack[HOST_PACK["frame_to_ref"]],
        diverged=diverged,
        tracking_good=fin.tracking_good,
        last_residual=pack[HOST_PACK["last_residual"]],
        point_usage=pack[HOST_PACK["point_usage"]],
        good_count=fin.counts[1],
        bad_count=fin.counts[2],
        affine_a=aff_a,
        affine_b=aff_b,
        good_mask=fin.good_mask,
        initial_residual=pack[HOST_PACK["initial_residual"]],
        host_pack=pack,
        n_syncs=0,
        final_fused=True,
    )


def track_plain(cam: Camera, cfg: TrackerConfig, sigma2: float,
                use_affine: bool, ref: TrackingRef, frame: FramePyramid,
                init_frame_to_ref: torch.Tensor,
                level_trials: Optional[list] = None) -> TrackResult:
    """The track in torch ops around the level loops (`lm.level` per
    level, then `final_pass_plain` and the tail): the CPU's route and the
    plain version of `track_fused`."""
    dev = init_frame_to_ref.device
    pose = lie.se3_inverse(init_frame_to_ref)  # referenceToFrame
    aff_a = torch.ones((), dtype=torch.float32, device=dev)
    aff_b = torch.zeros((), dtype=torch.float32, device=dev)
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    syncs = 0

    for lvl in range(cfg.max_level, cfg.min_level - 1, -1):
        caml = cam.level(lvl)
        pose, aff_a, aff_b, _, div_l, n, trials = _track_level(
            pose, aff_a, aff_b, ref.pts[lvl], frame.quad[lvl], caml, cfg,
            cfg.max_iterations[lvl], sigma2, use_affine)
        diverged = diverged | div_l
        syncs += n
        if level_trials is not None:
            level_trials.append(trials)

    lvl = cfg.min_level
    caml = cam.level(lvl)
    pts = ref.pts[lvl]
    stats, final_err, good_flat = final_pass_plain(
        pose, aff_a, aff_b, pts, frame.quad[lvl], caml, cfg, sigma2)
    n_pix = caml.width * caml.height
    ref_num = torch.clamp_min(pts.n_valid, 1.0)
    good = stats["good_count"].to(torch.float32)
    bad = stats["bad_count"].to(torch.float32)
    tracking_good = (
        (good / n_pix > cfg.min_goodperall_pixel)
        & (good / torch.clamp_min(good + bad, 1.0)
           > cfg.min_goodpergoodbad_pixel)
    ) & ~diverged
    point_usage = stats["usage"] / ref_num

    pose = torch.where(diverged, lie.se3_identity(device=dev), pose)
    inv_pose = lie.se3_inverse(pose)
    initial_residual = final_err / torch.clamp_min(point_usage, 1e-6)
    host_pack = torch.cat([
        pose, inv_pose,
        torch.stack([diverged.to(torch.float32),
                     tracking_good.to(torch.float32),
                     final_err, point_usage, good, bad,
                     aff_a, aff_b, initial_residual])])
    return TrackResult(
        ref_to_frame=pose,
        frame_to_ref=inv_pose,
        diverged=diverged,
        tracking_good=tracking_good,
        last_residual=final_err,
        point_usage=point_usage,
        good_count=stats["good_count"],
        bad_count=stats["bad_count"],
        affine_a=aff_a,
        affine_b=aff_b,
        good_mask=good_flat.reshape(caml.height, caml.width),
        initial_residual=initial_residual,
        host_pack=host_pack,
        n_syncs=syncs,
    )


def final_pass_plain(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                     cam: Camera, cfg: TrackerConfig, sigma2: float):
    """The final stats and good-pixel grid at the min level
    (trackingWasGood + refPixelWasGood, SE3Tracker.cpp:475-484): one
    residual and weights pass at the loop's pose and affine pair. `cam` is
    the level's camera. Returns (the residual pass's stats, the final
    error, the flat (H*W,) good grid)."""
    buffers, stats = _residual_pass(pose, aff_a, aff_b, pts, frame_quad,
                                    cam, cfg)
    _, final_err = _weights_pass(pose, buffers, cfg, sigma2)
    # scatter the per-point good flags back to the level grid; pixels not in
    # the point set stay True; padding slots go to the dump slot n_pix
    n_pix = cam.width * cam.height
    good_vec = stats["good"] & buffers["mask"]
    sidx = torch.where(pts.valid, pts.idx, n_pix)
    good_flat = torch.ones(n_pix + 1, dtype=torch.bool, device=pose.device)
    good_flat[sidx] = good_vec
    return stats, final_err, good_flat[:n_pix]


class SE3Tracker:
    """Pyramidal tracker bound to one camera + config (SE3Tracker.cpp)."""

    def __init__(self, cam: Camera, cfg: TrackerConfig = TrackerConfig(),
                 sigma2: float = 16.0, use_affine: bool = True):
        self.cam = cam
        self.cfg = cfg
        self.sigma2 = float(sigma2)
        self.use_affine = bool(use_affine)

    def track(self, ref: TrackingRef, frame: FramePyramid,
              init_frame_to_ref: torch.Tensor,
              level_trials: Optional[list] = None) -> TrackResult:
        """Track `frame` against `ref`; returns poses both ways."""
        return track(self.cam, self.cfg, self.sigma2, self.use_affine, ref,
                     frame, init_frame_to_ref, level_trials)
