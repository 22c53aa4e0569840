"""SE(3) direct image alignment — the per-frame hot path (torch).

Port of lsd_slam_tpu/tracking/se3_tracker.py (SE3Tracker.cpp:280-487):
  * `_residual_pass`: warp the compacted points, one quad-packed row gather
    of [I, gx, gy], residuals, affine-lighting moments and the good/bad
    counts (calcResidualAndBuffers, SE3Tracker.cpp:885-1029);
  * `_weights_pass`: variance-weighted Huber weights
    (calcWeightsAndResidual, SE3Tracker.cpp:749-790);
  * `_normal_equations`: LGS6 as one (6,N)x(N,6) f32 matmul;
  * `_track_level`: the LM accept/reject loop (SE3Tracker.cpp:343-448).

The JAX loop is a device `lax.while_loop`. Here it is a host loop that
pulls four flags (accept, diverged, converged, step-too-small) once per
trial, so the lambda schedule and the loop counters live on the host in
f32 (numpy) and the state updates happen exactly while the JAX `cond`
holds. The syncs are counted (`TrackResult.n_syncs`); keeping the loop on
the device is later work. The 6x6 solve uses `solve_ex` without error
checks, like `jnp.linalg.solve`, which never raises.

Jacobian ordering is [tx ty tz rx ry rz] (the tangent [upsilon, omega]).

Masking: where the JAX code multiplies by `mask.astype(f32)`, XLA rewrites
the product into `select(mask, x, 0)`, so masked-out NaN/inf terms vanish
instead of poisoning a sum. The port writes those products as
`torch.where(mask, x, 0)` to keep the same semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.frames.pyramid import FramePyramid
from lsd_slam_tpu_torch.ops.interp import quad_sample
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


# host_pack layout (index -> field), identical to the JAX package
HOST_PACK = dict(ref_to_frame=slice(0, 7), frame_to_ref=slice(7, 14),
                 diverged=14, tracking_good=15, last_residual=16,
                 point_usage=17, good_count=18, bad_count=19,
                 affine_a=20, affine_b=21, initial_residual=22)


def _residual_pass(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                   cam: Camera, cfg: TrackerConfig):
    """One warp + gather + residual sweep (== calcResidualAndBuffers)."""
    h, w = cam.height, cam.width
    rot = lie.quat_to_matrix(pose[0:4])
    t = pose[4:7]

    xs = (pts.idx % w).to(torch.float32)
    ys = torch.div(pts.idx, w, rounding_mode="floor").to(torch.float32)
    safe_id = torch.where(pts.valid, pts.idp, torch.ones_like(pts.idp))
    z_ref = 1.0 / safe_id
    px = (xs - cam.cx) / cam.fx * z_ref
    py = (ys - cam.cy) / cam.fy * z_ref
    wx = rot[0, 0] * px + rot[0, 1] * py + rot[0, 2] * z_ref + t[0]
    wy = rot[1, 0] * px + rot[1, 1] * py + rot[1, 2] * z_ref + t[1]
    wz = rot[2, 0] * px + rot[2, 1] * py + rot[2, 2] * z_ref + t[2]

    safe_wz = torch.where(wz == 0, torch.full_like(wz, 1e-9), wz)
    u = wx / safe_wz * cam.fx + cam.cx
    v = wy / safe_wz * cam.fy + cam.cy
    in_img = (u > 1) & (v > 1) & (u < w - 2) & (v < h - 2) & pts.valid

    (i_new, gxn, gyn), _, _ = quad_sample(frame_quad, h, w, u, v)

    c1 = aff_a * pts.ival + aff_b
    r = c1 - i_new

    m = in_img.to(torch.float32)
    zero = torch.zeros_like(r)
    ar = torch.abs(r)
    wa = torch.where(in_img, torch.where(ar < 5.0, torch.ones_like(r),
                                         5.0 / torch.clamp_min(ar, 1e-6)),
                     zero)
    sxx = torch.sum(c1 * c1 * wa)
    syy = torch.sum(i_new * i_new * wa)
    sx = torch.sum(c1 * wa)
    sy = torch.sum(i_new * wa)
    sw = torch.sum(wa)
    var_c1 = torch.clamp_min(sxx - sx * sx / sw, 1e-6)
    var_c2 = torch.clamp_min(syy - sy * sy / sw, 1e-6)
    # composed (not replaced) affine update, as in the JAX package
    aff_a_inc = torch.sqrt(var_c2 / var_c1)
    aff_b_inc = (sy - aff_a_inc * sx) / sw
    aff_a_new = aff_a_inc * aff_a
    aff_b_new = aff_a_inc * aff_b + aff_b_inc

    good = (r * r / (cfg.max_diff_constant
                     + cfg.max_diff_grad_mult * (gxn * gxn + gyn * gyn))) < 1.0

    in_count = torch.sum(m)
    good_count = torch.sum(good & in_img)
    bad_count = torch.sum(~good & in_img)
    usage = torch.sum(torch.where(in_img, torch.clamp_max(
        z_ref / torch.where(in_img, safe_wz, torch.ones_like(safe_wz)), 1.0),
        zero))

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
    t = pose[4:7]
    px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
    d = torch.where(buffers["mask"], buffers["d"], torch.ones_like(pz))
    r = buffers["r"]
    m = buffers["mask"].to(torch.float32)

    g0 = (t[0] * pz - t[2] * px) / (pz * pz * d)
    g1 = (t[1] * pz - t[2] * py) / (pz * pz * d)
    drpdd = buffers["dx"] * g0 + buffers["dy"] * g1
    s = cfg.var_weight * buffers["var"]
    w_p = 1.0 / (sigma2 + s * drpdd * drpdd)
    weighted_rp = torch.abs(r) * torch.sqrt(w_p)
    hd = cfg.huber_d / 2.0
    wh = torch.where(weighted_rp < hd, torch.ones_like(r),
                     hd / torch.clamp_min(weighted_rp, 1e-9))
    weight = torch.where(buffers["mask"], wh * w_p, torch.zeros_like(r))
    err_sum = torch.sum(weight * r * r)
    error = err_sum / torch.clamp_min(torch.sum(m), 1.0)
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
    J = torch.stack([j0, j1, j2, j3, j4, j5], dim=-1).reshape(-1, 6)
    wv = weight.reshape(-1, 1)
    n = torch.clamp_min(torch.sum(buffers["mask"]), 1).to(torch.float32)
    Jw = J * wv
    A = (Jw.T @ J) / n
    g = (Jw.T @ r.reshape(-1)) / n
    return A, g


def _track_level(pose, aff_a, aff_b, pts, frame_quad, cam, cfg: TrackerConfig,
                 max_its: int, sigma2: float, use_affine: bool):
    """Full LM minimization on one pyramid level. Returns (pose, aff_a,
    aff_b, last_err, diverged (host bool), host syncs)."""
    h, w = cam.height, cam.width
    min_points = cfg.min_goodperall_pixel_absmin * h * w
    eye6 = 1e-12 * torch.eye(6, dtype=torch.float32, device=pose.device)

    def res(pose, a, b):
        return _residual_pass(pose, a, b, pts, frame_quad, cam, cfg)

    buffers, stats = res(pose, aff_a, aff_b)
    diverged0 = stats["in_count"] < min_points
    if use_affine:
        aff_a, aff_b = stats["aff_a_new"], stats["aff_b_new"]
    weight, last_err = _weights_pass(pose, buffers, cfg, sigma2)
    A, g = _normal_equations(buffers, weight)

    done = diverged = bool(diverged0)
    syncs = 1
    lam = np.float32(cfg.lambda_initial)
    it = inc_try = trials = 0
    max_trials = max_its + 4 * cfg.max_lm_rejects
    f32 = np.float32
    while it < max_its and not done and trials < max_trials:
        # LM damping: A_ii *= (1 + lambda), off-diagonals untouched
        Ad = A + float(lam) * torch.diag(torch.diag(A))
        inc = torch.linalg.solve_ex(Ad + eye6, g.unsqueeze(-1),
                                    check_errors=False)[0].squeeze(-1)
        new_pose = lie.se3_mul(lie.se3_exp(inc), pose)

        buffers, stats = res(new_pose, aff_a, aff_b)
        div_d = stats["in_count"] < min_points
        weight, err = _weights_pass(new_pose, buffers, cfg, sigma2)
        A_new, g_new = _normal_equations(buffers, weight)

        accept_d = (err < last_err) & ~div_d
        conv_d = err / torch.clamp_min(last_err, 1e-12) > cfg.convergence_eps
        small_d = torch.sum(inc * inc) < cfg.step_size_min
        accept, div, converged, step_too_small = (
            bool(x) for x in torch.stack(
                [accept_d, div_d, conv_d, small_d]).tolist())
        syncs += 1

        # lambda schedule (SE3Tracker.cpp:418-447), f32 like the JAX loop
        if accept:
            lam = f32(0.0) if lam <= f32(0.2) \
                else f32(lam * f32(cfg.lambda_success_fac))
            pose = new_pose
            if use_affine:
                aff_a, aff_b = stats["aff_a_new"], stats["aff_b_new"]
            A, g, last_err = A_new, g_new, err
            it += 1
            inc_try = 0
        else:
            lam = f32(0.2) if lam == f32(0.0) else f32(
                lam * f32(cfg.lambda_fail_fac) ** f32(inc_try + 1))
            inc_try += 1
        trials += 1
        done = (done or div or (accept and converged)
                or (not accept and step_too_small))
        diverged = diverged or div
    return pose, aff_a, aff_b, last_err, diverged, syncs


def track(cam: Camera, cfg: TrackerConfig, sigma2: float, use_affine: bool,
          ref: TrackingRef, frame: FramePyramid,
          init_frame_to_ref: torch.Tensor) -> TrackResult:
    """The whole pyramidal track (== _track_impl of the JAX package)."""
    dev = init_frame_to_ref.device
    pose = lie.se3_inverse(init_frame_to_ref)  # referenceToFrame
    aff_a = torch.ones((), dtype=torch.float32, device=dev)
    aff_b = torch.zeros((), dtype=torch.float32, device=dev)
    diverged = False
    syncs = 0

    for lvl in range(cfg.max_level, cfg.min_level - 1, -1):
        caml = cam.level(lvl)
        pose, aff_a, aff_b, _, div_l, n = _track_level(
            pose, aff_a, aff_b, ref.pts[lvl], frame.quad[lvl], caml, cfg,
            cfg.max_iterations[lvl], sigma2, use_affine)
        diverged = diverged or div_l
        syncs += n

    # final stats & good-pixel mask at the min level (trackingWasGood +
    # refPixelWasGood, SE3Tracker.cpp:475-484)
    lvl = cfg.min_level
    caml = cam.level(lvl)
    pts = ref.pts[lvl]
    buffers, stats = _residual_pass(
        pose, aff_a, aff_b, pts, frame.quad[lvl], caml, cfg)
    _, final_err = _weights_pass(pose, buffers, cfg, sigma2)
    n_pix = caml.width * caml.height
    ref_num = torch.clamp_min(pts.n_valid, 1.0)
    good = stats["good_count"].to(torch.float32)
    bad = stats["bad_count"].to(torch.float32)
    tracking_good = (
        (good / n_pix > cfg.min_goodperall_pixel)
        & (good / torch.clamp_min(good + bad, 1.0)
           > cfg.min_goodpergoodbad_pixel)
    ) & (not diverged)
    point_usage = stats["usage"] / ref_num

    # scatter the per-point good flags back to the level grid; pixels not in
    # the point set stay True; padding slots go to the dump slot n_pix
    good_vec = stats["good"] & buffers["mask"]
    sidx = torch.where(pts.valid, pts.idx, n_pix)
    good_flat = torch.ones(n_pix + 1, dtype=torch.bool, device=dev)
    good_flat[sidx] = good_vec
    good_flat = good_flat[:n_pix]

    if diverged:
        pose = lie.se3_identity(device=dev)
    inv_pose = lie.se3_inverse(pose)
    initial_residual = final_err / torch.clamp_min(point_usage, 1e-6)
    div_t = torch.tensor(diverged, device=dev)
    host_pack = torch.cat([
        pose, inv_pose,
        torch.stack([div_t.to(torch.float32),
                     tracking_good.to(torch.float32),
                     final_err, point_usage, good, bad,
                     aff_a, aff_b, initial_residual])])
    return TrackResult(
        ref_to_frame=pose,
        frame_to_ref=inv_pose,
        diverged=div_t,
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


class SE3Tracker:
    """Pyramidal tracker bound to one camera + config (SE3Tracker.cpp)."""

    def __init__(self, cam: Camera, cfg: TrackerConfig = TrackerConfig(),
                 sigma2: float = 16.0, use_affine: bool = True):
        self.cam = cam
        self.cfg = cfg
        self.sigma2 = float(sigma2)
        self.use_affine = bool(use_affine)

    def track(self, ref: TrackingRef, frame: FramePyramid,
              init_frame_to_ref: torch.Tensor) -> TrackResult:
        """Track `frame` against `ref`; returns poses both ways."""
        return track(self.cam, self.cfg, self.sigma2, self.use_affine, ref,
                     frame, init_frame_to_ref)
