"""Sim(3) direct alignment between two keyframes with depth (torch).

Port of lsd_slam_tpu/tracking/sim3_tracker.py (Sim3Tracker.{h,cpp}): the
photometric residual of the SE3 tracker plus an inverse-depth residual
r_d = 1/z_warped - idepth_target at the rounded target pixel
(Sim3Tracker.cpp:527-541, read from the same quad gather through
`quad_nearest`); ESM gradient averaging with roll-compensated source
gradients (Sim3Tracker.cpp:451-507); a coupled Huber weight over
|r_d| sqrt(w_d) + |r_p| sqrt(w_p) (Sim3Tracker.cpp:779-804); LGS7 =
LGS6(photo) + LGS4(depth, dims {2,3,4,6}); LM over Sim3::exp; the 7x7
Hessian at the converged pose as the constraint's information matrix.

Every entry runs the batched loop, one lane per candidate, a level at a
time through `levels`, for one lane set or two (a constraint stage's two
directions, `Sim3Tracker.track_pair_packed`): on the card the kernel
`sim3_level` (ops/lm_track.py, csrc/sim3_track.cu) runs every trial of a
level of every set in one launch and pulls nothing to the host, and the
last level's launch runs the final pass after its loop; on the CPU
`level_plain` and `final_pass_plain` run them in torch ops, set by set
(lanes that are done keep their state, one host read of "any lane active"
per trial, counted in `Sim3TrackResult.n_syncs`). Either side may be
stacked: reference point sets (B, N) against one target layout, or one
reference against stacked target layouts (B, H*W, 20). The packed entries
return one (B, 70) tensor per set in the `SIM3_PACK` layout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.ops.interp import quad_sample, quad_nearest
from lsd_slam_tpu_torch.tracking.lm import LevelResult
from lsd_slam_tpu_torch.tracking.reference import TrackingRef, PointSet
from lsd_slam_tpu_torch.tracking.se3_tracker import _col

_POINT_FIELDS = ("idx", "ival", "gx", "gy", "idp", "ivr", "valid")


@dataclass
class Sim3TrackResult:
    ref_to_frame: torch.Tensor   # Sim3 (..., 8)
    frame_to_ref: torch.Tensor   # Sim3 (..., 8)
    diverged: torch.Tensor       # bool
    last_residual: torch.Tensor  # coupled mean residual
    depth_residual: torch.Tensor
    photo_residual: torch.Tensor
    point_usage: torch.Tensor
    hessian: torch.Tensor        # (..., 7, 7) undivided LGS7 A
    n_syncs: int = 0


# flat layout of one lane of the packed batched output (identical to the
# JAX package's SIM3_PACK)
SIM3_PACK = dict(ref_to_frame=slice(0, 8), frame_to_ref=slice(8, 16),
                 diverged=16, last_residual=17, depth_residual=18,
                 photo_residual=19, point_usage=20,
                 hessian=slice(21, 70))
SIM3_PACK_LEN = 70


def _roll_matrix(rot_unscaled):
    """Rotation aligning the rotated optical axis back to -z, times R
    (Sim3Tracker.cpp:451-462). rot_unscaled (..., 3, 3)."""
    fwd = rot_unscaled.new_tensor([0.0, 0.0, -1.0])
    rf = torch.matmul(rot_unscaled, fwd)
    d = torch.sum(rf * fwd, dim=-1, keepdim=True)
    axis = torch.linalg.cross(rf, fwd.expand_as(rf), dim=-1)
    q = torch.cat([1.0 + d, axis], dim=-1)
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True), 1e-9)
    return torch.matmul(lie.quat_to_matrix(q), rot_unscaled)


def _sim3_residual_pass(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                        cam: Camera, cfg: TrackerConfig, use_esm: bool):
    """One Sim3 warp + one quad row gather of the (H*W, 20) sim3 layout:
    the photometric sample and the rounded-pixel depth lookup ride the
    same gather. pose (..., 8); point fields and layouts broadcast as in
    the SE3 `_residual_pass`; sums reduce the last axis."""
    h, w = cam.height, cam.width
    s = pose[..., 7, None, None]
    rot_unscaled = lie.quat_to_matrix(pose[..., 0:4])
    rot = rot_unscaled * s
    t = pose[..., 4:7]
    r_ = [[rot[..., i, j, None] for j in range(3)] for i in range(3)]

    xs = (pts.idx % w).to(torch.float32)
    ys = torch.div(pts.idx, w, rounding_mode="floor").to(torch.float32)
    safe_id = torch.where(pts.valid, pts.idp, torch.ones_like(pts.idp))
    z_ref = 1.0 / safe_id
    px = (xs - cam.cx) / cam.fx * z_ref
    py = (ys - cam.cy) / cam.fy * z_ref

    wx = r_[0][0] * px + r_[0][1] * py + r_[0][2] * z_ref + t[..., 0, None]
    wy = r_[1][0] * px + r_[1][1] * py + r_[1][2] * z_ref + t[..., 1, None]
    wz = r_[2][0] * px + r_[2][1] * py + r_[2][2] * z_ref + t[..., 2, None]

    safe_wz = torch.where(wz == 0, torch.full_like(wz, 1e-9), wz)
    u = wx / safe_wz * cam.fx + cam.cx
    v = wy / safe_wz * cam.fy + cam.cy
    in_img = (u > 1) & (v > 1) & (u < w - 2) & (v < h - 2) & pts.valid

    (i_new, gxn, gyn, _, _), raw, (fu, fv) = quad_sample(frame_quad, h, w,
                                                         u, v)
    if use_esm:
        rollm = _roll_matrix(rot_unscaled)
        rgx = rollm[..., 0, 0, None] * pts.gx + rollm[..., 0, 1, None] * pts.gy
        rgy = rollm[..., 1, 0, None] * pts.gx + rollm[..., 1, 1, None] * pts.gy
        dx = cam.fx * 0.5 * (gxn + rgx)
        dy = cam.fy * 0.5 * (gyn + rgy)
    else:
        dx = cam.fx * gxn
        dy = cam.fy * gyn

    c1 = _col(aff_a) * pts.ival + _col(aff_b)
    rp = c1 - i_new

    zero = torch.zeros_like(rp)
    arp = torch.abs(rp)
    # affine moments: the weight kink is at 2.0, not 5.0 as in SE3
    # (Sim3Tracker.cpp:517-523)
    wa = torch.where(in_img, torch.where(arp < 2.0, torch.ones_like(rp),
                                         2.0 / torch.clamp_min(arp, 1e-6)),
                     zero)
    sxx = torch.sum(c1 * c1 * wa, dim=-1)
    syy = torch.sum(i_new * i_new * wa, dim=-1)
    sx = torch.sum(c1 * wa, dim=-1)
    sy = torch.sum(i_new * wa, dim=-1)
    sw = torch.clamp_min(torch.sum(wa, dim=-1), 1e-6)
    var_c1 = torch.clamp_min(sxx - sx * sx / sw, 1e-6)
    var_c2 = torch.clamp_min(syy - sy * sy / sw, 1e-6)
    aff_a_inc = torch.sqrt(var_c2 / var_c1)
    aff_b_inc = (sy - aff_a_inc * sx) / sw
    aff_a_new = aff_a_inc * aff_a
    aff_b_new = aff_a_inc * aff_b + aff_b_inc

    f_id = quad_nearest(raw, 3, 5, fu, fv)
    f_var = quad_nearest(raw, 4, 5, fu, fv)
    has_depth = in_img & (f_var > 0)
    rd = torch.where(has_depth, 1.0 / safe_wz - f_id, zero)

    usage = torch.sum(torch.where(in_img, torch.clamp_max(
        z_ref / torch.where(in_img, safe_wz, torch.ones_like(safe_wz)), 1.0),
        zero), dim=-1)

    buffers = dict(px=wx, py=wy, pz=torch.where(in_img, wz,
                                                torch.ones_like(wz)),
                   dx=dx, dy=dy, rp=rp, rd=rd, d=pts.idp, var=pts.ivr,
                   fvar=f_var, mask=in_img, has_depth=has_depth)
    stats = dict(in_count=torch.sum(in_img.to(torch.float32), dim=-1),
                 usage=usage, aff_a_new=aff_a_new, aff_b_new=aff_b_new)
    return buffers, stats


def _sim3_weights(pose, buffers, cfg: TrackerConfig, sigma2: float):
    """Coupled Huber weights (calcSim3WeightsAndResidual,
    Sim3Tracker.cpp:749-840). Returns (weight_p, weight_d, mean, mean_d,
    mean_p)."""
    t = pose[..., 4:7]
    t0, t1, t2 = t[..., 0, None], t[..., 1, None], t[..., 2, None]
    px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
    mask, has_depth = buffers["mask"], buffers["has_depth"]
    d = torch.where(mask, buffers["d"], torch.ones_like(pz))
    rp, rd = buffers["rp"], buffers["rd"]
    zero = torch.zeros_like(rp)

    g0 = (t0 * pz - t2 * px) / (pz * pz * d)
    g1 = (t1 * pz - t2 * py) / (pz * pz * d)
    g2 = (pz - t2) / (pz * pz * d)

    s = cfg.var_weight * buffers["var"]
    sv = cfg.var_weight * buffers["fvar"]
    drpdd = buffers["dx"] * g0 + buffers["dy"] * g1
    w_p = 1.0 / (sigma2 + s * drpdd * drpdd)
    w_d = 1.0 / torch.clamp_min(sv + g2 * g2 * s, 1e-12)

    wrd = torch.abs(rd) * torch.sqrt(w_d)
    wrp = torch.abs(rp) * torch.sqrt(w_p)
    w_abs = torch.where(has_depth, wrd + wrp, wrp)
    wh = torch.where(w_abs < cfg.huber_d, torch.ones_like(w_abs),
                     cfg.huber_d / torch.clamp_min(w_abs, 1e-9))

    weight_p = torch.where(mask, wh * w_p, zero)
    weight_d = torch.where(has_depth, wh * w_d, zero)

    sum_d = torch.sum(weight_d * rd * rd, dim=-1)
    sum_p = torch.sum(weight_p * rp * rp, dim=-1)
    n_d = torch.clamp_min(torch.sum(has_depth.to(torch.float32), dim=-1), 1.0)
    n_p = torch.clamp_min(torch.sum(mask.to(torch.float32), dim=-1), 1.0)
    mean = (sum_d + sum_p) / (n_d + n_p)
    return weight_p, weight_d, mean, sum_d / n_d, sum_p / n_p


_REMAP = (2, 3, 4, 6)


def _sim3_normal_equations(buffers, weight_p, weight_d):
    """LGS7 = LGS6(photo) + LGS4(depth at dims {2,3,4,6}). Returns the
    undivided (A (..., 7, 7), b (..., 7)) and the sample count n (...)."""
    px, py, pz = buffers["px"], buffers["py"], buffers["pz"]
    gx, gy = buffers["dx"], buffers["dy"]
    rp, rd = buffers["rp"], buffers["rd"]
    z = 1.0 / pz
    z2 = z * z

    j6 = torch.stack([
        z * gx,
        z * gy,
        -px * z2 * gx - py * z2 * gy,
        -px * py * z2 * gx - (1.0 + py * py * z2) * gy,
        (1.0 + px * px * z2) * gx + px * py * z2 * gy,
        -py * z * gx + px * z * gy,
    ], dim=-1)                                           # (..., N, 6)
    j4 = torch.stack([z2, z2 * py, -z2 * px, z], dim=-1)  # (..., N, 4)

    j6w = (j6 * weight_p.unsqueeze(-1)).transpose(-1, -2)
    j4w = (j4 * weight_d.unsqueeze(-1)).transpose(-1, -2)
    A6 = j6w @ j6
    b6 = (j6w @ rp.unsqueeze(-1)).squeeze(-1)
    A4 = j4w @ j4
    b4 = (j4w @ rd.unsqueeze(-1)).squeeze(-1)

    batch = A6.shape[:-2]
    A = A6.new_zeros(batch + (7, 7))
    A[..., :6, :6] = A6
    remap = torch.tensor(_REMAP, device=A.device)
    A[..., remap[:, None], remap[None, :]] += A4
    b = A6.new_zeros(batch + (7,))
    b[..., :6] = b6
    b[..., remap] += b4
    n = (torch.sum(buffers["mask"], dim=-1)
         + torch.sum(buffers["has_depth"], dim=-1))
    return A, b, torch.clamp_min(n, 1).to(torch.float32)


def _strided(pts: PointSet, stride: int) -> PointSet:
    """Every `stride`-th compacted point (n_valid, per lane, stays)."""
    if stride == 1:
        return pts
    return dataclasses.replace(pts, **{f: getattr(pts, f)[..., ::stride]
                                       for f in _POINT_FIELDS})


def level_plain(pose, aff_a, aff_b, pts: PointSet, frame_quad, cam: Camera,
                cfg: TrackerConfig, sigma2: float, min_pts: float,
                max_its: int) -> LevelResult:
    """One level's LM loop of B lanes in torch ops (the JAX `while_loop`
    of `_sim3_impl`, lsd_slam_tpu/tracking/sim3_tracker.py:265-314): every
    lane's state is a tensor updated with `torch.where`, so a lane that is
    done keeps its state while the batch runs on, and one host read of
    "any lane active" per trial (`n_syncs`). `cam` is the level's camera,
    `pts` its (strided) points, `min_pts` the in-image count below which
    the level diverges."""
    dev = pose.device
    b = pose.shape[0]
    f32 = torch.float32
    eye7 = 1e-12 * torch.eye(7, dtype=f32, device=dev)
    max_trials = max_its + 4 * cfg.max_lm_rejects
    syncs = 0

    def res_pass(p, a, b_):
        return _sim3_residual_pass(p, a, b_, pts, frame_quad, cam, cfg,
                                   cfg.use_esm_sim3)

    buffers, stats = res_pass(pose, aff_a, aff_b)
    div0 = stats["in_count"] < min_pts
    aff_a, aff_b = stats["aff_a_new"], stats["aff_b_new"]
    wp, wd, last_err, _, _ = _sim3_weights(pose, buffers, cfg, sigma2)
    A, g, n = _sim3_normal_equations(buffers, wp, wd)
    lam = torch.full((b,), cfg.lambda_initial, dtype=f32, device=dev)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    inc_try = torch.zeros(b, dtype=torch.int32, device=dev)
    trials = torch.zeros(b, dtype=torch.int32, device=dev)
    done = div0.clone()
    div_l = div0.clone()

    while True:
        active = (it < max_its) & ~done & (trials < max_trials)
        syncs += 1
        if not bool(active.any()):
            break
        An = A / n[:, None, None]
        gn = g / n[:, None]
        An = An + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(An, dim1=-2, dim2=-1))
        inc = torch.linalg.solve_ex(An + eye7, gn.unsqueeze(-1),
                                    check_errors=False)[0].squeeze(-1)
        inc_sq = torch.sum(inc * inc, dim=-1)
        blown = ~((inc_sq >= 0) & (inc_sq < 1.0))

        new_pose = lie.sim3_mul(lie.sim3_exp(inc), pose)
        buffers, stats = res_pass(new_pose, aff_a, aff_b)
        div = (stats["in_count"] < min_pts) | blown
        wp, wd, err, _, _ = _sim3_weights(new_pose, buffers, cfg, sigma2)
        A_new, g_new, n_new = _sim3_normal_equations(buffers, wp, wd)

        accept = (err < last_err) & ~div
        lam_acc = torch.where(lam <= 0.2, torch.zeros_like(lam),
                              lam * cfg.lambda_success_fac)
        lam_rej = torch.where(
            lam == 0.0, torch.full_like(lam, 0.2),
            lam * torch.pow(torch.full_like(lam, cfg.lambda_fail_fac),
                            (inc_try + 1).to(f32)))
        converged = (err / torch.clamp_min(last_err, 1e-12)
                     > cfg.convergence_eps)
        step_small = inc_sq < cfg.step_size_min

        take = active & accept
        pose = torch.where(take[:, None], new_pose, pose)
        aff_a = torch.where(take, stats["aff_a_new"], aff_a)
        aff_b = torch.where(take, stats["aff_b_new"], aff_b)
        A = torch.where(take[:, None, None], A_new, A)
        g = torch.where(take[:, None], g_new, g)
        n = torch.where(take, n_new, n)
        last_err = torch.where(take, err, last_err)
        lam = torch.where(active, torch.where(accept, lam_acc, lam_rej),
                          lam)
        it = it + take.to(torch.int32)
        inc_try = torch.where(active, torch.where(
            accept, torch.zeros_like(inc_try), inc_try + 1), inc_try)
        trials = trials + active.to(torch.int32)
        done = done | (active & (div | (accept & converged)
                                 | (~accept & step_small)))
        div_l = div_l | (active & div)
    return LevelResult(pose, aff_a, aff_b, last_err, div_l, trials, it,
                       syncs)


def levels_plain(tracks, cam: Camera, cfg: TrackerConfig, sigma2: float,
                 min_pts: float, max_its: int, final: bool = False):
    """`levels` in torch ops: each set's `level_plain`, and with `final`
    its `final_pass_plain` at the level's result."""
    out = []
    for pose, aff_a, aff_b, pts, frame_quad in tracks:
        r = level_plain(pose, aff_a, aff_b, pts, frame_quad, cam, cfg,
                        sigma2, min_pts, max_its)
        out.append((r, final_pass_plain(r.pose, r.aff_a, r.aff_b, pts,
                                        frame_quad, cam, cfg, sigma2))
                   if final else r)
    return out


def levels(tracks, cam: Camera, cfg: TrackerConfig, sigma2: float,
           min_pts: float, max_its: int, final: bool = False):
    """One level's LM loop for one or two lane sets at once: `tracks`
    holds (pose (B, 8), aff_a, aff_b, pts, frame_quad) per set, one of the
    point sets or layouts stacked (B, ...), the other shared. Returns per
    set its LevelResult, or with `final` (LevelResult, `final_pass_plain`'s
    five values at the level's result). On the card all sets run as one
    launch of the kernel `sim3_level` (ops/lm_track.py, csrc/sim3_track.cu:
    the whole loop on the device, no host pull, the final pass after the
    loop in the same launch); CPU tensors take `levels_plain` (anything
    else raises)."""
    if tracks[0][0].device.type == "cpu":
        return levels_plain(tracks, cam, cfg, sigma2, min_pts, max_its,
                            final)
    from lsd_slam_tpu_torch.ops import lm_track
    pose, aff_a, aff_b, sets = lane_table(tracks)
    sizes = [n for _, _, n in sets]
    out = lm_track.sim3_level(pose, aff_a, aff_b, sets, cam, cfg, sigma2,
                              min_pts, max_its,
                              max_its + 4 * cfg.max_lm_rejects, final=final)
    res = [LevelResult(*part, n_syncs=0)
           for part in zip(*(x.split(sizes) for x in out[:7]))]
    if final:
        res = [(r, _final_values(fin))
               for r, fin in zip(res, out[7].split(sizes))]
    return res


def _final_values(fin):
    """`final_pass_plain`'s five values from the kernel's (B, SIM3_FINAL)
    final-pass output."""
    return (fin[:, 4:].reshape(-1, 7, 7), fin[:, 0], fin[:, 1], fin[:, 2],
            fin[:, 3])


def lane_table(tracks):
    """`levels`' sets as one `ops.lm_track.sim3_level` launch takes them:
    (pose, aff_a, aff_b) over every lane, set after set, and the lane
    table [(point fields, frame_quad, lanes)]."""
    sizes = [int(t[0].shape[0]) for t in tracks]

    def lanes(k):
        return torch.cat([torch.as_tensor(t[k], dtype=torch.float32,
                                          device=t[0].device).expand(n)
                          for t, n in zip(tracks, sizes)])
    return (torch.cat([t[0] for t in tracks]), lanes(1), lanes(2),
            [(tuple(getattr(t[3], f) for f in _POINT_FIELDS), t[4], n)
             for t, n in zip(tracks, sizes)])


def level(pose, aff_a, aff_b, pts: PointSet, frame_quad, cam: Camera,
          cfg: TrackerConfig, sigma2: float, min_pts: float,
          max_its: int) -> LevelResult:
    """`levels` for one lane set, without the final pass."""
    return levels([(pose, aff_a, aff_b, pts, frame_quad)], cam, cfg, sigma2,
                  min_pts, max_its)[0]


def final_pass_plain(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                     cam: Camera, cfg: TrackerConfig, sigma2: float):
    """One pass at the converged pose (Sim3Tracker.cpp:354-363): (A (B, 7,
    7) made symmetric, the coupled mean residual, the depth and the
    photometric means, the usage sum), in torch ops."""
    buffers, stats = _sim3_residual_pass(pose, aff_a, aff_b, pts, frame_quad,
                                         cam, cfg, cfg.use_esm_sim3)
    wp, wd, mean, mean_d, mean_p = _sim3_weights(pose, buffers, cfg, sigma2)
    A, _, _ = _sim3_normal_equations(buffers, wp, wd)
    A = 0.5 * (A + A.transpose(-1, -2))  # exact symmetry
    return A, mean, mean_d, mean_p, stats["usage"]


def final_pass(pose, aff_a, aff_b, pts: PointSet, frame_quad, cam: Camera,
               cfg: TrackerConfig, sigma2: float):
    """`final_pass_plain`'s values on their own: for CUDA tensors one
    launch of `sim3_level` with no trials (the kernel's pass at the given
    pose, A symmetric by construction), for CPU ones the plain pass. The
    tracker runs its final pass inside the last level (`levels(final=
    True)`); this is the same pass alone, to hold that one against."""
    if pose.device.type == "cpu":
        return final_pass_plain(pose, aff_a, aff_b, pts, frame_quad, cam,
                                cfg, sigma2)
    from lsd_slam_tpu_torch.ops import lm_track
    out = lm_track.sim3_level(
        pose, aff_a, aff_b,
        [(tuple(getattr(pts, f) for f in _POINT_FIELDS), frame_quad,
          pose.shape[0])], cam, cfg, sigma2, 0.0, 0, 0, final=True)
    return _final_values(out[7])


def _sim3_impl(cam: Camera, cfg: TrackerConfig, sigma2: float,
               start_level: int, final_level: int, tracks):
    """The whole coarse-to-fine Sim3 track of one or two lane sets;
    `tracks` holds (ref, frame, init_frame_to_ref (B, 8)) per set. Each
    level runs every set in one `levels` call (one launch on the card),
    the final level with its final pass. Returns a Sim3TrackResult per
    set."""
    state = []
    for _, _, init in tracks:
        b = init.shape[0]
        state.append(dict(
            pose=lie.sim3_inverse(init),
            aff_a=torch.ones(b, dtype=torch.float32, device=init.device),
            aff_b=torch.zeros(b, dtype=torch.float32, device=init.device),
            diverged=torch.zeros(b, dtype=torch.bool, device=init.device),
            syncs=0))

    for lvl in range(start_level, final_level - 1, -1):
        caml = cam.level(lvl)
        # fine-level point striding: levels <= 2 run on every 2nd compacted
        # point (the JAX package's statistical-estimate cut, kept as is);
        # the final Hessian (Sim3Tracker.cpp:354-363) at the converged pose
        # of the last level uses the same stride
        stride = 2 if lvl <= 2 else 1
        min_pts = max(0.5 * cfg.min_goodperall_pixel_absmin * caml.height
                      * caml.width / stride, 10.0)
        last = lvl == final_level
        outs = levels([(st["pose"], st["aff_a"], st["aff_b"],
                        _strided(ref.pts[lvl], stride), frame.sim3_quad[lvl])
                       for st, (ref, frame, _) in zip(state, tracks)],
                      caml, cfg, sigma2, min_pts, cfg.max_iterations[lvl],
                      final=last)
        for st, out in zip(state, outs):
            r, fin = out if last else (out, None)
            st.update(pose=r.pose, aff_a=r.aff_a, aff_b=r.aff_b,
                      diverged=st["diverged"] | r.diverged,
                      syncs=st["syncs"] + r.n_syncs, final=fin)

    results = []
    for st, (ref, _, _) in zip(state, tracks):
        A, mean, mean_d, mean_p, usage = st["final"]
        pose, b = st["pose"], st["pose"].shape[0]
        stride = 2 if final_level <= 2 else 1
        ref_valid_count = torch.clamp_min(
            ref.pts[final_level].n_valid / stride, 1.0)
        diverged = st["diverged"] | (pose[:, 7] <= 0)
        pose = torch.where(diverged[:, None],
                           lie.sim3_identity((b,), device=pose.device), pose)
        results.append(Sim3TrackResult(
            ref_to_frame=pose, frame_to_ref=lie.sim3_inverse(pose),
            diverged=diverged, last_residual=mean, depth_residual=mean_d,
            photo_residual=mean_p, point_usage=usage / ref_valid_count,
            hessian=A, n_syncs=st["syncs"]))
    return results


def pack_result(r: Sim3TrackResult) -> torch.Tensor:
    """(B, 70) in the SIM3_PACK layout."""
    return torch.cat([
        r.ref_to_frame, r.frame_to_ref,
        torch.stack([r.diverged.to(torch.float32), r.last_residual,
                     r.depth_residual, r.photo_residual, r.point_usage],
                    dim=-1),
        r.hessian.reshape(-1, 49)], dim=-1)


def stack_refs(refs, levels: Tuple[int, ...]) -> TrackingRef:
    """Stack TrackingRefs lane-wise at `levels` (point fields (B, N),
    n_valid (B,), sim3 layouts (B, H*W, 20)); other levels hold None."""
    n_lvl = len(refs[0].pts)
    pts, quads = [], []
    for lvl in range(n_lvl):
        if lvl not in levels:
            pts.append(None)
            quads.append(None)
            continue
        pts.append(PointSet(*(torch.stack([getattr(r.pts[lvl], f)
                                           for r in refs])
                              for f in _POINT_FIELDS + ("n_valid",))))
        quads.append(torch.stack([r.sim3_quad[lvl] for r in refs]))
    return TrackingRef(pts=tuple(pts), sim3_quad=tuple(quads))


class Sim3Tracker:
    """Sim3 tracker bound to a camera + config."""

    def __init__(self, cam: Camera, cfg: TrackerConfig = TrackerConfig(),
                 sigma2: float = 16.0):
        self.cam = cam
        self.cfg = cfg
        self.sigma2 = float(sigma2)

    def _run(self, tracks, start_level, final_level, device):
        """`_sim3_impl` of (ref, frame, inits) per lane set."""
        return _sim3_impl(self.cam, self.cfg, self.sigma2, int(start_level),
                          int(final_level), [
                              (ref, frame, torch.as_tensor(
                                  inits, dtype=torch.float32,
                                  device=device).reshape(-1, 8))
                              for ref, frame, inits in tracks])

    def track(self, ref: TrackingRef, frame: TrackingRef, init_frame_to_ref,
              start_level: int, final_level: int) -> Sim3TrackResult:
        """One track (a batch of one); fields without the lane axis."""
        dev = frame.sim3_quad[final_level].device
        r, = self._run([(ref, frame, init_frame_to_ref)], start_level,
                       final_level, dev)
        return Sim3TrackResult(*(getattr(r, f.name)[0] for f in
                                 dataclasses.fields(r)[:-1]), r.n_syncs)

    def track_batch(self, refs_stacked, frame: TrackingRef, inits,
                    start_level: int, final_level: int) -> Sim3TrackResult:
        """Stacked candidate refs vs ONE common target frame."""
        dev = frame.sim3_quad[final_level].device
        return self._run([(refs_stacked, frame, inits)], start_level,
                         final_level, dev)[0]

    def track_batch_frames(self, ref: TrackingRef, frames_stacked, inits,
                           start_level: int, final_level: int
                           ) -> Sim3TrackResult:
        """ONE common reference vs stacked candidate frames."""
        dev = frames_stacked.sim3_quad[final_level].device
        return self._run([(ref, frames_stacked, inits)], start_level,
                         final_level, dev)[0]

    def track_batch_packed(self, refs_stacked, frame, inits,
                           start_level: int, final_level: int):
        """track_batch as one (B, 70) tensor (layout SIM3_PACK)."""
        r = self.track_batch(refs_stacked, frame, inits, start_level,
                             final_level)
        return pack_result(r), r.n_syncs

    def track_batch_frames_packed(self, ref, frames_stacked, inits,
                                  start_level: int, final_level: int):
        """track_batch_frames as one (B, 70) tensor."""
        r = self.track_batch_frames(ref, frames_stacked, inits, start_level,
                                    final_level)
        return pack_result(r), r.n_syncs

    def track_pair_packed(self, ref, stacked, inits_frames, inits_refs,
                          start_level: int, final_level: int):
        """A constraint stage's two directions together: ONE reference
        against the stacked candidates' frames (`track_batch_frames`, from
        `inits_frames`) and the stacked candidates against it as the frame
        (`track_batch`, from `inits_refs`). Returns their (B, 70) packs and
        the flag pulls of both. On the card every level of both runs as
        one `sim3_level` launch; each direction's pack has the bits of its
        own call."""
        dev = stacked.sim3_quad[final_level].device
        ba, ab = self._run([(ref, stacked, inits_frames),
                            (stacked, ref, inits_refs)], start_level,
                           final_level, dev)
        return pack_result(ba), pack_result(ab), ba.n_syncs + ab.n_syncs
