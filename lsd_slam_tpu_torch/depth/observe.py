"""Epipolar-line stereo observation: the depth filter's hot sweep (torch).

Port of the single-reference path of lsd_slam_tpu/depth/observe.py
(observeDepth / makeAndCheckEPL / doLineStereo / observeDepthCreate /
observeDepthUpdate, DepthMap.cpp:147-473, 1442-1972): `make_epl`,
`line_stereo` (fixed 34-step masked EPL search over a 38-sample lattice,
5-tap SSD, ambiguity check, subpixel refinement, variance model),
`observe` (fixed-budget compaction of the active set, then stereo on the
compacted points and a scatter back) and `_fuse_results` (the
create/EKF-update/fail lattice). The multi-reference sweep
(`make_epl_multi`, `observe_multi`) is not ported yet.

The compaction replaces `jnp.nonzero(size=budget, fill_value=-1)` by a
cumsum + scatter with static shapes (no host sync), with the same slot
order; the frame-dependent roll is computed on the host in f32 exactly as
the JAX program computes it on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import DepthFilterConfig, MappingConfig
from lsd_slam_tpu_torch.ops.interp import patch16_pack, patch16_sample, \
    trunc_int
from lsd_slam_tpu_torch.depth.state import DepthMapState

# Stat-counter names `observe` returns, in the order hosts unpack the fused
# scalar vector (identical to the JAX package)
OBSERVE_STAT_KEYS = ("active", "blacklisted", "created", "inconsistent",
                     "killed", "oob", "processed", "update_failed",
                     "updated")

MAX_STEPS = 34          # >= MAX_EPL_LENGTH_CROP + 2 extension + rounding
N_SAMPLES = MAX_STEPS + 4

# outcome codes (match the reference's return values where negative)
OK = 0
ERR_OOB = -1            # epl out of bounds -> try again later
ERR_FAIL = -2           # ambiguous / nan / negative idepth
ERR_BIG = -3            # error too large
ERR_NAN = -4            # arithmetic blow-up
SKIP = -100             # not processed this sweep

_UNZERO_EPS = 1e-10
_DIV_EPS = 1e-10


def _unzero(x):
    eps = torch.where(x < 0, torch.full_like(x, -_UNZERO_EPS),
                      torch.full_like(x, _UNZERO_EPS))
    return torch.where(torch.abs(x) < _UNZERO_EPS, eps, x)


def _grid(h, w, device, dtype=torch.float32):
    ys = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return ys, xs


def make_epl(t_r2k, kf_img, cam: Camera, cfg: DepthFilterConfig):
    """Per-pixel epipolar direction in the keyframe + validity checks
    (== makeAndCheckEPL, DepthMap.cpp:184-234)."""
    h, w = kf_img.shape
    ys, xs = _grid(h, w, kf_img.device)
    epx = -cam.fx * t_r2k[0] + t_r2k[2] * (xs - cam.cx)
    epy = -cam.fy * t_r2k[1] + t_r2k[2] * (ys - cam.cy)
    finite = torch.isfinite(epx + epy)

    lsq = epx * epx + epy * epy
    ok_len = lsq >= cfg.min_epl_length_squared

    # raw (not halved) central differences, like the reference's direct reads
    gx = torch.zeros_like(kf_img)
    gy = torch.zeros_like(kf_img)
    gx[:, 1:-1] = kf_img[:, 2:] - kf_img[:, :-2]
    gy[1:-1, :] = kf_img[2:, :] - kf_img[:-2, :]
    dot = gx * epx + gy * epy
    safe_lsq = torch.clamp_min(lsq, _DIV_EPS)
    egs = dot * dot / safe_lsq
    ok_grad = egs >= cfg.min_epl_grad_squared
    ok_angle = egs / torch.clamp_min(gx * gx + gy * gy, _DIV_EPS) \
        >= cfg.min_epl_angle_squared

    fac = cfg.gradient_sample_dist / torch.sqrt(safe_lsq)
    return (epx * fac, epy * fac), (finite & ok_len & ok_grad & ok_angle)


def line_stereo(xs, ys, prior_idepth, min_idepth, max_idepth, epxn, epyn,
                kf_img, kf_gx, kf_gy, ref_img,
                kf_to_ref, ref_to_kf, tracking_error_fac,
                cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
                use_subpixel: bool):
    """Vectorized doLineStereo over a point set (single reference frame).

    xs/ys: (N,) pixel coordinates; per-point inputs share that shape;
    kf_img/ref_img are full (H, W). Returns (code, result_idepth,
    result_var, result_epl_length, best_match_err), each (N,)."""
    assert dcfg.gradient_sample_dist <= 1.0, (
        "patch16 grouped EPL sampling requires gradient_sample_dist <= 1.0 "
        f"(got {dcfg.gradient_sample_dist})")
    h, w = kf_img.shape
    dev = xs.device
    f32 = dict(dtype=torch.float32, device=dev)

    R_k2r = lie.quat_to_matrix(kf_to_ref[0:4])          # (3, 3)
    t_k2r = kf_to_ref[4:7]                              # (3,)
    tef = tracking_error_fac
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy],
                      [0, 0, 1.0]], **f32)
    KR = K @ R_k2r
    Kt = K @ t_k2r

    kx = (xs - cam.cx) / cam.fx
    ky = (ys - cam.cy) / cam.fy
    p_inf = (KR[:, 0] * kx[..., None] + KR[:, 1] * ky[..., None]
             + KR[:, 2])                                # (N, 3)

    safe_prior = torch.clamp_min(prior_idepth, _DIV_EPS)
    Kt_z = Kt[2]
    rescale = p_inf[..., 2] + Kt_z * safe_prior

    ok = torch.ones(xs.shape, dtype=torch.bool, device=dev)
    code = torch.zeros(xs.shape, dtype=torch.int32, device=dev)

    def fail(ok, code, cond, c):
        newly = ok & cond
        return ok & ~cond, torch.where(newly, torch.full_like(code, c), code)

    # 5-tap descriptor footprint must stay inside the KF image
    fx_off = 2 * epxn * rescale
    fy_off = 2 * epyn * rescale
    oob_kf = ((xs - fx_off <= 0) | (xs - fx_off >= w - 2)
              | (ys - fy_off <= 0) | (ys - fy_off >= h - 2)
              | (xs + fx_off <= 0) | (xs + fx_off >= w - 2)
              | (ys + fy_off <= 0) | (ys + fy_off >= h - 2))
    ok, code = fail(ok, code, oob_kf, ERR_OOB)
    ok, code = fail(ok, code, ~((rescale > 0.7) & (rescale < 1.4)), ERR_OOB)

    # keyframe 5-tap descriptor, taps grouped {-2,-1} {0,1} {2}
    kf_patch = patch16_pack(kf_img)
    tap_j = torch.tensor([[-2.0, -1.0], [0.0, 1.0], [2.0, 2.0]], **f32)
    tap_x = xs[..., None, None] + tap_j * (epxn * rescale)[..., None, None]
    tap_y = ys[..., None, None] + tap_j * (epyn * rescale)[..., None, None]
    taps = patch16_sample(kf_patch, h, w, tap_x, tap_y)    # (N, 3, 2)
    real_vals = torch.stack(
        [taps[..., 0, 0], taps[..., 0, 1], taps[..., 1, 0],
         taps[..., 1, 1], taps[..., 2, 0]], dim=-1)        # (N, 5)

    # near/far endpoints on the EPL in the ref image (DepthMap.cpp:1489-1512)
    p_close = p_inf + Kt * max_idepth[..., None]
    behind = p_close[..., 2] < 0.001
    kt_z_safe = torch.where(Kt_z == 0, torch.full_like(Kt_z, _DIV_EPS), Kt_z)
    max_idepth = torch.where(behind, (0.001 - p_inf[..., 2]) / kt_z_safe,
                             max_idepth)
    p_close = p_inf + Kt * max_idepth[..., None]
    pcz = _unzero(p_close[..., 2])
    p_close = p_close / pcz[..., None]

    p_far = p_inf + Kt * min_idepth[..., None]
    ok, code = fail(ok, code,
                    (p_far[..., 2] < 0.001) | (max_idepth < min_idepth),
                    ERR_OOB)
    pfz = _unzero(p_far[..., 2])
    p_far = p_far / pfz[..., None]

    ok, code = fail(ok, code,
                    ~torch.isfinite(p_far[..., 0] + p_close[..., 0]), ERR_NAN)

    incx = p_close[..., 0] - p_far[..., 0]
    incy = p_close[..., 1] - p_far[..., 1]
    epl_len = torch.sqrt(incx * incx + incy * incy)
    ok, code = fail(ok, code, ~(epl_len > 0) | ~torch.isfinite(epl_len),
                    ERR_NAN)
    safe_len = torch.clamp_min(epl_len, _DIV_EPS)

    # crop to MAX_EPL_LENGTH_CROP
    crop = epl_len > dcfg.max_epl_length_crop
    cfac = torch.where(crop, dcfg.max_epl_length_crop / safe_len,
                       torch.ones_like(safe_len))
    pcx = p_far[..., 0] + incx * cfac
    pcy = p_far[..., 1] + incy * cfac

    incx = incx * dcfg.gradient_sample_dist / safe_len
    incy = incy * dcfg.gradient_sample_dist / safe_len

    pfx = p_far[..., 0] - incx
    pfy = p_far[..., 1] - incy
    pcx = pcx + incx
    pcy = pcy + incy

    # pad short epls to MIN_EPL_LENGTH_CROP
    pad = torch.where(epl_len < dcfg.min_epl_length_crop,
                      (dcfg.min_epl_length_crop - epl_len) / 2.0,
                      torch.zeros_like(epl_len))
    pfx = pfx - incx * pad
    pfy = pfy - incy * pad
    pcx = pcx + incx * pad
    pcy = pcy + incy * pad

    b = float(dcfg.sample_point_to_border)
    ok, code = fail(ok, code,
                    (pfx <= b) | (pfx >= w - b) | (pfy <= b) | (pfy >= h - b),
                    ERR_OOB)

    # near point outside: clamp along the line (DepthMap.cpp:1566-1613);
    # the min-length-8 rejection applies only when it was clamped
    was_outside = (pcx <= b) | (pcx >= w - b) | (pcy <= b) | (pcy >= h - b)
    sx = _unzero(incx)
    sy = _unzero(incy)
    zero = torch.zeros_like(pcx)
    to_add = torch.where(pcx <= b, (b - pcx) / sx,
                         torch.where(pcx >= w - b, (w - b - pcx) / sx, zero))
    pcx = pcx + to_add * incx
    pcy = pcy + to_add * incy
    to_add = torch.where(pcy <= b, (b - pcy) / sy,
                         torch.where(pcy >= h - b, (h - b - pcy) / sy, zero))
    pcx = pcx + to_add * incx
    pcy = pcy + to_add * incy
    new_len = torch.sqrt((pcx - pfx) ** 2 + (pcy - pfy) ** 2)
    ok, code = fail(ok, code,
                    (pcx <= b) | (pcx >= w - b) | (pcy <= b) | (pcy >= h - b)
                    | (was_outside & (new_len < 8.0)), ERR_OOB)

    n_steps = torch.clamp(trunc_int(torch.floor(new_len + 1e-3)) + 1,
                          1, MAX_STEPS)

    # ---- sample lattice + 5-tap SSD over the masked search window ----
    n_groups = -(-N_SAMPLES // 3)
    ms = (torch.arange(n_groups * 3, **f32).reshape(n_groups, 3) - 2.0)
    qx = pfx[..., None, None] + ms * incx[..., None, None]
    qy = pfy[..., None, None] + ms * incy[..., None, None]
    ref_patch = patch16_pack(ref_img)
    samp = patch16_sample(ref_patch, h, w, qx, qy)        # (N, G, 3)
    samp = samp.reshape(samp.shape[:-2] + (n_groups * 3,))[..., :N_SAMPLES]

    ee = torch.zeros(xs.shape + (MAX_STEPS,), **f32)
    for j in range(5):
        d = samp[..., j:j + MAX_STEPS] - real_vals[..., j:j + 1]
        ee = ee + d * d

    ks = torch.arange(MAX_STEPS, device=dev)
    in_search = ks < n_steps[..., None]
    inf = torch.full_like(ee, float("inf"))
    ee_m = torch.where(in_search, ee, inf)
    best_k = torch.argmin(ee_m, dim=-1)
    best_err = torch.gather(ee_m, -1, best_k[..., None])[..., 0]

    # ambiguity (DepthMap.cpp:1761-1765): the global second-best rejects
    # only when it sits non-adjacent to the winner and is too close in error
    not_best = in_search & (ks != best_k[..., None])
    ee_second = torch.where(not_best, ee, inf)
    second_k = torch.argmin(ee_second, dim=-1)
    second_err = torch.gather(ee_second, -1, second_k[..., None])[..., 0]
    second_nonadj = torch.abs(second_k - best_k) > 1

    ok, code = fail(ok, code, best_err > 4.0 * dcfg.max_error_stereo, ERR_BIG)
    ok, code = fail(ok, code,
                    second_nonadj
                    & (dcfg.min_distance_error_stereo * best_err
                       > second_err),
                    ERR_FAIL)

    # ---- subpixel refinement (DepthMap.cpp:1767-1848) ----
    def errs_at(k):
        idx = torch.clamp(k, 0, MAX_STEPS - 1)
        return torch.stack(
            [torch.gather(samp, -1, (idx + j)[..., None])[..., 0]
             - real_vals[..., j] for j in range(5)], dim=-1)

    e_best = errs_at(best_k)
    e_pre = errs_at(best_k - 1)
    e_post = errs_at(best_k + 1)
    err_pre = torch.sum(e_pre * e_pre, -1)
    err_post = torch.sum(e_post * e_post, -1)
    cross_pre = torch.sum(e_best * e_pre, -1)
    cross_post = torch.sum(e_best * e_post, -1)

    valid_pre = best_k >= 1
    valid_post = (best_k + 1) < n_steps

    grad_pre_pre = -(err_pre - cross_pre)
    grad_pre_this = best_err - cross_pre
    grad_post_this = -(best_err - cross_post)
    grad_post_post = err_post - cross_post

    both_valid = valid_pre & valid_post
    crossing_mid = (grad_post_this < 0) ^ (grad_pre_this < 0)
    crossing_pre = (grad_pre_pre < 0) ^ (grad_pre_this < 0)
    crossing_post = (grad_post_post < 0) ^ (grad_post_this < 0)

    interp_pre = both_valid & ~crossing_mid & crossing_pre & ~crossing_post
    interp_post = both_valid & ~crossing_mid & ~crossing_pre & crossing_post

    d_pre = grad_pre_this / _unzero(grad_pre_this - grad_pre_pre)
    d_post = grad_post_this / _unzero(grad_post_this - grad_post_post)

    if use_subpixel:
        sub_off = torch.where(interp_pre, -d_pre,
                              torch.where(interp_post, d_post,
                                          torch.zeros_like(d_post)))
        did_sub = interp_pre | interp_post
        best_err = torch.where(
            interp_pre,
            best_err - 2 * d_pre * grad_pre_this
            - (grad_pre_pre - grad_pre_this) * d_pre * d_pre,
            torch.where(
                interp_post,
                best_err + 2 * d_post * grad_post_this
                + (grad_post_post - grad_post_this) * d_post * d_post,
                best_err))
    else:
        sub_off = torch.zeros_like(best_err)
        did_sub = torch.zeros_like(valid_pre)

    pos = best_k.to(torch.float32) + sub_off
    best_x = pfx + pos * incx
    best_y = pfy + pos * incy

    # gradient along the searched line in the KF (DepthMap.cpp:1854-1862)
    sample_dist = dcfg.gradient_sample_dist * rescale
    gal = torch.zeros_like(best_err)
    for j in range(4):
        t = real_vals[..., j + 1] - real_vals[..., j]
        gal = gal + t * t
    gal = gal / torch.clamp_min(sample_dist * sample_dist, _DIV_EPS)

    ok, code = fail(ok, code,
                    best_err > dcfg.max_error_stereo + torch.sqrt(gal) * 20.0,
                    ERR_BIG)

    # ---- triangulate inverse depth in the KF (DepthMap.cpp:1872-1904) ----
    dot0 = R_k2r[0, 0] * kx + R_k2r[0, 1] * ky + R_k2r[0, 2]
    dot1 = R_k2r[1, 0] * kx + R_k2r[1, 1] * ky + R_k2r[1, 2]
    dot2 = R_k2r[2, 0] * kx + R_k2r[2, 1] * ky + R_k2r[2, 2]
    t0_, t1_, t2_ = t_k2r[0], t_k2r[1], t_k2r[2]

    use_x = incx * incx > incy * incy
    old_x = best_x / cam.fx - cam.cx / cam.fx
    old_y = best_y / cam.fy - cam.cy / cam.fy
    nom_x = _unzero(old_x * t2_ - t0_)
    nom_y = _unzero(old_y * t2_ - t1_)
    id_x = (dot0 - old_x * dot2) / nom_x
    id_y = (dot1 - old_y * dot2) / nom_y
    alpha_x = incx / cam.fx * (dot0 * t2_ - dot2 * t0_) / (nom_x * nom_x)
    alpha_y = incy / cam.fy * (dot1 * t2_ - dot2 * t1_) / (nom_y * nom_y)
    idepth_new = torch.where(use_x, id_x, id_y)
    alpha = torch.where(use_x, alpha_x, alpha_y)

    if not mcfg.allow_negative_idepths:
        ok, code = fail(ok, code, idepth_new < 0, ERR_FAIL)

    # ---- variance model (DepthMap.cpp:1911-1930) ----
    photo_err = 4.0 * mcfg.camera_pixel_noise2 / (gal + _DIV_EPS)
    geo_dot = kf_gx * epxn + kf_gy * epyn + _DIV_EPS
    geo_err = (tef * tef
               * (kf_gx * kf_gx + kf_gy * kf_gy) / (geo_dot * geo_dot))
    disc = torch.where(did_sub, torch.full_like(sample_dist, 0.05),
                       torch.full_like(sample_dist, 0.5)) \
        * sample_dist * sample_dist
    result_var = alpha * alpha * (disc + geo_err + photo_err)

    code = torch.where(ok, torch.full_like(code, OK), code)
    return code, idepth_new, result_var, epl_len, best_err


def frame_shift(ref_frame_id: float, n_pix: int) -> int:
    """The frame-dependent roll of the active set, computed in f32 like
    `jnp.mod(ref_frame_id * 37831.0, n_pix).astype(int32)`."""
    x = np.float32(ref_frame_id) * np.float32(37831.0)
    return int(np.mod(x, np.float32(n_pix)))


def compact_active(process: torch.Tensor, shift: int, point_budget: int):
    """First `point_budget` set entries of the rolled flat mask, in order
    (== jnp.nonzero(roll(process, shift), size=budget, fill_value=-1)),
    mapped back to unrolled flat indices. Returns (flat_idx, valid_k)."""
    n_pix = process.numel()
    dev = process.device
    rolled = torch.roll(process.reshape(-1), shift)
    pos = torch.cumsum(rolled.to(torch.int64), 0) - 1
    dest = torch.where(rolled & (pos < point_budget), pos, point_budget)
    buf = torch.full((point_budget + 1,), -1, dtype=torch.int64, device=dev)
    buf.scatter_(0, dest, torch.arange(n_pix, device=dev))
    idx_r = buf[:point_budget]
    valid_k = idx_r >= 0
    flat_idx = torch.where(valid_k, torch.remainder(idx_r - shift, n_pix),
                           torch.zeros_like(idx_r))
    return flat_idx, valid_k


def observe(state: DepthMapState, kf_img, kf_gx, kf_gy, kf_max_grad,
            ref_img, ref_to_kf, ref_frame_id: float, good_mask,
            tracking_residual, skip_inc: float,
            cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
            reactivated: bool = False, point_budget: int = 0):
    """One observation sweep against one tracked frame (DepthMap.cpp:105-473)
    with the active set compacted to a fixed budget. ref_frame_id and
    skip_inc are host numbers (f32 values). Returns (new_state, stats)."""
    h, w = kf_img.shape
    dev = kf_img.device
    if point_budget <= 0:
        point_budget = max(8192, -(-(h * w) // 6 // 8192) * 8192)
    kf_to_ref = lie.se3_inverse(ref_to_kf)
    t_r2k = ref_to_kf[4:7]
    ref_id = float(np.float32(ref_frame_id))

    (epxn, epyn), epl_ok = make_epl(t_r2k, kf_img, cam, dcfg)

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    active = interior & (kf_max_grad >= mcfg.min_use_grad) & good_mask

    can_update = state.valid & active
    if not reactivated:
        can_update = can_update & (state.next_min_id <= ref_id)
    can_create = (~state.valid) & active \
        & (state.blacklisted >= dcfg.min_blacklist)

    # priors: update searches prior +- STEREO_EPL_VAR_FAC sigma; create
    # searches the full range
    sv = torch.sqrt(torch.clamp_min(state.var_smoothed, 0.0))
    upd_prior = state.idepth_smoothed
    upd_min = torch.clamp_min(upd_prior - sv * dcfg.stereo_epl_var_fac, 0.0)
    upd_max = torch.clamp_max(upd_prior + sv * dcfg.stereo_epl_var_fac,
                              1.0 / dcfg.min_depth)
    prior = torch.where(can_update, upd_prior, torch.ones_like(upd_prior))
    min_id = torch.where(can_update, upd_min, torch.zeros_like(upd_min))
    max_id = torch.where(can_update, upd_max,
                         torch.full_like(upd_max, 1.0 / dcfg.min_depth))

    # ---- compact the active set (fixed budget) ----
    n_pix = h * w
    process = (can_update | can_create) & epl_ok
    flat_idx, valid_k = compact_active(process, frame_shift(ref_id, n_pix),
                                       point_budget)

    def take(a):
        return a.reshape(-1)[flat_idx]

    xs_k = (flat_idx % w).to(torch.float32)
    ys_k = torch.div(flat_idx, w, rounding_mode="floor").to(torch.float32)

    tef = 0.25 * (1.0 + tracking_residual)
    code_k, id_k, var_k, epl_k, _ = line_stereo(
        xs_k, ys_k, take(prior), take(min_id), take(max_id),
        take(epxn), take(epyn), kf_img, take(kf_gx), take(kf_gy), ref_img,
        kf_to_ref, ref_to_kf, tef, cam, dcfg, mcfg,
        mcfg.use_subpixel_stereo)

    # ---- scatter results back to the grid (dump slot n_pix) ----
    tgt = torch.where(valid_k, flat_idx, n_pix)

    def scatter(vals, fill):
        buf = torch.full((n_pix + 1,), fill, dtype=vals.dtype, device=dev)
        buf[tgt] = vals
        return buf[:n_pix].reshape(h, w)

    code = scatter(code_k, SKIP)
    r_idepth = scatter(id_k, 0.0)
    r_var = scatter(var_k, 0.0)
    r_epl = scatter(epl_k, 1e9)

    return _fuse_results(state, code, r_idepth, r_var, r_epl, can_update,
                         can_create, epl_ok, kf_max_grad, ref_id,
                         skip_inc, dcfg, process, valid_k)


def _fuse_results(state, code, r_idepth, r_var, r_epl, can_update,
                  can_create, epl_ok, kf_max_grad, ref_id, skip_inc,
                  dcfg, process, valid_k):
    """Create/EKF-update/fail lattice (observeDepthCreate /
    observeDepthUpdate, DepthMap.cpp:237-470)."""
    success = code == OK

    # ---------------- create path (DepthMap.cpp:237-292) ----------------
    create_try = can_create & epl_ok
    create_success = create_try & success & (r_var <= dcfg.max_var)
    create_blacklist = create_try & ((code == ERR_BIG) | (code == ERR_FAIL))

    # ---------------- update path (DepthMap.cpp:344-470) ----------------
    upd_try = can_update & epl_ok
    upd_fail = upd_try & (code == ERR_FAIL)
    diff = r_idepth - state.idepth_smoothed
    inconsistent = (upd_try & success
                    & (dcfg.diff_fac_observe * diff * diff
                       > r_var + state.var_smoothed))
    upd_success = upd_try & success & ~inconsistent

    # EKF fusion (DepthMap.cpp:430-444)
    id_var = state.var * dcfg.succ_var_inc_fac
    wgt = r_var / torch.clamp_min(r_var + id_var, _DIV_EPS)
    fused_idepth = _unzero((1.0 - wgt) * r_idepth + wgt * state.idepth)
    fused_var = torch.minimum(id_var * wgt, state.var)

    validity_cap = (dcfg.validity_counter_max
                    + kf_max_grad * dcfg.validity_counter_max_variable / 255.0)

    new_idepth = torch.where(create_success, _unzero(r_idepth),
                             torch.where(upd_success, fused_idepth,
                                         state.idepth))
    new_var = torch.where(create_success, r_var,
                          torch.where(upd_success, fused_var, state.var))

    # failed update: inflate variance, maybe kill (DepthMap.cpp:369-389,414)
    fail_like = upd_fail | inconsistent
    new_var = torch.where(fail_like, new_var * dcfg.fail_var_inc_fac, new_var)
    killed = fail_like & (new_var > dcfg.max_var)

    new_valid = (state.valid | create_success) & ~killed
    new_validity = torch.where(
        create_success,
        torch.full_like(state.validity,
                        float(dcfg.validity_counter_initial_observe)),
        torch.where(upd_success,
                    torch.minimum(state.validity + dcfg.validity_counter_inc,
                                  validity_cap),
                    torch.where(upd_fail,
                                torch.clamp_min(state.validity
                                                - dcfg.validity_counter_dec,
                                                0.0),
                                state.validity)))
    new_blacklisted = (state.blacklisted
                       - create_blacklist.to(torch.int32)
                       - (killed & upd_fail).to(torch.int32))

    # adaptive frame skipping for short epls (DepthMap.cpp:447-463)
    short_epl = r_epl < dcfg.min_epl_length_crop
    inc = skip_inc + torch.remainder(trunc_int(r_epl * 10000.0),
                                     2).to(torch.float32)
    inc = torch.where(r_epl < 0.5 * dcfg.min_epl_length_crop, inc * 3.0, inc)
    new_next_min = torch.where(
        upd_success & short_epl, ref_id + inc,
        torch.where(upd_fail, torch.zeros_like(state.next_min_id),
                    state.next_min_id))

    new_state = state.replace(
        valid=new_valid,
        idepth=new_idepth,
        var=new_var,
        validity=new_validity,
        blacklisted=new_blacklisted,
        next_min_id=new_next_min,
    )
    stats = dict(
        created=torch.sum(create_success),
        updated=torch.sum(upd_success),
        update_failed=torch.sum(upd_fail),
        inconsistent=torch.sum(inconsistent),
        killed=torch.sum(killed),
        oob=torch.sum((code == ERR_OOB) & (upd_try | create_try)),
        blacklisted=torch.sum(create_blacklist),
        active=torch.sum(process),
        processed=torch.sum(valid_k),
    )
    return new_state, stats
