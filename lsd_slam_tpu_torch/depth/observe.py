"""Epipolar-line stereo observation: the depth filter's hot sweep (torch).

Port of lsd_slam_tpu/depth/observe.py (observeDepth / makeAndCheckEPL /
doLineStereo / observeDepthCreate / observeDepthUpdate,
DepthMap.cpp:147-473, 1442-1972): `make_epl`, `line_stereo` (fixed 34-step
masked EPL search over a 38-sample lattice, 5-tap SSD, ambiguity check,
subpixel refinement, variance model), `_fuse_results` (the
create/EKF-update/fail lattice), `make_epl_multi`, and the sweeps
`observe` (one tracked frame) and `observe_multi` (a (K, H, W) stack of
tracked frames with a per-pixel frame choice). A sweep runs four stages:
the per-pixel set-up `epl_setup`, the fixed-budget compaction
`compact_active`, the search `epl_search` on the compacted points, and the
fusion `fuse`. The three stages other than the compaction route by device:
CPU tensors take their plain versions here (`epl_setup_plain`,
`epl_search_plain`, `fuse_plain`), CUDA tensors the kernels of
ops/epl_stereo.py.

The compaction replaces `jnp.nonzero(size=budget, fill_value=-1)` by a
cumsum + scatter with static shapes (no host sync), with the same slot
order; the frame-dependent roll is computed on the host in f32 exactly as
the JAX program computes it on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

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


class FrameTerms(NamedTuple):
    """The per-frame constants of a sweep, (K, ...) with K = 1 for one
    reference frame: K_otherToThis_R = K @ R (K, 3, 3), K @ t (K, 3), the
    keyframe-to-frame rotation R (K, 3, 3) and translation t (K, 3), and
    the tracking-error factor tef (K,)."""
    KR: torch.Tensor
    Kt: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    tef: torch.Tensor


@functools.lru_cache(maxsize=16)
def _intrinsics(fx: float, fy: float, cx: float, cy: float,
                device: str) -> torch.Tensor:
    """The camera matrix K on `device`, made once: a copy from the host to
    the card waits for the card's stream, so a sweep must not make one."""
    return torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]],
                        dtype=torch.float32, device=device)


def frame_terms(kf_to_ref, tracking_error_fac, cam: Camera) -> FrameTerms:
    """FrameTerms of one kf->frame pose (7,) or of a (K, 7) stack; the
    products with K stay f32 (TF32 is off package-wide), as the JAX
    sweep's Precision.HIGHEST matmuls."""
    f32 = dict(dtype=torch.float32, device=kf_to_ref.device)
    K = _intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, str(kf_to_ref.device))
    tef = torch.as_tensor(tracking_error_fac, **f32)
    if kf_to_ref.dim() == 1:
        R = lie.quat_to_matrix(kf_to_ref[0:4])            # (3, 3)
        t = kf_to_ref[4:7]
        return FrameTerms(KR=(K @ R)[None], Kt=(K @ t)[None], R=R[None],
                          t=t[None], tef=tef.reshape(1))
    R = lie.quat_to_matrix(kf_to_ref[:, 0:4])             # (K, 3, 3)
    t = kf_to_ref[:, 4:7]                                 # (K, 3)
    return FrameTerms(KR=K @ R, Kt=(t[:, None, :] @ K.T)[:, 0, :], R=R,
                      t=t, tef=tef.reshape(-1))


def line_stereo(xs, ys, prior_idepth, min_idepth, max_idepth, epxn, epyn,
                kf_img, kf_gx, kf_gy, ref_img,
                kf_to_ref, ref_to_kf, tracking_error_fac,
                cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
                use_subpixel: bool, k_sel=None):
    """Vectorized doLineStereo over a point set.

    xs/ys: (N,) pixel coordinates; per-point inputs share that shape;
    kf_img/ref_img are full (H, W). Returns (code, result_idepth,
    result_var, result_epl_length, best_match_err), each (N,).

    Multi-reference mode (k_sel not None): ref_img is a (K, H, W) stack,
    kf_to_ref / ref_to_kf are (K, 7), tracking_error_fac is (K,), and the
    (N,) int64 k_sel gives each point's reference frame (the per-pixel
    referenceFrameByID choice, DepthMap.cpp:302-329)."""
    terms = frame_terms(kf_to_ref, tracking_error_fac, cam)
    return line_stereo_points(xs, ys, prior_idepth, min_idepth, max_idepth,
                              epxn, epyn, kf_img, kf_gx, kf_gy, ref_img,
                              terms, cam, dcfg, mcfg, use_subpixel, k_sel)


def line_stereo_points(xs, ys, prior_idepth, min_idepth, max_idepth, epxn,
                       epyn, kf_img, kf_gx, kf_gy, ref_img,
                       terms: FrameTerms, cam: Camera,
                       dcfg: DepthFilterConfig, mcfg: MappingConfig,
                       use_subpixel: bool, k_sel=None):
    """`line_stereo` on given FrameTerms: the per-point search of the plain
    version of `epl_stereo` (k_sel None: frame 0 of `terms` and an (H, W)
    ref_img; else each point's frame k_sel of a (K, H, W) stack)."""
    assert dcfg.gradient_sample_dist <= 1.0, (
        "patch16 grouped EPL sampling requires gradient_sample_dist <= 1.0 "
        f"(got {dcfg.gradient_sample_dist})")
    h, w = kf_img.shape
    dev = xs.device
    f32 = dict(dtype=torch.float32, device=dev)

    if k_sel is None:
        KR, Kt, R_k2r, t_k2r = (terms.KR[0], terms.Kt[0], terms.R[0],
                                terms.t[0])
        tef = terms.tef[0]
    else:
        KR, Kt, R_k2r, t_k2r = (terms.KR[k_sel], terms.Kt[k_sel],
                                terms.R[k_sel], terms.t[k_sel])
        tef = terms.tef[k_sel]

    kx = (xs - cam.cx) / cam.fx
    ky = (ys - cam.cy) / cam.fy
    p_inf = (KR[..., :, 0] * kx[..., None] + KR[..., :, 1] * ky[..., None]
             + KR[..., :, 2])                           # (N, 3)

    safe_prior = torch.clamp_min(prior_idepth, _DIV_EPS)
    Kt_z = Kt[..., 2]
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
    kt_z_safe = torch.where(Kt_z == 0, torch.full_like(Kt_z, _DIV_EPS),
                            Kt_z)
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
    if k_sel is None:
        ref_patch = patch16_pack(ref_img)
        samp = patch16_sample(ref_patch, h, w, qx, qy)    # (N, G, 3)
    else:
        # the (K, h, w) stack as one tall (K*h, w) image: a point's rows
        # are y + k_sel*h. Real samples stay >= sample_point_to_border px
        # inside their own frame, so their 4x4 patches never straddle
        # frames; masked lattice tails may read a neighbouring frame's
        # pixels, as in the JAX sweep, and the in_search mask drops them
        n_ref = ref_img.shape[0]
        ref_patch = patch16_pack(ref_img.reshape(n_ref * h, w))
        y_off = (k_sel * h).to(torch.float32)[..., None, None]
        samp = patch16_sample(ref_patch, n_ref * h, w, qx, qy + y_off)
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
    dot0 = R_k2r[..., 0, 0] * kx + R_k2r[..., 0, 1] * ky + R_k2r[..., 0, 2]
    dot1 = R_k2r[..., 1, 0] * kx + R_k2r[..., 1, 1] * ky + R_k2r[..., 1, 2]
    dot2 = R_k2r[..., 2, 0] * kx + R_k2r[..., 2, 1] * ky + R_k2r[..., 2, 2]
    t0_, t1_, t2_ = t_k2r[..., 0], t_k2r[..., 1], t_k2r[..., 2]

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


class EplSetup(NamedTuple):
    """The per-pixel set-up of a sweep, (H, W) grids: the selected frame's
    EPL direction (epx, epy, scaled to gradient_sample_dist) and its
    checks (epl_ok), the update / create masks, the search priors, the
    `process` mask the compaction reads and the selected frame k_sel
    (int64; 0 with one reference frame). The kernel's set-up also carries
    the sweep's result grids filled with the not-processed values
    (`out`, which the search kernel writes into) and its zeroed stat
    counts (`stats`, int64 (9,) in OBSERVE_STAT_KEYS order, which the
    fusion kernel adds into): the kernels take their buffers from here
    only. The plain set-up leaves both None (the plain search makes its
    grids, the plain fusion its counts)."""
    epx: torch.Tensor
    epy: torch.Tensor
    epl_ok: torch.Tensor
    can_update: torch.Tensor
    can_create: torch.Tensor
    process: torch.Tensor
    prior: torch.Tensor
    min_id: torch.Tensor
    max_id: torch.Tensor
    k_sel: torch.Tensor
    out: Optional["StereoGrids"] = None
    stats: Optional[torch.Tensor] = None


class StereoGrids(NamedTuple):
    """A sweep's search results on the (H, W) grid: the outcome code
    (int32, SKIP where no point was searched), inverse depth, variance and
    EPL length (0, 0 and 1e9 there)."""
    code: torch.Tensor
    idepth: torch.Tensor
    var: torch.Tensor
    epl: torch.Tensor


def _kernels():
    from lsd_slam_tpu_torch.ops import epl_stereo
    return epl_stereo


def epl_setup(state: DepthMapState, kf_img, kf_max_grad, t_r2k,
              ref_ids: Sequence[float], good_masks, cam: Camera,
              dcfg: DepthFilterConfig, mcfg: MappingConfig,
              reactivated: bool = False) -> EplSetup:
    """The per-pixel set-up against K reference frames: t_r2k (K, 3) their
    ref->keyframe translations, ref_ids K f32 host numbers (ascending),
    good_masks (K, H, W). The kernel `epl_prepare` for CUDA tensors, the
    plain version for CPU ones (anything else raises)."""
    if kf_img.device.type == "cpu":
        return epl_setup_plain(state, kf_img, kf_max_grad, t_r2k, ref_ids,
                               good_masks, cam, dcfg, mcfg, reactivated)
    return _kernels().epl_prepare(state, kf_img, kf_max_grad, t_r2k,
                                  ref_ids, good_masks, cam, dcfg, mcfg,
                                  reactivated)


def epl_setup_plain(state: DepthMapState, kf_img, kf_max_grad, t_r2k,
                    ref_ids: Sequence[float], good_masks, cam: Camera,
                    dcfg: DepthFilterConfig, mcfg: MappingConfig,
                    reactivated: bool = False) -> EplSetup:
    """The plain version of `epl_prepare`. Each pixel picks its reference
    frame like referenceFrameByID (DepthMap.cpp:302-319): an update the
    oldest frame whose id reaches the pixel's nextStereoFrameMinID (with
    `reactivated`, one frame and no id gate), a creation the oldest frame;
    then makeAndCheckEPL (DepthMap.cpp:184-234) runs for that frame alone,
    which gives make_epl_multi's (K, H, W) stack gathered at k_sel, bit for
    bit (each pixel's value for a frame depends on nothing else)."""
    n_ref = t_r2k.shape[0]
    h, w = kf_img.shape
    dev = kf_img.device
    if reactivated and n_ref != 1:
        raise ValueError("epl_setup: `reactivated` takes one frame")
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    grad_ok = kf_max_grad >= mcfg.min_use_grad

    # --- per-pixel reference-frame selection (DepthMap.cpp:302-319) ---
    # (the ids compared as host numbers: a copy of them to the card would
    # wait for its stream)
    cmp = torch.stack([state.next_min_id <= float(np.float32(i))
                       for i in ref_ids])                        # (K,h,w)
    # the first frame that qualifies (argmax has no bool path)
    k_upd = torch.argmax(cmp.to(torch.int32), dim=0)
    has_upd = cmp[n_ref - 1]      # newest id >= next_min_id
    if reactivated:
        has_upd = torch.ones_like(has_upd)
    good_upd = torch.gather(good_masks, 0, k_upd[None])[0]
    can_update = state.valid & interior & grad_ok & good_upd & has_upd
    can_create = ((~state.valid) & interior & grad_ok & good_masks[0]
                  & (state.blacklisted >= dcfg.min_blacklist))
    k_sel = torch.where(can_update, k_upd, torch.zeros_like(k_upd))

    if n_ref == 1:
        (epx, epy), epl_ok = make_epl(t_r2k[0], kf_img, cam, dcfg)
    else:
        (epx, epy), epl_ok = make_epl(t_r2k[k_sel].permute(2, 0, 1),
                                      kf_img, cam, dcfg)

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
    process = (can_update | can_create) & epl_ok
    return EplSetup(epx, epy, epl_ok, can_update, can_create, process,
                    prior, min_id, max_id, k_sel)


def epl_search(setup: EplSetup, flat_idx, valid_k, kf_img, kf_gx, kf_gy,
               ref_stack, terms: FrameTerms, cam: Camera,
               dcfg: DepthFilterConfig, mcfg: MappingConfig) -> StereoGrids:
    """doLineStereo for the compacted slots (flat_idx, valid_k) of a
    set-up against the (K, H, W) reference stack; the results land on the
    grid. The kernel `epl_stereo` for CUDA tensors (writing into
    `setup.out`), the plain version for CPU ones."""
    if kf_img.device.type == "cpu":
        return epl_search_plain(setup, flat_idx, valid_k, kf_img, kf_gx,
                                kf_gy, ref_stack, terms, cam, dcfg, mcfg)
    return _kernels().epl_stereo(setup, flat_idx, valid_k, kf_img, kf_gx,
                                 kf_gy, ref_stack, terms, cam, dcfg, mcfg)


def epl_search_plain(setup: EplSetup, flat_idx, valid_k, kf_img, kf_gx,
                     kf_gy, ref_stack, terms: FrameTerms, cam: Camera,
                     dcfg: DepthFilterConfig, mcfg: MappingConfig
                     ) -> StereoGrids:
    """The plain version of `epl_stereo`: gather the slots' inputs,
    `line_stereo_points`, scatter the results to fresh grids (dump slot
    n_pix for the empty slots)."""
    h, w = kf_img.shape
    n_pix = h * w
    dev = kf_img.device

    def take(a):
        return a.reshape(-1)[flat_idx]

    xs_k = (flat_idx % w).to(torch.float32)
    ys_k = torch.div(flat_idx, w, rounding_mode="floor").to(torch.float32)
    multi = ref_stack.shape[0] > 1
    code_k, id_k, var_k, epl_k, _ = line_stereo_points(
        xs_k, ys_k, take(setup.prior), take(setup.min_id),
        take(setup.max_id), take(setup.epx), take(setup.epy), kf_img,
        take(kf_gx), take(kf_gy), ref_stack if multi else ref_stack[0],
        terms, cam, dcfg, mcfg, mcfg.use_subpixel_stereo,
        k_sel=take(setup.k_sel) if multi else None)

    tgt = torch.where(valid_k, flat_idx, n_pix)

    def scatter(vals, fill):
        buf = torch.full((n_pix + 1,), fill, dtype=vals.dtype, device=dev)
        buf[tgt] = vals
        return buf[:n_pix].reshape(h, w)

    return StereoGrids(scatter(code_k, SKIP), scatter(id_k, 0.0),
                       scatter(var_k, 0.0), scatter(epl_k, 1e9))


def fuse(state: DepthMapState, setup: EplSetup, grids: StereoGrids,
         valid_k, kf_max_grad, ref_ids: Sequence[float], skip_inc: float,
         dcfg: DepthFilterConfig):
    """The create / EKF-update / fail lattice on a sweep's results. The
    kernel `observe_fuse` for CUDA tensors (its counts added into
    `setup.stats`), the plain version for CPU ones. Returns (new_state,
    stats)."""
    if state.idepth.device.type == "cpu":
        return fuse_plain(state, setup, grids, valid_k, kf_max_grad,
                          ref_ids, skip_inc, dcfg)
    return _kernels().observe_fuse(state, setup, grids, kf_max_grad, ref_ids,
                                   skip_inc, dcfg)


def fuse_plain(state: DepthMapState, setup: EplSetup, grids: StereoGrids,
               valid_k, kf_max_grad, ref_ids: Sequence[float],
               skip_inc: float, dcfg: DepthFilterConfig):
    """The plain version of `observe_fuse`: `_fuse_results` with the
    observing frame's id, a host number for one frame, the selected
    frame's per pixel for several."""
    ids = [float(np.float32(i)) for i in ref_ids]
    if len(ids) == 1:
        ref_id = ids[0]
    else:
        ref_id = torch.tensor(ids, dtype=torch.float32,
                              device=state.idepth.device)[setup.k_sel]
    return _fuse_results(state, grids.code, grids.idepth, grids.var,
                         grids.epl, setup.can_update, setup.can_create,
                         setup.epl_ok, kf_max_grad, ref_id, skip_inc, dcfg,
                         setup.process, valid_k)


def _default_budget(h: int, w: int, point_budget: int) -> int:
    if point_budget > 0:
        return point_budget
    return max(8192, -(-(h * w) // 6 // 8192) * 8192)


def observe(state: DepthMapState, kf_img, kf_gx, kf_gy, kf_max_grad,
            ref_img, ref_to_kf, ref_frame_id: float, good_mask,
            tracking_residual, skip_inc: float,
            cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
            reactivated: bool = False, point_budget: int = 0):
    """One observation sweep against one tracked frame (DepthMap.cpp:105-473)
    with the active set compacted to a fixed budget. ref_frame_id and
    skip_inc are host numbers (f32 values). Returns (new_state, stats).

    Four stages: the per-pixel set-up (`epl_setup`), the compaction
    (torch ops), the search (`epl_search`) and the fusion (`fuse`); on the
    card each stage but the compaction is one kernel launch."""
    h, w = kf_img.shape
    point_budget = _default_budget(h, w, point_budget)
    kf_to_ref = lie.se3_inverse(ref_to_kf)
    ref_id = float(np.float32(ref_frame_id))

    setup = epl_setup(state, kf_img, kf_max_grad, ref_to_kf[None, 4:7],
                      [ref_id], good_mask[None], cam, dcfg, mcfg,
                      reactivated)
    flat_idx, valid_k = compact_active(
        setup.process, frame_shift(ref_id, h * w), point_budget)
    terms = frame_terms(kf_to_ref, 0.25 * (1.0 + tracking_residual), cam)
    grids = epl_search(setup, flat_idx, valid_k, kf_img, kf_gx, kf_gy,
                       ref_img[None], terms, cam, dcfg, mcfg)
    return fuse(state, setup, grids, valid_k, kf_max_grad, [ref_id],
                skip_inc, dcfg)


def make_epl_multi(t_r2k_stack, kf_img, cam: Camera, cfg: DepthFilterConfig):
    """Per-frame epipolar directions / validity for a (K, 7) stack of
    reference frames: makeAndCheckEPL (DepthMap.cpp:184-234) over the frame
    axis, with the keyframe gradient computed once. Returns ((epx, epy),
    ok), each (K, H, W)."""
    h, w = kf_img.shape
    ys, xs = _grid(h, w, kf_img.device)
    tx = t_r2k_stack[:, 0][:, None, None]
    ty = t_r2k_stack[:, 1][:, None, None]
    tz = t_r2k_stack[:, 2][:, None, None]
    epx = -cam.fx * tx + tz * (xs - cam.cx)[None]          # (K, h, w)
    epy = -cam.fy * ty + tz * (ys - cam.cy)[None]
    finite = torch.isfinite(epx + epy)

    lsq = epx * epx + epy * epy
    ok_len = lsq >= cfg.min_epl_length_squared

    gx = torch.zeros_like(kf_img)
    gy = torch.zeros_like(kf_img)
    gx[:, 1:-1] = kf_img[:, 2:] - kf_img[:, :-2]
    gy[1:-1, :] = kf_img[2:, :] - kf_img[:-2, :]
    dot = gx[None] * epx + gy[None] * epy
    safe_lsq = torch.clamp_min(lsq, _DIV_EPS)
    egs = dot * dot / safe_lsq
    ok_grad = egs >= cfg.min_epl_grad_squared
    ok_angle = (egs / torch.clamp_min(gx * gx + gy * gy, _DIV_EPS)[None]
                >= cfg.min_epl_angle_squared)

    fac = cfg.gradient_sample_dist / torch.sqrt(safe_lsq)
    return (epx * fac, epy * fac), (finite & ok_len & ok_grad & ok_angle)


def observe_multi(state: DepthMapState, kf_img, kf_gx, kf_gy, kf_max_grad,
                  ref_stack, ref_to_kf, ref_ids, good_masks,
                  tracking_residuals, skip_inc: float,
                  cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
                  point_budget: int = 0):
    """One observation sweep against a queue of tracked frames: the
    mapping thread's whole-deque updateKeyframe (SlamSystem.cpp:542-571,
    DepthMap.cpp:1072-1101). Each pixel picks its reference frame like
    referenceFrameByID: the oldest queued frame whose id satisfies the
    pixel's nextStereoFrameMinID (DepthMap.cpp:302-319); creation uses the
    oldest frame. (The JAX function's `reactivated` branch, the newest
    frame for every pixel, has no caller in either engine.)

    ref_stack (K, h, w); ref_to_kf (K, 7); ref_ids: K host numbers (f32
    values), non-decreasing; good_masks (K, h, w) bool;
    tracking_residuals (K,) f32; skip_inc a host number. Returns
    (new_state, stats). The stages are `observe`'s."""
    n_ref, h, w = ref_stack.shape
    point_budget = _default_budget(h, w, point_budget)
    kf_to_ref = lie.se3_inverse(ref_to_kf)
    ids = [float(np.float32(i)) for i in ref_ids]

    setup = epl_setup(state, kf_img, kf_max_grad, ref_to_kf[:, 4:7], ids,
                      good_masks, cam, dcfg, mcfg)
    # the roll comes from the NEWEST id
    flat_idx, valid_k = compact_active(
        setup.process, frame_shift(ids[-1], h * w), point_budget)
    terms = frame_terms(kf_to_ref, 0.25 * (1.0 + tracking_residuals), cam)
    grids = epl_search(setup, flat_idx, valid_k, kf_img, kf_gx, kf_gy,
                       ref_stack, terms, cam, dcfg, mcfg)
    return fuse(state, setup, grids, valid_k, kf_max_grad, ids, skip_inc,
                dcfg)


def _fuse_results(state, code, r_idepth, r_var, r_epl, can_update,
                  can_create, epl_ok, kf_max_grad, ref_id, skip_inc,
                  dcfg, process, valid_k):
    """Create/EKF-update/fail lattice (observeDepthCreate /
    observeDepthUpdate, DepthMap.cpp:237-470). ref_id is the observing
    frame's id: a host number in single-reference mode, an (H, W) grid in
    multi-reference mode."""
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

    # rounded as the XLA program does: x / 255 becomes x * f32(1/255), the
    # two constants fold into one f32 factor, then one fused multiply-add
    # (the exact product in f64). fill_holes compares 5x5 validity sums
    # with integer thresholds, so an ulp here can flip a hole fill.
    cap_fac = float(np.float32(dcfg.validity_counter_max_variable)
                    * np.float32(1.0 / 255.0))
    validity_cap = (kf_max_grad.double() * cap_fac
                    + dcfg.validity_counter_max).to(torch.float32)

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
