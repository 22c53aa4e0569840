"""Spatial regularization, hole-filling and propagation sweeps (torch).

Port of lsd_slam_tpu/depth/regularize.py (DepthMap.cpp:475-880):
  * regularize: 5x5 inverse-variance smoothing with a distance prior and
    the deletion/keep epilogue, in one call of `ops.regularize_stencil`'s
    `regularize_fused` (the CUDA kernel on the card, the plain lattice and
    epilogue on the CPU);
  * fill_holes: validity integral image + 5x5 window sums + 5x5
    neighbour fusion (DepthMap.cpp:656-754), in one call of
    `ops.regularize_stencil`'s `fill_holes` (on the card the two launches
    of csrc/fill_holes.cu, which replaces the XLA-fused jnp code of
    lsd_slam_tpu/depth/regularize.py:121, no Pallas kernel; on the CPU its
    plain version, the op-for-op port of that code);
  * propagate: reprojection into the new keyframe as a two-pass scatter —
    scatter-max of idepth picks the nearest hypothesis per target pixel,
    then a compatibility-gated scatter-add merges (DepthMap.cpp:475-653).

Pass 1 (`amax`) sends dropped sources to a dump slot h*w that is sliced
off, as in the JAX version; it is order-independent. Pass 2 is a float
scatter-add through `ops.scatter.ordered_index_add`: each target pixel sums
its compatible sources in source order, sequentially on the CPU and
through the order-fixed segment-sum kernel on the card, so a run gives the
same bits every time. Its dropped sources add +0.0 at their own pixel
instead of the dump slot: the sums start at +0 and only grow, so an added
+0.0 changes no bit, and no single target collects every dropped pixel.
"""

from __future__ import annotations

import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import DepthFilterConfig, MappingConfig
from lsd_slam_tpu_torch.ops.interp import bilinear, trunc_int
from lsd_slam_tpu_torch.ops.regularize_stencil import fill_holes as \
    fill_holes_planes, regularize_fused
from lsd_slam_tpu_torch.ops.scatter import ordered_index_add
from lsd_slam_tpu_torch.depth.state import DepthMapState

_DIV_EPS = 1e-10


def regularize(state: DepthMapState, remove_occlusions: bool,
               validity_th: float, dcfg: DepthFilterConfig,
               smoothing_factor: float = 1.0) -> DepthMapState:
    """5x5 smoothing into idepth_smoothed / var_smoothed, validity-sum
    deletion, optional occlusion removal: one `regularize_fused` call."""
    reg_dist_var = dcfg.reg_dist_var_base * smoothing_factor * smoothing_factor
    valid, blacklisted, smoothed, var_smoothed = regularize_fused(
        state.idepth, state.var, state.valid, state.validity,
        state.idepth_smoothed, state.var_smoothed, state.blacklisted,
        float(reg_dist_var), float(dcfg.diff_fac_smoothing),
        float(validity_th), remove_occlusions)
    return state.replace(valid=valid, blacklisted=blacklisted,
                         idepth_smoothed=smoothed, var_smoothed=var_smoothed)


def fill_holes(state: DepthMapState, kf_max_grad, dcfg: DepthFilterConfig,
               min_abs_grad: float) -> DepthMapState:
    """Create hypotheses at well-supported holes (DepthMap.cpp:656-754):
    one `fill_holes_planes` call."""
    valid, idepth, var, validity, smoothed, var_smoothed = fill_holes_planes(
        state.valid, state.idepth, state.var, state.validity,
        state.blacklisted, kf_max_grad, state.idepth_smoothed,
        state.var_smoothed, min_abs_grad, dcfg.min_blacklist,
        dcfg.val_sum_min_for_create, dcfg.val_sum_min_for_unblacklist,
        dcfg.var_random_init_initial)
    return state.replace(valid=valid, idepth=idepth, var=var,
                         validity=validity, idepth_smoothed=smoothed,
                         var_smoothed=var_smoothed)


def propagate(state: DepthMapState, old_to_new_se3, kf_img, new_img,
              new_max_grad, good_mask, have_good_mask,
              cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig):
    """Reproject all hypotheses into a new keyframe (DepthMap.cpp:475-653).

    good_mask: the tracker's good-pixel grid of the new keyframe, full-res."""
    h, w = state.idepth.shape
    dev = state.idepth.device
    R = lie.quat_to_matrix(old_to_new_se3[0:4])
    t = old_to_new_se3[4:7]

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)

    ones = torch.ones_like(state.idepth)
    src_valid = state.valid & (state.idepth_smoothed > _DIV_EPS)
    safe_id = torch.where(src_valid, state.idepth_smoothed, ones)
    kx = (xs - cam.cx) / cam.fx
    ky = (ys - cam.cy) / cam.fy
    pnx = (R[0, 0] * kx + R[0, 1] * ky + R[0, 2]) / safe_id + t[0]
    pny = (R[1, 0] * kx + R[1, 1] * ky + R[1, 2]) / safe_id + t[1]
    pnz = (R[2, 0] * kx + R[2, 1] * ky + R[2, 2]) / safe_id + t[2]

    safe_z = torch.where(pnz == 0, torch.full_like(pnz, _DIV_EPS), pnz)
    new_idepth = 1.0 / safe_z
    u_new = pnx * new_idepth * cam.fx + cam.cx
    v_new = pny * new_idepth * cam.fy + cam.cy

    in_b = (u_new > 2.1) & (v_new > 2.1) & (u_new < w - 3.1) \
        & (v_new < h - 3.1)
    keep = src_valid & in_b & (pnz > 0)

    tx = torch.clamp(trunc_int(u_new + 0.5), 0, w - 1)
    ty = torch.clamp(trunc_int(v_new + 0.5), 0, h - 1)
    dest_grad = new_max_grad[ty, tx]

    if have_good_mask:
        keep = keep & good_mask & (dest_grad >= mcfg.min_use_grad)
    else:
        dest_color = bilinear(new_img, u_new, v_new)
        resid = dest_color - kf_img
        bad_color = (resid * resid
                     / (1600.0 + 0.25 * dest_grad * dest_grad)) > 1.0
        keep = keep & ~bad_color & (dest_grad >= mcfg.min_use_grad)

    # variance grows with (d_new/d_old)^4 (DepthMap.cpp:574-580)
    ratio = new_idepth / torch.where(src_valid, safe_id, ones)
    r2 = ratio * ratio  # x**4 as XLA's integer_pow: (x*x)*(x*x)
    new_var = (r2 * r2) * state.var

    flat_idx = (ty * w + tx).reshape(-1)
    keep_f = keep.reshape(-1)
    idx_or_oob = torch.where(keep_f, flat_idx, h * w)  # dump slot h*w

    src_id = new_idepth.reshape(-1)
    src_var = torch.clamp_min(new_var.reshape(-1), _DIV_EPS)
    src_validity = state.validity.reshape(-1)
    zero = torch.zeros_like(src_id)
    ninf = torch.full_like(src_id, float("-inf"))

    # pass 1: nearest (max idepth) hypothesis per target
    maxbuf = torch.full((h * w + 1,), float("-inf"), device=dev)
    maxbuf.scatter_reduce_(0, idx_or_oob, torch.where(keep_f, src_id, ninf),
                           "amax")
    tgt_max = maxbuf[idx_or_oob]
    is_max = keep_f & (src_id == tgt_max)
    maxvarbuf = torch.zeros((h * w + 1,), device=dev)
    maxvarbuf.scatter_reduce_(0, idx_or_oob,
                              torch.where(is_max, src_var, zero), "amax")
    tgt_max_var = maxvarbuf[idx_or_oob]

    # pass 2: merge everything compatible with the nearest hypothesis
    diff = src_id - tgt_max
    compatible = keep_f & (dcfg.diff_fac_prop_merge * diff * diff
                           <= src_var + tgt_max_var)

    # a dropped source adds +0.0 at its own pixel (see the module note);
    # the four sums in one (h*w, 4) call, each column its own fold
    terms = torch.stack([src_id / src_var, 1.0 / src_var, src_validity,
                         torch.ones_like(src_id)], dim=1)
    id_sum, ivar_sum, validity_sum, count = ordered_index_add(
        torch.zeros((h * w, 4), device=dev),
        torch.where(compatible, flat_idx, torch.arange(h * w, device=dev)),
        torch.where(compatible[:, None], terms, zero[:, None])).unbind(1)

    tgt_valid = (count > 0).reshape(h, w)
    safe_ivar = torch.clamp_min(ivar_sum, _DIV_EPS).reshape(h, w)
    zeros = torch.zeros((h, w), device=dev)
    tgt_id = torch.where(tgt_valid, id_sum.reshape(h, w) / safe_ivar,
                         zeros)
    tgt_var = torch.where(tgt_valid, 1.0 / safe_ivar, zeros)
    validity_cap = dcfg.validity_counter_max \
        + dcfg.validity_counter_max_variable
    tgt_validity = torch.where(
        tgt_valid,
        torch.clamp_max(validity_sum.reshape(h, w), validity_cap), zeros)

    return DepthMapState(
        valid=tgt_valid,
        idepth=torch.where(tgt_valid, _unzero_like(tgt_id), zeros),
        var=tgt_var,
        idepth_smoothed=torch.full((h, w), -1.0, device=dev),
        var_smoothed=torch.full((h, w), -1.0, device=dev),
        validity=tgt_validity,
        blacklisted=torch.zeros((h, w), dtype=torch.int32, device=dev),
        next_min_id=torch.zeros((h, w), device=dev),
    )


def _unzero_like(x):
    eps = torch.where(x < 0, torch.full_like(x, -_DIV_EPS),
                      torch.full_like(x, _DIV_EPS))
    return torch.where(torch.abs(x) < _DIV_EPS, eps, x)
