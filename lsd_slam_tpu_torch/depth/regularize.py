"""Spatial regularization, hole-filling and propagation sweeps (torch).

Port of lsd_slam_tpu/depth/regularize.py (DepthMap.cpp:475-880):
  * regularize: 5x5 inverse-variance smoothing with a distance prior and
    the deletion/keep epilogue, in one call of `ops.regularize_stencil`'s
    `regularize_fused` (the CUDA kernel on the card, the plain lattice and
    epilogue on the CPU);
  * fill_holes: validity integral image via two cumsums + 5x5 neighbour
    fusion (DepthMap.cpp:656-754);
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
import torch.nn.functional as F

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import DepthFilterConfig, MappingConfig
from lsd_slam_tpu_torch.ops.interp import bilinear, trunc_int
from lsd_slam_tpu_torch.ops.regularize_stencil import regularize_fused
from lsd_slam_tpu_torch.ops.scatter import ordered_index_add
from lsd_slam_tpu_torch.depth.state import DepthMapState

_DIV_EPS = 1e-10


def _prefix_seq(x):
    """Sequential f32 prefix sum along the last dim."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def _cumsum_last(x, base: int = 16):
    """f32 cumsum along the last dim in XLA's order: 16-wide blocks summed
    sequentially, block totals scanned recursively, then offset. This is
    bit-identical to the JAX package's `jnp.cumsum` on the CPU; torch.cumsum
    accumulates in double on the CPU and in yet another order on the card,
    and the integral image below subtracts large sums, so the order shows."""
    n = x.shape[-1]
    if n <= base:
        return _prefix_seq(x)
    nb = -(-n // base)
    xp = F.pad(x, (0, nb * base - n))
    inner = _prefix_seq(xp.reshape(x.shape[:-1] + (nb, base)))
    incl = _cumsum_last(inner[..., base - 1], base)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    return (inner + excl[..., None]).reshape(xp.shape)[..., :n]


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
    """Create hypotheses at well-supported holes (DepthMap.cpp:656-754)."""
    h, w = state.idepth.shape
    dev = state.idepth.device
    vc = torch.where(state.valid, state.validity,
                     torch.zeros_like(state.validity))
    integral = _cumsum_last(_cumsum_last(vc).T).T

    # 5x5 inclusive window sum via the integral image
    pad = F.pad(integral[None, None], (3, 2, 3, 2))[0, 0]
    val5 = (pad[5:, 5:] - pad[:-5, 5:] - pad[5:, :-5] + pad[:-5, :-5])

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    region = (ys >= 3) & (ys < h - 2) & (xs >= 3) & (xs < w - 2)

    eligible = (~state.valid) & region & (kf_max_grad >= min_abs_grad)
    create = eligible & (
        ((state.blacklisted >= dcfg.min_blacklist)
         & (val5 > dcfg.val_sum_min_for_create))
        | (val5 > dcfg.val_sum_min_for_unblacklist))

    # 5x5 inverse-variance neighbour fusion from the pre-pass snapshot
    p_id = F.pad(state.idepth[None, None], (2, 2, 2, 2))[0, 0]
    p_var = F.pad(state.var[None, None], (2, 2, 2, 2), value=1.0)[0, 0]
    p_val = F.pad(state.valid.to(torch.float32)[None, None],
                  (2, 2, 2, 2))[0, 0]
    sum_obs = torch.zeros_like(state.idepth)
    sum_ivar = torch.zeros_like(state.idepth)
    zero = torch.zeros_like(state.idepth)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sl = (slice(2 + dy, 2 + dy + h), slice(2 + dx, 2 + dx + w))
            m = p_val[sl] > 0
            s_id, s_var = p_id[sl], p_var[sl]
            # x * mask is select(mask, x, 0) in the XLA program
            sum_obs = sum_obs + torch.where(m, s_id / s_var, zero)
            sum_ivar = sum_ivar + torch.where(m, 1.0 / s_var, zero)

    new_id = sum_obs / torch.clamp_min(sum_ivar, _DIV_EPS)
    new_id = torch.where(torch.abs(new_id) < _DIV_EPS,
                         torch.full_like(new_id, _DIV_EPS), new_id)
    create = create & (sum_ivar > 0)

    neg = torch.full_like(state.idepth, -1.0)
    return state.replace(
        valid=state.valid | create,
        idepth=torch.where(create, new_id, state.idepth),
        var=torch.where(create, torch.full_like(state.var,
                                                dcfg.var_random_init_initial),
                        state.var),
        validity=torch.where(create, torch.zeros_like(state.validity),
                             state.validity),
        idepth_smoothed=torch.where(create, neg, state.idepth_smoothed),
        var_smoothed=torch.where(create, neg, state.var_smoothed),
    )


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
