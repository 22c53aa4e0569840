"""DepthMap orchestrator: the per-keyframe mapping engine (torch).

Port of lsd_slam_tpu/depth/depth_map.py (DepthMap.h:53-84). The JAX
package's jitted programs become plain functions on DepthMapState:
`observe_program` (observe + fill holes + regularize + export, one per
tracked frame), `observe_multi_program` (the same over a queue of tracked
frames, one multi-reference sweep per chunk of at most
`MULTI_REF_BUCKETS[-1]` frames), `create_kf_program` (propagate,
regularize, fill holes, regularize, renormalize), `finalize_program`,
`set_from_existing_program` (keyframe re-activation), `init_random`,
`init_gt` and `export_arrays`.
The static observe budget buckets are kept: the budget decides which
pixels a sweep truncates, so it must match.

The JAX package pads a queue chunk to its bucket size (4 or 8) by
replicating the newest frame, so that XLA compiles two programs. The port
does not pad: a replica of the newest frame is never selected (its id
equals the newest's, and selection takes the first qualifying frame), so
the result is the same (tests/test_torch_observe_multi.py holds the port's
unpadded chunks to the JAX package's padded ones).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth.state import DepthMapState
from lsd_slam_tpu_torch.depth import observe as observe_mod
from lsd_slam_tpu_torch.depth import regularize as reg_mod
from lsd_slam_tpu_torch.utils.stats import NULL_TIMERS


def observe_budget_full(h: int, w: int) -> int:
    """Default (maximum) observe point budget: ~grid/6 rounded to 8192."""
    return max(8192, -(-(h * w) // 6 // 8192) * 8192)


def observe_budget_buckets(h: int, w: int):
    """The static budget sizes an observe sweep may use."""
    full = observe_budget_full(h, w)
    return tuple(b for b in (8192, 16384, 32768) if b < full) + (full,)


def pick_observe_budget(h: int, w: int, last_active) -> int:
    """Smallest bucket covering ~1.2x the previous sweep's eligible count
    (see lsd_slam_tpu.depth.depth_map.pick_observe_budget)."""
    buckets = observe_budget_buckets(h, w)
    if last_active is None:
        return buckets[-1]
    need = 1.2 * float(last_active)
    for b in buckets:
        if b >= need:
            return b
    return buckets[-1]


# queue-drain sweep sizes of the JAX package; a longer queue maps in
# chunks of the largest, which changes results, so the chunking is kept
MULTI_REF_BUCKETS = (4, 8)


def upsample_mask(small: torch.Tensor, cfg: LSDConfig) -> torch.Tensor:
    """Tracker good-mask (min level) -> full resolution ((x >> lvl)
    indexing, DepthMap.cpp:322-329)."""
    if tuple(small.shape[-2:]) == (cfg.height, cfg.width):
        return small
    f = 1 << cfg.tracker.min_level
    return small.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1)


def export_arrays(state: DepthMapState):
    """Frame::setDepth export (Frame.cpp:199-243): (idepth0, ivar0,
    mean_idepth, num_points) as device tensors."""
    ok = state.valid & (state.idepth_smoothed >= -0.05)
    neg = torch.full_like(state.idepth_smoothed, -1.0)
    idepth0 = torch.where(ok, state.idepth_smoothed, neg)
    ivar0 = torch.where(ok, state.var_smoothed, neg)
    num = torch.clamp_min(torch.sum(ok), 1)
    mean_idepth = torch.sum(torch.where(
        ok, state.idepth_smoothed,
        torch.zeros_like(state.idepth_smoothed))) / num
    return idepth0, ivar0, mean_idepth, torch.sum(ok)


def observe_program(state, kf_img, kf_gx, kf_gy, kf_max_grad, ref_img,
                    ref_to_kf, ref_id, good_mask, tracking_residual,
                    skip_inc, cam: Camera, cfg: LSDConfig,
                    point_budget: int = 0):
    """Observe sweep, then fill holes, regularize(keep) and the depth export
    (updateKeyframe, DepthMap.cpp:1129-1153). Returns (state, stats,
    export)."""
    dcfg, mcfg = cfg.depth, cfg.mapping
    state, stats = observe_mod.observe(
        state, kf_img, kf_gx, kf_gy, kf_max_grad, ref_img, ref_to_kf,
        ref_id, upsample_mask(good_mask, cfg), tracking_residual,
        skip_inc, cam, dcfg, mcfg, point_budget=point_budget)
    state = reg_mod.fill_holes(state, kf_max_grad, dcfg, mcfg.min_use_grad)
    state = reg_mod.regularize(state, False, dcfg.val_sum_min_for_keep,
                               dcfg, mcfg.depth_smoothing_factor)
    return state, stats, export_arrays(state)


def observe_multi_program(state, kf_img, kf_gx, kf_gy, kf_max_grad,
                          ref_stack, ref_to_kf, ref_ids, good_masks,
                          tracking_residuals, skip_inc, cam: Camera,
                          cfg: LSDConfig, point_budget: int = 0):
    """The batch-drain sweep: one multi-reference observe over a queue of
    tracked frames (DepthMap::updateKeyframe with the whole unmapped deque,
    DepthMap.cpp:1072-1101, 302-319), then fill holes, regularize(keep) and
    the export. good_masks is a (K, h, w) stack at the tracker's min level.
    Returns (state, stats, export)."""
    dcfg, mcfg = cfg.depth, cfg.mapping
    state, stats = observe_mod.observe_multi(
        state, kf_img, kf_gx, kf_gy, kf_max_grad, ref_stack, ref_to_kf,
        ref_ids, upsample_mask(good_masks, cfg), tracking_residuals,
        skip_inc, cam, dcfg, mcfg, point_budget=point_budget)
    state = reg_mod.fill_holes(state, kf_max_grad, dcfg, mcfg.min_use_grad)
    state = reg_mod.regularize(state, False, dcfg.val_sum_min_for_keep,
                               dcfg, mcfg.depth_smoothing_factor)
    return state, stats, export_arrays(state)


def create_kf_program(state, old_to_new, kf_img, new_img, new_max_grad,
                      good_mask, have_good_mask: bool, cam: Camera,
                      cfg: LSDConfig):
    """createKeyFrame sequence (DepthMap.cpp:1222-1306). Returns (state,
    rescale) with rescale a device scalar."""
    dcfg, mcfg = cfg.depth, cfg.mapping
    state = reg_mod.propagate(state, old_to_new, kf_img, new_img,
                              new_max_grad, upsample_mask(good_mask, cfg),
                              have_good_mask, cam, dcfg, mcfg)
    state = reg_mod.regularize(state, True, dcfg.val_sum_min_for_keep,
                               dcfg, mcfg.depth_smoothing_factor)
    state = reg_mod.fill_holes(state, new_max_grad, dcfg, mcfg.min_use_grad)
    state = reg_mod.regularize(state, False, dcfg.val_sum_min_for_keep,
                               dcfg, mcfg.depth_smoothing_factor)
    # renormalize mean inverse depth to 1 (DepthMap.cpp:1285-1306)
    m = state.valid.to(torch.float32)
    num = torch.clamp_min(torch.sum(m), 1.0)
    mean_id = torch.sum(torch.where(
        state.valid, state.idepth_smoothed,
        torch.zeros_like(state.idepth_smoothed))) / num
    rescale = 1.0 / torch.clamp_min(mean_id, 1e-6)
    r2 = rescale * rescale
    v = state.valid
    state = state.replace(
        idepth=torch.where(v, state.idepth * rescale, state.idepth),
        idepth_smoothed=torch.where(v, state.idepth_smoothed * rescale,
                                    state.idepth_smoothed),
        var=torch.where(v, state.var * r2, state.var),
        var_smoothed=torch.where(v, state.var_smoothed * r2,
                                 state.var_smoothed),
    )
    return state, rescale


def finalize_program(state, kf_max_grad, cfg: LSDConfig):
    """finalizeKeyFrame (DepthMap.cpp:1363-1390)."""
    dcfg, mcfg = cfg.depth, cfg.mapping
    state = reg_mod.fill_holes(state, kf_max_grad, dcfg, mcfg.min_use_grad)
    return reg_mod.regularize(state, False, dcfg.val_sum_min_for_keep,
                              dcfg, mcfg.depth_smoothing_factor)


def set_from_existing_program(re_idepth, re_var, re_validity,
                              cfg: LSDConfig) -> DepthMapState:
    """setFromExistingKF (DepthMap.cpp:920-962): rebuild the state from a
    keyframe's re-activation snapshot, then regularize without removing
    occlusions."""
    dcfg, mcfg = cfg.depth, cfg.mapping
    valid = re_var > 0
    zero = torch.zeros_like(re_idepth)
    neg = torch.full_like(re_idepth, -1.0)
    state = DepthMapState(
        valid=valid,
        idepth=torch.where(valid, re_idepth, zero),
        var=torch.where(valid, re_var, zero),
        idepth_smoothed=neg,
        var_smoothed=neg.clone(),
        validity=torch.where(valid, re_validity, zero),
        blacklisted=torch.where(
            ~valid & (re_var == -2.0),
            torch.full(re_var.shape, dcfg.min_blacklist - 1,
                       dtype=torch.int32, device=re_var.device),
            torch.zeros(re_var.shape, dtype=torch.int32,
                        device=re_var.device)),
        next_min_id=torch.zeros_like(re_idepth),
    )
    return reg_mod.regularize(state, False, dcfg.val_sum_min_for_keep, dcfg,
                              mcfg.depth_smoothing_factor)


def _seeded_state(valid, idepth, var0, cfg: LSDConfig) -> DepthMapState:
    h, w = valid.shape
    dev = valid.device
    zero = torch.zeros_like(idepth)
    neg = torch.full_like(idepth, -1.0)
    var = torch.full_like(idepth, var0)
    return DepthMapState(
        valid=valid,
        idepth=torch.where(valid, idepth, zero),
        var=torch.where(valid, var, zero),
        # seeded states set smoothed values directly (DepthMap.cpp:897-903)
        idepth_smoothed=torch.where(valid, idepth, neg),
        var_smoothed=torch.where(valid, var, neg),
        validity=torch.where(valid, torch.full_like(idepth, 20.0), zero),
        blacklisted=torch.zeros((h, w), dtype=torch.int32, device=dev),
        next_min_id=torch.zeros((h, w), dtype=torch.float32, device=dev),
    )


def _interior1(kf_max_grad):
    m = torch.zeros(kf_max_grad.shape, dtype=torch.bool,
                    device=kf_max_grad.device)
    m[1:-1, 1:-1] = True
    return m


def init_random(idepth_draw, kf_max_grad, cfg: LSDConfig) -> DepthMapState:
    """initializeRandomly (DepthMap.cpp:885-905) from a drawn (H, W) plane
    of uniform [0.5, 1.5) inverse depths."""
    valid = _interior1(kf_max_grad) & (kf_max_grad > cfg.mapping.min_use_grad)
    return _seeded_state(valid, idepth_draw.to(torch.float32),
                         cfg.depth.var_random_init_initial, cfg)


def init_gt(gt_idepth, kf_max_grad, cfg: LSDConfig) -> DepthMapState:
    """initializeFromGTDepth (DepthMap.cpp:907-918)."""
    valid = (_interior1(kf_max_grad) & (kf_max_grad > cfg.mapping.min_use_grad)
             & (gt_idepth > 0))
    return _seeded_state(valid, gt_idepth.to(torch.float32),
                         cfg.depth.var_gt_init_initial, cfg)


class DepthMap:
    """Semi-dense depth filter bound to one camera/config and device."""

    def __init__(self, cam: Camera, cfg: LSDConfig, device):
        self.cam = cam
        self.cfg = cfg
        self.device = torch.device(device)
        self.state: Optional[DepthMapState] = None
        self._fresh_export = None
        # the engine's StageTimers (SlamSystem sets it): pulls are spans
        self.timers = NULL_TIMERS
        # previous sweep's eligible-pixel count -> next sweep's budget
        self.last_active = None
        # the last update's sweeps: (point budget, eligible count as a
        # device scalar), one a chunk
        self.sweeps = []
        self.num_frames_tracked_on_this = 0
        self.num_mapped_on_this = 0

    # ------------------------------------------------------------------ API

    def is_valid(self) -> bool:
        return self.state is not None

    def pick_budget(self) -> int:
        la = self.last_active
        if la is not None and not isinstance(la, float):
            la = float(la)
            self.last_active = la
        return pick_observe_budget(self.cfg.height, self.cfg.width, la)

    def _reset_counts(self):
        self.last_active = None
        self.num_frames_tracked_on_this = 0
        self.num_mapped_on_this = 0

    def initialize_randomly(self, kf_max_grad, seed: int = 0):
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        draw = torch.rand(kf_max_grad.shape, generator=g,
                          device=self.device) + 0.5
        self.state = init_random(draw, kf_max_grad, self.cfg)
        self._reset_counts()

    def initialize_from_gt(self, gt_idepth, kf_max_grad):
        self.state = init_gt(gt_idepth, kf_max_grad, self.cfg)
        self._reset_counts()

    def set_from_existing_kf(self, re_idepth, re_var, re_validity):
        """Re-activate a keyframe from its snapshot (host numpy once the
        keyframe was minimized, else device tensors)."""
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=self.device)
        self._fresh_export = None
        self.state = set_from_existing_program(
            dev(re_idepth), dev(re_var), dev(re_validity), self.cfg)
        self._reset_counts()

    def snapshot(self):
        """State references (tensors are never updated in place)."""
        return (self.state, self._fresh_export, self.num_mapped_on_this,
                self.num_frames_tracked_on_this, self.last_active)

    def restore(self, snap):
        (self.state, self._fresh_export, self.num_mapped_on_this,
         self.num_frames_tracked_on_this, self.last_active) = snap

    def create_keyframe(self, old_to_new, old_kf_img, new_pyr, good_mask,
                        have_good_mask: bool) -> float:
        """Propagate into a new keyframe; returns the idepth rescale factor
        the caller absorbs into thisToParent (DepthMap.cpp:1285-1306)."""
        self._fresh_export = None
        self.state, rescale = create_kf_program(
            self.state, old_to_new, old_kf_img, new_pyr.images[0],
            new_pyr.max_grad[0], good_mask, bool(have_good_mask), self.cam,
            self.cfg)
        self._reset_counts()
        with self.timers.span("pull.switch"):
            return float(rescale)

    def finalize_keyframe(self, kf_max_grad):
        self._fresh_export = None
        self.state = finalize_program(self.state, kf_max_grad, self.cfg)

    def export_depth(self) -> Tuple[torch.Tensor, torch.Tensor, float, int]:
        """(idepth0, ivar0, mean_idepth, num_points) for Frame::setDepth."""
        if self._fresh_export is not None:
            idepth0, ivar0, mean_id, num = self._fresh_export
            self._fresh_export = None
        else:
            idepth0, ivar0, mean_id, num = export_arrays(self.state)
        with self.timers.span("pull.export"):
            return idepth0, ivar0, float(mean_id), int(num)

    def reactivation_snapshot(self):
        """takeReActivationData (Frame.cpp:107-145): level-0 idepth / var /
        validity kept for a later re-activation."""
        s = self.state
        zero = torch.zeros_like(s.idepth)
        re_var = torch.where(
            s.valid, s.var,
            torch.where(s.blacklisted < 0, torch.full_like(s.var, -2.0),
                        torch.full_like(s.var, -1.0)))
        return (torch.where(s.valid, s.idepth, zero), re_var,
                torch.where(s.valid, s.validity, zero))

    def _skip_inc(self) -> float:
        """Adaptive skip increment (DepthMap.cpp:449-452), an f32 value."""
        return float(np.float32(max(
            3.0, self.num_frames_tracked_on_this
            / float(self.num_mapped_on_this + 5))))

    def _f32(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def update_keyframe(self, kf_pyr, ref_img, ref_to_kf, ref_id: float,
                        good_mask, tracking_residual):
        """One observe sweep with one tracked frame (sequential-mode
        updateKeyframe, DepthMap.cpp:1072-1213); ref_to_kf and
        tracking_residual are host numbers. Returns the stats dict of
        device scalars (no host sync)."""
        budget = self.pick_budget()
        self.state, stats, export = observe_program(
            self.state, kf_pyr.images[0], kf_pyr.gx[0], kf_pyr.gy[0],
            kf_pyr.max_grad[0], ref_img, self._f32(ref_to_kf), ref_id,
            good_mask, self._f32(tracking_residual), self._skip_inc(),
            self.cam, self.cfg, point_budget=budget)
        self.last_active = stats["active"]  # device scalar, read lazily
        self.sweeps = [(budget, stats["active"])]
        self._fresh_export = export
        self.num_mapped_on_this += 1
        return stats

    def update_keyframe_multi(self, kf_pyr, ref_imgs, ref_to_kfs, ref_ids,
                              good_masks, tracking_residuals):
        """One mapping iteration over a queue of tracked frames (the whole
        unmappedTrackedFrames deque, SlamSystem.cpp:542-571): each pixel
        picks its stereo partner by nextStereoFrameMinID, so one EPL sweep
        per chunk maps every queued frame. Parallel lists in ascending id
        order; ref_to_kfs, ref_ids and tracking_residuals are host numbers.
        Queues longer than MULTI_REF_BUCKETS[-1] map in chunks of that
        size, each at the full point budget. Returns a stats dict of device
        scalars, summed over the chunks."""
        n = len(ref_imgs)
        assert n == len(ref_to_kfs) == len(ref_ids) == len(good_masks) \
            == len(tracking_residuals) and n >= 1
        if n == 1:
            return self.update_keyframe(kf_pyr, ref_imgs[0], ref_to_kfs[0],
                                        ref_ids[0], good_masks[0],
                                        tracking_residuals[0])
        total = None
        kmax = MULTI_REF_BUCKETS[-1]
        budget = observe_budget_full(*self.state.idepth.shape)
        self.sweeps = []
        for lo in range(0, n, kmax):
            chunk = slice(lo, min(lo + kmax, n))
            self.state, stats, export = observe_multi_program(
                self.state, kf_pyr.images[0], kf_pyr.gx[0], kf_pyr.gy[0],
                kf_pyr.max_grad[0], torch.stack(list(ref_imgs[chunk])),
                self._f32(np.stack([np.asarray(r, np.float64)
                                    for r in ref_to_kfs[chunk]])),
                [float(i) for i in ref_ids[chunk]],
                torch.stack(list(good_masks[chunk])),
                self._f32([float(t) for t in tracking_residuals[chunk]]),
                self._skip_inc(), self.cam, self.cfg, point_budget=budget)
            self.last_active = stats["active"]
            self.sweeps.append((budget, stats["active"]))
            self._fresh_export = export
            # one frame == one mapping unit (SlamSystem.cpp:566-581)
            self.num_mapped_on_this += chunk.stop - chunk.start
            total = stats if total is None else {
                key: total[key] + stats[key] for key in stats}
        return total
