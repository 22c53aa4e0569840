"""SlamSystem: the engine orchestrator — sequential visual odometry (torch).

Port of the `enable_slam=False`, sequential (hz=0), `pipeline_lag=0` path
of lsd_slam_tpu/system/slam_system.py (SlamSystem.cpp:739-1040): per
frame, `frame_step` runs pyramid build, pyramidal SE3 track and the
speculative observe sweep (+ fill holes / regularize / export) and packs
every scalar the host reads into one vector — the JAX package's host pack
layout, pulled once per frame. Keyframe selection, tracking-loss handling,
the keyframe switch (finish, propagate, install) and finalize follow the
JAX engine line by line.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the SLAM back-end (`enable_slam=True`), pipelined mode (`pipeline_lag>0`),
threaded mode (`sequential=False`), the unfused queue-drain mapping
(`update_keyframe_batch`) and keyframe re-activation
(`load_existing_keyframe`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.frames import build_frame
from lsd_slam_tpu_torch.depth import DepthMap
from lsd_slam_tpu_torch.depth.depth_map import observe_program
from lsd_slam_tpu_torch.depth.observe import OBSERVE_STAT_KEYS
from lsd_slam_tpu_torch.tracking import SE3Tracker
from lsd_slam_tpu_torch.tracking.se3_tracker import HOST_PACK as HP
from lsd_slam_tpu_torch.system.poses import PoseNode, PoseRegistry
from lsd_slam_tpu_torch.system.keyframe import Keyframe, KeyframeMemory
from lsd_slam_tpu_torch.utils.stats import RunningStats, StageTimers, \
    device_sync


class _InFlight:
    """One dispatched frame awaiting its host decisions (the JAX engine's
    pipeline slot; with lag 0 a frame is retired right after dispatch)."""

    __slots__ = ("frame_id", "timestamp", "pyr", "res", "export", "pack",
                 "snapshot", "kf", "create_flag")

    def __init__(self, frame_id, timestamp, pyr, res, export, pack,
                 snapshot, kf, create_flag):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.pyr = pyr
        self.res = res
        self.export = export
        self.pack = pack
        self.snapshot = snapshot
        self.kf = kf
        self.create_flag = create_flag


class TrackedFrame:
    """Record of a tracked (non-key)frame; good_mask is the tracker's
    min-level device bool grid (refPixelWasGood, Frame.h:421-449)."""

    __slots__ = ("id", "timestamp", "pose", "pyr", "good_mask",
                 "initial_tracked_residual", "point_usage", "parent_kf_id")

    def __init__(self, fid, timestamp, pose, pyr, good_mask,
                 initial_tracked_residual, point_usage, parent_kf_id):
        self.id = fid
        self.timestamp = timestamp
        self.pose = pose
        self.pyr = pyr
        self.good_mask = good_mask
        self.initial_tracked_residual = initial_tracked_residual
        self.point_usage = point_usage
        self.parent_kf_id = parent_kf_id


def frame_step(tracker: SE3Tracker, cam: Camera, cfg: LSDConfig, state, ref,
               kf_pyr, image, init7, frame_id: float, skip_inc: float,
               point_budget: int, timers: Optional[StageTimers] = None):
    """The whole per-frame hot path (== the JAX engine's fused frame step,
    slam_system.py:94-157): pyramid build, pyramidal SE3 track, observe
    sweep (+ fill holes / regularize / export) and the host pack
    [track host_pack (23) | observe stats (OBSERVE_STAT_KEYS) | mean
    idepth, point count]. The JAX step also rebuilds the tracking reference
    for pipelined mode; the sequential engine rebuilds it at retire time
    (Keyframe.set_depth), so it is not built here.

    Returns (pyr, res, new_state, export, pack)."""
    timers = timers if timers is not None else StageTimers()
    with timers.time("pyramid"):
        pyr = build_frame(image, cfg.system.pyramid_levels,
                          cfg.mapping.min_use_grad)
    with timers.time("track"):
        res = tracker.track(ref, pyr, init7)
    with timers.time("observe"):
        state2, stats, export = observe_program(
            state, kf_pyr.images[0], kf_pyr.gx[0], kf_pyr.gy[0],
            kf_pyr.max_grad[0], pyr.images[0], res.frame_to_ref, frame_id,
            res.good_mask, res.initial_residual, skip_inc, cam, cfg,
            point_budget=point_budget)
    pack = torch.cat(
        [res.host_pack,
         torch.stack([stats[k].to(torch.float32) for k in OBSERVE_STAT_KEYS]
                     + [export[2].to(torch.float32),
                        export[3].to(torch.float32)])])
    return pyr, res, state2, export, pack


class SlamSystem:
    def __init__(self, cam: Camera, cfg: LSDConfig = LSDConfig(),
                 enable_slam: bool = False, seed: int = 0, device=None):
        if cam.width != cfg.width or cam.height != cfg.height:
            cfg = cfg.replace(width=cam.width, height=cam.height)
        if enable_slam:
            raise NotImplementedError(
                "enable_slam=True (the SLAM back-end: Sim3 tracking, "
                "constraint search, pose-graph optimisation, relocalisation) "
                "is not ported yet: ROADMAP Queue 1 item 4")
        if int(cfg.system.pipeline_lag) > 0:
            raise NotImplementedError(
                "pipeline_lag > 0 (pipelined frame retirement) is not ported "
                "yet: ROADMAP Queue 1 item 3")
        if not cfg.system.sequential:
            raise NotImplementedError(
                "sequential=False (threaded mapping) is not ported yet: "
                "ROADMAP Queue 1 item 5")
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.enable_slam = False
        self.seed = seed

        self.tracker = SE3Tracker(cam, cfg.tracker,
                                  sigma2=cfg.mapping.camera_pixel_noise2,
                                  use_affine=cfg.tracker.use_affine_lighting)
        self.map = DepthMap(cam, cfg, self.device)

        self.registry = PoseRegistry()
        self.keyframes: List[Keyframe] = []   # == keyframesAll
        self.id_to_keyframe = {}
        self.all_frame_poses: List[PoseNode] = []
        self.trajectory: List[tuple] = []     # (timestamp, frame_id, c2w sim3)

        self.current_keyframe: Optional[Keyframe] = None
        self.latest_tracked: Optional[TrackedFrame] = None
        self.create_new_keyframe = False
        self.tracking_is_good = True
        self.manual_tracking_loss = False
        self.last_tracking_closeness_score = 0.0

        self.tracking_last_residual = 0.0
        self.tracking_last_usage = 0.0
        self.stats = RunningStats()
        self.timers = StageTimers(
            sync=device_sync if cfg.system.profile_sync else None)
        self.frame_memory = KeyframeMemory(
            cfg.keyframe.max_loop_closure_candidates + 20)

    # ------------------------------------------------------------- helpers

    def _image(self, image) -> torch.Tensor:
        return torch.as_tensor(np.asarray(image, np.float32)
                               if not torch.is_tensor(image) else image,
                               dtype=torch.float32, device=self.device)

    def _build_frame(self, image):
        return build_frame(self._image(image), self.cfg.system.pyramid_levels,
                           self.cfg.mapping.min_use_grad)

    def _new_pose_node(self, frame_id: int) -> PoseNode:
        node = PoseNode(frame_id, self.registry)
        self.all_frame_poses.append(node)
        return node

    def _log_pose(self, ts, fid, node: PoseNode):
        self.trajectory.append((ts, fid, node.cam_to_world().copy()))

    def _new_keyframe(self, frame_id, timestamp, pyr, node) -> Keyframe:
        return Keyframe(frame_id, timestamp, pyr, node,
                        self.cfg.system.pyramid_levels,
                        self.cfg.mapping.min_use_grad)

    # ------------------------------------------------------------- init

    def random_init(self, image, frame_id: int = 0, timestamp: float = 0.0):
        """== SlamSystem::randomInit (SlamSystem.cpp:857-888)."""
        pyr = self._build_frame(image)
        node = self._new_pose_node(frame_id)
        kf = self._new_keyframe(frame_id, timestamp, pyr, node)
        self.map.initialize_randomly(pyr.max_grad[0], seed=self.seed)
        self._export_depth_to(kf)
        self._install_keyframe(kf)
        self._log_pose(timestamp, frame_id, node)
        self.tracking_is_good = True

    def gt_depth_init(self, image, depth, frame_id: int = 0,
                      timestamp: float = 0.0):
        """== SlamSystem::gtDepthInit: seed from ground-truth depth."""
        pyr = self._build_frame(image)
        node = self._new_pose_node(frame_id)
        kf = self._new_keyframe(frame_id, timestamp, pyr, node)
        d = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth,
                       np.float32)
        gt_idepth = np.where(d > 0, 1.0 / np.maximum(d, 1e-6), 0.0)
        self.map.initialize_from_gt(
            torch.as_tensor(gt_idepth.astype(np.float32), device=self.device),
            pyr.max_grad[0])
        self._export_depth_to(kf)
        self._install_keyframe(kf)
        self._log_pose(timestamp, frame_id, node)
        self.tracking_is_good = True

    def _install_keyframe(self, kf: Keyframe):
        self.current_keyframe = kf
        self.id_to_keyframe[kf.id] = kf

    def _export_depth_to(self, kf: Keyframe):
        idepth0, ivar0, mean_id, num = self.map.export_depth()
        self.stats.bump("export_syncs")
        kf.set_depth(idepth0, ivar0, mean_id, num,
                     self.cfg.system.pyramid_levels)

    # ------------------------------------------------------------- tracking

    def track_frame(self, image, frame_id: int, timestamp: float = 0.0):
        """Track one frame (== trackFrame, SlamSystem.cpp:890-1040). The
        common case (no keyframe switch pending) runs `frame_step` and pulls
        its pack once; a switch frame tracks, then maps inline."""
        if not self.tracking_is_good:
            pyr = self._build_frame(image)
            if not self.keyframes:
                # lost before any keyframe was finished: restart from this
                # frame (SlamSystem.cpp:804-827)
                self._reinit_from_frame(pyr, frame_id, timestamp)
            else:
                self._attempt_relocalization(pyr, frame_id, timestamp)
            return None

        kf = self.current_keyframe
        my_create_flag = self.create_new_keyframe
        if not my_create_flag and self.map.is_valid():
            node = self._retire_frame(
                self._dispatch_frame(image, frame_id, timestamp))
            return node.cam_to_world() if node is not None else None

        # --- non-speculative path: keyframe-switch frame or no depth yet ---
        last_node = self.all_frame_poses[-1]
        init_f2r = nps.se3_from_sim3(
            nps.sim3_mul(nps.sim3_inverse(kf.pose.cam_to_world()),
                         last_node.cam_to_world()))
        pyr = self._build_frame(image)
        with self.timers.time("track"):
            res = self.tracker.track(
                kf.tracking_ref, pyr,
                torch.as_tensor(np.asarray(init_f2r, np.float32),
                                device=self.device))
        fl = _InFlight(frame_id, timestamp, pyr, res, None, res.host_pack,
                       None, kf, my_create_flag)
        node = self._retire_frame(fl)
        if node is None:
            return None
        with self.timers.time("switch" if my_create_flag else "map_inline"):
            self.do_mapping_iteration()
        return node.cam_to_world()

    def _dispatch_frame(self, image, frame_id: int,
                        timestamp: float) -> _InFlight:
        """Run the speculative frame step (no pack pull yet)."""
        kf = self.current_keyframe
        snap = self.map.snapshot()
        kf.num_frames_tracked_on_this += 1
        self.map.num_frames_tracked_on_this = kf.num_frames_tracked_on_this
        # adaptive skip increment (DepthMap.cpp:449-452)
        skip_inc = max(3.0, self.map.num_frames_tracked_on_this
                       / float(self.map.num_mapped_on_this + 5))
        last_node = self.all_frame_poses[-1]
        init7 = torch.as_tensor(np.asarray(nps.se3_from_sim3(
            nps.sim3_mul(nps.sim3_inverse(kf.pose.cam_to_world()),
                         last_node.cam_to_world())), np.float32),
            device=self.device)
        with self.timers.time("frame_step"):
            pyr, res, new_state, export_dev, pack = frame_step(
                self.tracker, self.cam, self.cfg, self.map.state,
                kf.tracking_ref, kf.pyr, self._image(image), init7,
                float(np.float32(frame_id)), float(np.float32(skip_inc)),
                self.map.pick_budget(), self.timers)
        self.stats.bump("lm_syncs", res.n_syncs)
        self.map.state = new_state
        self.map._fresh_export = None
        self.map.num_mapped_on_this += 1
        return _InFlight(frame_id, timestamp, pyr, res, export_dev, pack,
                         snap, kf, False)

    def _retire_frame(self, fl: _InFlight):
        """Pull one frame's packed scalars and run every host decision:
        loss handling, pose bookkeeping, keyframe selection, observe
        commit. Returns the frame's PoseNode, or None when lost."""
        kf = fl.kf
        speculative = fl.snapshot is not None
        if not speculative:
            self.stats.bump("lm_syncs", fl.res.n_syncs)
        with self.timers.time("retire_pull"):
            host = fl.pack.cpu().numpy().astype(np.float64)  # THE pull
        self.stats.bump("host_syncs")
        diverged = bool(host[HP["diverged"]])
        tracking_good = bool(host[HP["tracking_good"]])
        point_usage = float(host[HP["point_usage"]])

        self.stats.bump("frames_tracked")
        self.tracking_last_residual = float(host[HP["last_residual"]])
        self.tracking_last_usage = point_usage

        lost = (self.manual_tracking_loss or diverged
                or (len(self.keyframes)
                    > self.cfg.keyframe.initialization_phase_count
                    and not tracking_good))
        if lost:
            if speculative:
                # roll back to the depth state before this frame's observe
                self.map.restore(fl.snapshot)
                kf.num_frames_tracked_on_this -= 1
            self.tracking_is_good = False
            self.create_new_keyframe = False
            self.manual_tracking_loss = False
            return None

        frame_to_ref = host[HP["frame_to_ref"]]
        node = self._new_pose_node(fl.frame_id)
        node.this_to_parent = nps.sim3_from_se3(frame_to_ref, 1.0)
        node.parent = kf.pose
        self.registry.invalidate_all()
        self._log_pose(fl.timestamp, fl.frame_id, node)

        if not speculative:
            kf.num_frames_tracked_on_this += 1
            self.map.num_frames_tracked_on_this = \
                kf.num_frames_tracked_on_this

        self.latest_tracked = TrackedFrame(
            fl.frame_id, fl.timestamp, node, fl.pyr, fl.res.good_mask,
            float(host[HP["initial_residual"]]), point_usage, kf.id)

        # keyframe selection (SlamSystem.cpp:997-1020)
        if (not fl.create_flag and not self.create_new_keyframe
                and kf.num_mapped_on_this_total
                > self.cfg.keyframe.min_num_mapped):
            ref_to_frame = host[HP["ref_to_frame"]]
            dist = ref_to_frame[4:7] * kf.mean_idepth
            n_kf = len(self.keyframes)
            min_val = min(0.2 + n_kf * 0.8
                          / self.cfg.keyframe.initialization_phase_count, 1.0)
            if n_kf < self.cfg.keyframe.initialization_phase_count:
                min_val *= 0.7
            score = self._ref_frame_score(float(dist @ dist), point_usage)
            self.last_tracking_closeness_score = score
            if score > min_val:
                self.create_new_keyframe = True

        if speculative:
            # commit the speculative observe
            n_stats = len(OBSERVE_STAT_KEYS)
            n_track = len(host) - n_stats - 2
            svals = host[n_track:n_track + n_stats]
            self.stats.add("observe", dict(zip(OBSERVE_STAT_KEYS, svals)))
            self.map.last_active = float(
                svals[OBSERVE_STAT_KEYS.index("active")])
            kf.num_mapped_on_this += 1
            kf.num_mapped_on_this_total += 1
            kf.set_depth(fl.export[0], fl.export[1], float(host[-2]),
                         int(host[-1]), self.cfg.system.pyramid_levels)
        return node

    def _ref_frame_score(self, dist_sq: float, usage: float) -> float:
        kcfg = self.cfg.keyframe
        return (dist_sq * kcfg.kf_dist_weight ** 2
                + (1 - usage) ** 2 * kcfg.kf_usage_weight ** 2)

    # ------------------------------------------------------------- mapping

    def do_mapping_iteration(self, tracked: Optional[TrackedFrame] = None):
        """== doMappingIteration (SlamSystem.cpp:739-830) for one frame."""
        return self.do_mapping_iteration_batch(
            [tracked] if tracked is not None else None)

    def do_mapping_iteration_batch(
            self, batch: Optional[List[TrackedFrame]] = None):
        """doMappingIteration over a batch of tracked frames: a pending
        keyframe promotion uses the latest tracked frame; otherwise the
        frames map through `update_keyframe_batch`."""
        if self.current_keyframe is None or not self.tracking_is_good:
            return False
        kf = self.current_keyframe
        if batch is None:
            frames = [self.latest_tracked] if self.latest_tracked is not None \
                else []
        else:
            frames = [t for t in batch if t is not None]
        good = [t for t in frames if t.parent_kf_id == kf.id]
        if len(frames) != len(good):
            self.stats.bump("mapping_dropped_wrong_parent",
                            len(frames) - len(good))

        if self.create_new_keyframe:
            promote = self.latest_tracked
            if promote is None or promote.parent_kf_id != kf.id:
                promote = good[-1] if good else None
            if promote is None:
                return False
            self.finish_current_keyframe()
            self.change_keyframe(no_create=False, force=True, max_score=1.0,
                                 tracked=promote)
        elif good:
            self.update_keyframe_batch(good)
        return True

    def update_keyframe_batch(self, frames: List[TrackedFrame]):
        raise NotImplementedError(
            "update_keyframe_batch (the unfused multi-reference observe) is "
            "not ported yet: ROADMAP Queue 1 item 1")

    def finish_current_keyframe(self):
        """== finishCurrentKeyframe (SlamSystem.cpp:395-427)."""
        kf = self.current_keyframe
        with self.timers.time("finalize_kf"):
            self.map.finalize_keyframe(kf.pyr.max_grad[0])
        self._export_depth_to(kf)
        kf.reactivation = self.map.reactivation_snapshot()
        if kf.idx_in_keyframes < 0:
            kf.idx_in_keyframes = len(self.keyframes)
            self.keyframes.append(kf)
        self.frame_memory.touch(kf)
        n_min = self.frame_memory.prune(self.keyframes, self.current_keyframe)
        if n_min:
            self.stats.bump("keyframes_minimized", n_min)

    def change_keyframe(self, no_create: bool, force: bool, max_score: float,
                        tracked: Optional[TrackedFrame] = None):
        """== changeKeyframe (SlamSystem.cpp:507-540) without the SLAM
        back-end: no re-activation candidate, so promote the tracked frame."""
        if tracked is None:
            tracked = self.latest_tracked
        if force:
            if no_create:
                self.tracking_is_good = False
            else:
                self.create_new_current_keyframe(tracked)
        self.create_new_keyframe = False

    def create_new_current_keyframe(self, tracked: TrackedFrame):
        """== createNewCurrentKeyframe (SlamSystem.cpp:458-490)."""
        old_kf = self.current_keyframe
        frame_to_kf = nps.se3_from_sim3(tracked.pose.this_to_parent)
        old_to_new = nps.se3_inverse(frame_to_kf)
        have_mask = tracked.parent_kf_id == old_kf.id
        self.stats.bump("keyframes_created")
        rescale = self.map.create_keyframe(
            torch.as_tensor(old_to_new.astype(np.float32),
                            device=self.device),
            old_kf.pyr.images[0], tracked.pyr, tracked.good_mask, have_mask)
        self.stats.bump("switch_syncs")

        new_kf = self._new_keyframe(tracked.id, tracked.timestamp,
                                    tracked.pyr, tracked.pose)
        new_kf.initial_tracked_residual = tracked.initial_tracked_residual
        # absorb the idepth renormalization into thisToParent
        new_kf.pose.this_to_parent = nps.sim3_from_se3(
            nps.se3_inverse(old_to_new), rescale)
        new_kf.pose.invalidate_cache()
        self.registry.invalidate_all()

        self._export_depth_to(new_kf)
        self._install_keyframe(new_kf)

    def load_existing_keyframe(self, kf: Keyframe):
        raise NotImplementedError(
            "load_existing_keyframe (keyframe re-activation) is not ported "
            "yet: ROADMAP Queue 1 item 2")

    # ------------------------------------------------------------- reloc

    def _reinit_from_frame(self, pyr, frame_id: int, timestamp: float):
        """Discard the never-finished map and restart from this frame
        (SlamSystem.cpp:804-827)."""
        node = self._new_pose_node(frame_id)
        if self.all_frame_poses[:-1]:
            node.this_to_parent = \
                self.all_frame_poses[-2].cam_to_world().copy()
        kf = self._new_keyframe(frame_id, timestamp, pyr, node)
        self.map.initialize_randomly(pyr.max_grad[0],
                                     seed=self.seed + frame_id)
        self._export_depth_to(kf)
        self._install_keyframe(kf)
        self._log_pose(timestamp, frame_id, node)
        self.latest_tracked = None
        self.create_new_keyframe = False
        self.tracking_is_good = True
        self.stats.bump("reinitialized_after_loss")

    def _attempt_relocalization(self, pyr, frame_id, timestamp):
        """Relocalisation needs the SLAM back-end; without it (VO mode) the
        JAX engine returns at once (slam_system.py:748-749)."""
        return

    # ------------------------------------------------------------- final

    def finalize(self):
        """== SlamSystem::finalize (SlamSystem.cpp:225-263), VO part."""
        if self.current_keyframe is not None and self.tracking_is_good:
            if (self.current_keyframe.idx_in_keyframes < 0
                    and self.current_keyframe.num_mapped_on_this_total
                    >= self.cfg.keyframe.min_num_mapped):
                self.finish_current_keyframe()

    # ------------------------------------------------------------- export

    def trajectory_array(self) -> np.ndarray:
        """(N, 8) camToWorld Sim3 per tracked frame, as logged at track
        time (LiveSLAMWrapper.cpp:141-161)."""
        return np.stack([p for _, _, p in self.trajectory])
