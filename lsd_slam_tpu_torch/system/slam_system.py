"""SlamSystem: the engine orchestrator (torch).

Port of lsd_slam_tpu/system/slam_system.py (SlamSystem.cpp:739-1040) in
every mode of the JAX engine, `sequential` x `pipeline_lag`:
- `sequential=True, pipeline_lag=0` (hz=0): per frame, `frame_step` runs
  pyramid build, pyramidal SE3 track and the speculative observe sweep
  (+ fill holes / regularize / export) and packs every scalar the host
  reads into one vector (the JAX package's host pack layout), pulled once.
- `pipeline_lag=L > 0`: up to L frame steps stay in flight. Each chains
  its tracking init from the previous slot's device `frame_to_ref` and its
  tracking reference from the previous slot's `ref_out` (rebuilt from the
  just-updated depth inside the frame step), and host decisions retire L
  frames behind. The pack is copied into the slot's pinned host buffer
  with `non_blocking=True` at dispatch; retire waits on the slot's CUDA
  event before it reads the buffer. A loss rolls the depth state back to
  the lost frame's snapshot and discards the whole ring; a second-order
  extrapolation of the keyframe score fires the switch when the trigger
  frame crosses, not when the host hears of it.
- `sequential=False`: constraint search and PGO run on worker threads
  (mapping/backend.py); with `pipeline_lag=0` a mapping thread also drains
  the tracked frames in multi-reference sweeps (`update_keyframe_batch`),
  and tracking only tracks. system/async_mapping.py holds the threads and
  their rules on the card (one stream; a worker's failure is re-raised in
  the caller at the next `track_frame`, `block_until_mapped` or
  `finalize`).
Keyframe selection, tracking-loss handling, the keyframe switch (finish,
re-activate or propagate, install), the back-end hooks and finalize follow
the JAX engine line by line. `enable_slam=False` is visual odometry only.

`cfg.system.use_fabmap` adds the appearance index to the constraint
search (mapping/appearance.py), as in the JAX engine.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.frames import build_depth_pyramid, build_frame
from lsd_slam_tpu_torch.depth import DepthMap
from lsd_slam_tpu_torch.depth.depth_map import observe_program
from lsd_slam_tpu_torch.depth.observe import OBSERVE_STAT_KEYS
from lsd_slam_tpu_torch.tracking import SE3Tracker, make_tracking_ref
from lsd_slam_tpu_torch.tracking.se3_tracker import HOST_PACK as HP
from lsd_slam_tpu_torch.system.async_mapping import WorkerError
from lsd_slam_tpu_torch.system.poses import PoseNode, PoseRegistry
from lsd_slam_tpu_torch.system.keyframe import Keyframe, KeyframeMemory
from lsd_slam_tpu_torch.utils.stats import RunningStats, StageTimers, \
    device_sync


class _InFlight:
    """One dispatched frame awaiting its host decisions (a slot of the
    pipelined ring). snapshot is the DepthMap snapshot taken before this
    frame's speculative observe (None for a track-only frame); pack is the
    host pack, on the card's slots a pinned host buffer that `copied`
    (a CUDA event, else None) guards; ref_out is the tracking reference
    rebuilt from this frame's depth, which the next dispatch chains on
    (None at lag 0)."""

    __slots__ = ("frame_id", "timestamp", "pyr", "res", "export", "pack",
                 "copied", "snapshot", "kf", "create_flag", "ref_out")

    def __init__(self, frame_id, timestamp, pyr, res, export, pack,
                 snapshot, kf, create_flag, ref_out=None, copied=None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.pyr = pyr
        self.res = res
        self.export = export
        self.pack = pack
        self.copied = copied
        self.snapshot = snapshot
        self.kf = kf
        self.create_flag = create_flag
        self.ref_out = ref_out


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
               point_budget: int, timers: Optional[StageTimers] = None,
               build_ref: bool = False):
    """The whole per-frame hot path (== the JAX engine's fused frame step,
    slam_system.py:94-157): pyramid build, pyramidal SE3 track, observe
    sweep (+ fill holes / regularize / export) and the host pack
    [track host_pack (23) | observe stats (OBSERVE_STAT_KEYS) | mean
    idepth, point count]. With `build_ref` (pipelined mode) it also
    rebuilds the keyframe's tracking reference from the just-updated depth,
    which the next in-flight frame tracks against; at lag 0 the retire
    rebuilds it (Keyframe.set_depth).

    Returns (pyr, res, new_state, export, pack, new_ref or None)."""
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
    new_ref = None
    if build_ref:
        with timers.time("ref_rebuild"):
            new_ref = make_tracking_ref(
                kf_pyr, build_depth_pyramid(export[0], export[1],
                                            cfg.system.pyramid_levels),
                min_level=cfg.tracker.min_level, with_sim3=False)
    pack = torch.cat(
        [res.host_pack,
         torch.stack([stats[k].to(torch.float32) for k in OBSERVE_STAT_KEYS]
                     + [export[2].to(torch.float32),
                        export[3].to(torch.float32)])])
    return pyr, res, state2, export, pack, new_ref


class SlamSystem:
    def __init__(self, cam: Camera, cfg: LSDConfig = LSDConfig(),
                 enable_slam: bool = True, seed: int = 0, device=None):
        if cam.width != cfg.width or cam.height != cfg.height:
            cfg = cfg.replace(width=cam.width, height=cam.height)
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.enable_slam = enable_slam
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
        # (prev, prev-prev) score for the pipelined keyframe-trigger
        # extrapolation
        self._score_hist = (0.0, 0.0)

        self.tracking_last_residual = 0.0
        self.tracking_last_usage = 0.0
        self.stats = RunningStats()
        self.timers = StageTimers(
            sync=device_sync if cfg.system.profile_sync else None)
        self.frame_memory = KeyframeMemory(
            cfg.keyframe.max_loop_closure_candidates + 20)
        # Output3DWrapper the engine publishes keyframes/graph updates to
        self.output = None
        if enable_slam:
            from lsd_slam_tpu_torch.mapping import MappingBackend
            self.backend = MappingBackend(self)
        else:
            self.backend = None

        # pipelined frame loop: the ring of in-flight frames and, on the
        # card, one pinned host buffer per slot for the pack copies
        self._lag = max(0, int(cfg.system.pipeline_lag))
        self._ring: List[_InFlight] = []
        self._pack_bufs: List[torch.Tensor] = []
        self._next_slot = 0

        # the mapping thread (sequential=False, lag 0); with pipelining the
        # speculative frame step is the mapping iteration, so only the
        # back-end's workers run as threads
        self.mapping_thread = None
        if not cfg.system.sequential and self._lag == 0:
            from lsd_slam_tpu_torch.system.async_mapping import MappingThread
            self.mapping_thread = MappingThread(
                self, cfg.mapping.max_unmapped_queue)
            self.mapping_thread.start()

    # ------------------------------------------------------------- workers

    def workers(self) -> list:
        """The engine's worker objects (mapping, constraint, PGO)."""
        out = [self.mapping_thread] if self.mapping_thread is not None \
            else []
        return out + (self.backend.workers() if self.backend is not None
                      else [])

    def raise_worker_error(self):
        """Re-raise a worker thread's failure in the caller (WorkerError,
        the worker's exception as its cause)."""
        for w in self.workers():
            if w.error is not None:
                raise WorkerError(f"the {w.name} thread failed: "
                                  f"{w.error!r}") from w.error

    def _stop_workers(self):
        if self.mapping_thread is not None:
            self.mapping_thread.stop()
        if self.backend is not None:
            self.backend.stop_threads()

    # ------------------------------------------------------------- helpers

    def set_visualization(self, output) -> None:
        """== SlamSystem::setVisualization: attach an Output3DWrapper; the
        engine then publishes each keyframe when it is finished and graph
        pose updates after optimisation merges."""
        self.output = output

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
        """Track one frame (== trackFrame, SlamSystem.cpp:890-1040).

        The common case (no keyframe switch pending) runs `frame_step` and
        puts the frame in the ring; with pipeline_lag 0 it retires at once
        (one pack pull), else lag frames behind. A switch frame, or any
        frame in threaded mode, tracks only; the switch then maps inline,
        the threaded mode pushes the frame to the mapping thread."""
        self.raise_worker_error()
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
        inline_map = self.cfg.system.sequential or self._lag > 0
        if inline_map and not my_create_flag and self.map.is_valid():
            self._ring.append(self._dispatch_frame(image, frame_id,
                                                   timestamp))
            node = None
            if len(self._ring) > self._lag:
                node = self._retire_frame(self._ring.pop(0))
            # a retire that set the keyframe flag or lost tracking ends the
            # speculation run: drain so the switch / relocaliser sees
            # every frame
            if self._ring and (self.create_new_keyframe
                               or not self.tracking_is_good):
                self._drain_ring()
            return node.cam_to_world() if node is not None else None

        # --- non-speculative path: keyframe-switch frame, threaded
        # tracking, or no depth state yet ---
        self._drain_ring()
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
        if inline_map:
            with self.timers.time("switch" if my_create_flag
                                  else "map_inline"):
                self.do_mapping_iteration()
        else:
            self.mapping_thread.push(self.latest_tracked)
        return node.cam_to_world()

    def _copy_pack(self, pack: torch.Tensor):
        """Start the device -> host copy of a frame's pack into the next
        slot's pinned buffer; returns (host buffer, CUDA event recorded
        after the copy). A slot is reused lag + 1 dispatches later, when
        its frame has retired or was discarded; a discarded frame's copy
        is ahead of the new one on the same stream. A CPU pack is its own
        host copy."""
        if pack.device.type != "cuda":
            return pack, None
        if len(self._pack_bufs) < self._lag + 1:
            self._pack_bufs.append(torch.empty(pack.shape, dtype=pack.dtype,
                                               pin_memory=True))
        buf = self._pack_bufs[self._next_slot]
        self._next_slot = (self._next_slot + 1) % (self._lag + 1)
        buf.copy_(pack, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return buf, copied

    def _dispatch_frame(self, image, frame_id: int,
                        timestamp: float) -> _InFlight:
        """Run the speculative frame step and start its pack copy; no host
        sync but the LM loop's flag pulls."""
        kf = self.current_keyframe
        if self.backend is not None:
            self.backend.merge_optimization_offset()
        snap = self.map.snapshot()
        kf.num_frames_tracked_on_this += 1
        self.map.num_frames_tracked_on_this = kf.num_frames_tracked_on_this
        # adaptive skip increment (DepthMap.cpp:449-452)
        skip_inc = max(3.0, self.map.num_frames_tracked_on_this
                       / float(self.map.num_mapped_on_this + 5))
        if self._ring and self._ring[-1].kf is kf:
            # pose + reference chaining: the previous slot's device
            # frame->ref is this frame's init (SlamSystem.cpp:922-925
            # computes this product on the host) and its rebuilt reference
            # this frame's reference: depth as fresh as at lag 0
            init7 = self._ring[-1].res.frame_to_ref
            ref_in = self._ring[-1].ref_out
        else:
            last_node = self.all_frame_poses[-1]
            init7 = torch.as_tensor(np.asarray(nps.se3_from_sim3(
                nps.sim3_mul(nps.sim3_inverse(kf.pose.cam_to_world()),
                             last_node.cam_to_world())), np.float32),
                device=self.device)
            ref_in = kf.tracking_ref
        with self.timers.time("frame_step"):
            pyr, res, new_state, export_dev, pack, ref_out = frame_step(
                self.tracker, self.cam, self.cfg, self.map.state, ref_in,
                kf.pyr, self._image(image), init7,
                float(np.float32(frame_id)), float(np.float32(skip_inc)),
                self.map.pick_budget(), self.timers,
                build_ref=self._lag > 0)
        self.stats.bump("lm_syncs", res.n_syncs)
        self.map.state = new_state
        self.map._fresh_export = None
        self.map.num_mapped_on_this += 1
        pack, copied = self._copy_pack(pack)
        return _InFlight(frame_id, timestamp, pyr, res, export_dev, pack,
                         snap, kf, False, ref_out, copied)

    def _retire_frame(self, fl: _InFlight):
        """Pull one frame's packed scalars and run every host decision:
        loss handling, pose bookkeeping, keyframe selection, observe
        commit. Returns the frame's PoseNode, or None when lost."""
        kf = fl.kf
        speculative = fl.snapshot is not None
        if not speculative:
            self.stats.bump("lm_syncs", fl.res.n_syncs)
        with self.timers.time("retire_pull"):
            if fl.copied is not None:
                fl.copied.synchronize()   # the slot's copy has landed
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
                # roll back to the depth state before this frame's observe;
                # everything still in flight chained onto it and is
                # discarded wholesale
                self.map.restore(fl.snapshot)
                kf.num_frames_tracked_on_this -= 1 + len(self._ring)
                self._ring.clear()
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
            prev, prev2 = self._score_hist
            self._score_hist = (score, prev)
            self.last_tracking_closeness_score = score
            # this decision runs lag frames after the frame it describes:
            # a second-order extrapolation of the score history fires the
            # flag when the trigger frame crosses (0 at lag 0)
            d1 = max(score - prev, 0.0)
            d2 = max(score - 2.0 * prev + prev2, 0.0)
            lead = self._lag * d1 + 0.5 * self._lag * self._lag * d2
            if score + lead > min_val:
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
            # deferred when pipelined: the chained ref already serves the
            # next dispatch, so the depth pyramid and tracking reference
            # are built at the next switch or constraint access
            kf.set_depth(fl.export[0], fl.export[1], float(host[-2]),
                         int(host[-1]), self.cfg.system.pyramid_levels,
                         defer=self._lag > 0)
        return node

    def _drain_ring(self):
        """Retire every in-flight frame (pipeline barrier)."""
        while self._ring:
            self._retire_frame(self._ring.pop(0))

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
        """doMappingIteration consuming a drained queue of tracked frames
        (SlamSystem.cpp:739-830 + the full-deque drain of updateKeyframe,
        SlamSystem.cpp:542-571): frames tracked on another keyframe are
        dropped, the rest map in one multi-reference sweep. A pending
        keyframe promotion uses the latest tracked frame (the tracking
        thread's, fresher than anything drained), else the newest drained
        one."""
        if self.current_keyframe is None:
            return False
        if self.backend is not None:
            self.backend.merge_optimization_offset()
        if not self.tracking_is_good:
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

    def update_keyframe(self, tracked: Optional[TrackedFrame] = None):
        """Map one tracked frame into the current keyframe
        (== SlamSystem::updateKeyframe, SlamSystem.cpp:542-615)."""
        if tracked is None:
            tracked = self.latest_tracked
        kf = self.current_keyframe
        if tracked is None or tracked.parent_kf_id != kf.id:
            return False
        return self.update_keyframe_batch([tracked])

    def update_keyframe_batch(self, frames: List[TrackedFrame]):
        """Map a drained queue of tracked frames (all tracked on the current
        keyframe) in one multi-reference observe sweep per chunk, the
        reference's whole-deque updateKeyframe (SlamSystem.cpp:542-571,
        DepthMap.cpp:1072-1101); one pull of the stats pack."""
        kf = self.current_keyframe
        if not frames:
            return False
        frames = sorted(frames, key=lambda t: t.id)
        with self.timers.time("map_observe"):
            obs_stats = self.map.update_keyframe_multi(
                kf.pyr,
                [t.pyr.images[0] for t in frames],
                [nps.se3_from_sim3(t.pose.this_to_parent) for t in frames],
                [float(t.id) for t in frames],
                [t.good_mask for t in frames],
                [t.initial_tracked_residual for t in frames])
        svals = torch.stack([obs_stats[k].to(torch.float32)
                             for k in OBSERVE_STAT_KEYS]).cpu().numpy()
        self.stats.bump("map_pulls")
        self.stats.add("observe", dict(zip(OBSERVE_STAT_KEYS, svals)))
        self.stats.bump("mapping_iterations")
        self.stats.bump("mapping_frames_consumed", len(frames))
        # count frames, not sweeps: keyframe gating compares these against
        # per-frame thresholds (MIN_NUM_MAPPED, SlamSystem.cpp:996-1020)
        kf.num_mapped_on_this += len(frames)
        kf.num_mapped_on_this_total += len(frames)
        self._export_depth_to(kf)
        return True

    def finish_current_keyframe(self):
        """== finishCurrentKeyframe (SlamSystem.cpp:395-427)."""
        kf = self.current_keyframe
        with self.timers.time("finalize_kf"):
            self.map.finalize_keyframe(kf.pyr.max_grad[0])
        self._export_depth_to(kf)
        kf.reactivation = self.map.reactivation_snapshot()
        if self.backend is not None:
            # == setPermaRef on every finish (SlamSystem.cpp:404-405), so a
            # re-finished (re-activated) keyframe refreshes its permaRef
            self.backend.refresh_permaref(kf)
        if kf.idx_in_keyframes < 0:
            kf.idx_in_keyframes = len(self.keyframes)
            self.keyframes.append(kf)
            if self.backend is not None:
                with self.timers.time("constraints"):
                    self.backend.on_new_keyframe(kf)
        self.frame_memory.touch(kf)
        n_min = self.frame_memory.prune(self.keyframes, self.current_keyframe)
        if n_min:
            self.stats.bump("keyframes_minimized", n_min)
        if self.output is not None:
            # == publishKeyframe on finish (SlamSystem.cpp:412-414): the
            # dense buffers go out once per finish; later graph updates
            # re-send only poses (README.md:310-324)
            self.output.publish_keyframe(kf)

    def change_keyframe(self, no_create: bool, force: bool, max_score: float,
                        tracked: Optional[TrackedFrame] = None):
        """== changeKeyframe (SlamSystem.cpp:507-540): re-activate a close
        existing keyframe if the back-end finds one, else promote the given
        tracked frame (defaults to the latest)."""
        if tracked is None:
            tracked = self.latest_tracked
        candidate = None
        if self.cfg.keyframe.do_kf_reactivation and self.backend is not None:
            candidate = self.backend.find_reposition_candidate(
                tracked, max_score)
        if candidate is not None:
            self.load_existing_keyframe(candidate)
        elif force:
            if no_create:
                self.tracking_is_good = False
            else:
                self.create_new_current_keyframe(tracked)
        self.create_new_keyframe = False
        # fresh keyframe, fresh score history (a pre-switch slope would
        # re-trigger through the extrapolated lead)
        self._score_hist = (0.0, 0.0)

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
        """== loadNewCurrentKeyframe (SlamSystem.cpp:492-506)."""
        self.stats.bump("keyframes_reactivated")
        re_id, re_var, re_validity = kf.reactivation
        with self.timers.time("reactivate"):
            self.map.set_from_existing_kf(re_id, re_var, re_validity)
        self._export_depth_to(kf)
        kf.num_mapped_on_this = 0
        kf.num_frames_tracked_on_this = 0
        self.current_keyframe = kf

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
        """Consensus-voted candidate from the batched relocaliser, then a
        full SE3 track re-verification before re-activating
        (== takeRelocalizeResult, SlamSystem.cpp:695-737). Without the
        back-end (VO mode) it returns at once."""
        if self.backend is None:
            return
        with self.timers.time("relocalize"):
            hit = self.backend.relocalize(pyr)
        if hit is None:
            return
        kf, frame_to_kf_init = hit
        self.load_existing_keyframe(kf)
        res = self.tracker.track(
            kf.tracking_ref, pyr,
            torch.as_tensor(np.asarray(frame_to_kf_init, np.float32),
                            device=self.device))
        self.stats.bump("lm_syncs", res.n_syncs)
        host = res.host_pack.cpu().numpy().astype(np.float64)
        self.stats.bump("host_syncs")
        good = float(host[HP["good_count"]])
        bad = float(host[HP["bad_count"]])
        good_frac = good / max(good + bad, 1.0)
        # acceptance bound from SlamSystem.cpp:717:
        # goodFraction >= 1 - 0.75*(1 - MIN_GOODPERGOODBAD_PIXEL)
        min_frac = 1.0 - 0.75 * (1.0
                                 - self.cfg.tracker.min_goodpergoodbad_pixel)
        if not bool(host[HP["tracking_good"]]) or good_frac < min_frac:
            self.stats.bump("relocalization_rejected")
            return
        node = self._new_pose_node(frame_id)
        node.this_to_parent = nps.sim3_from_se3(host[HP["frame_to_ref"]], 1.0)
        node.parent = kf.pose
        self.registry.invalidate_all()
        self._log_pose(timestamp, frame_id, node)
        self.latest_tracked = TrackedFrame(
            frame_id, timestamp, node, pyr, res.good_mask,
            float(host[HP["initial_residual"]]),
            float(host[HP["point_usage"]]), kf.id)
        self.create_new_keyframe = False
        self.tracking_is_good = True
        self.stats.bump("relocalized")

    # ------------------------------------------------------------- final

    def block_until_mapped(self, timeout: float = 60.0):
        """hz=0 blocking (SlamSystem.cpp:1030-1039): retire the ring and
        wait for the mapping thread's queue."""
        self.raise_worker_error()
        self._drain_ring()
        if self.mapping_thread is not None:
            self.mapping_thread.wait_until_drained(timeout)
        self.raise_worker_error()

    def finalize(self):
        """== SlamSystem::finalize (SlamSystem.cpp:225-263). Every worker
        thread is stopped when it returns or raises; a worker's failure
        raises WorkerError."""
        try:
            self.raise_worker_error()
            self._drain_ring()
            if self.mapping_thread is not None:
                self.mapping_thread.wait_until_drained()
                self.mapping_thread.stop()
                self.raise_worker_error()
            if self.current_keyframe is not None and self.tracking_is_good:
                if (self.current_keyframe.idx_in_keyframes < 0
                        and self.current_keyframe.num_mapped_on_this_total
                        >= self.cfg.keyframe.min_num_mapped):
                    self.finish_current_keyframe()
            if self.backend is not None:
                with self.timers.time("pgo_final"):
                    self.backend.finalize()
        finally:
            self._stop_workers()
        self.raise_worker_error()

    # ------------------------------------------------------------- export

    def trajectory_array(self) -> np.ndarray:
        """(N, 8) camToWorld Sim3 per tracked frame, as logged at track
        time (LiveSLAMWrapper.cpp:141-161)."""
        return np.stack([p for _, _, p in self.trajectory])

    def optimized_trajectory_array(self) -> np.ndarray:
        """(N, 8) camToWorld Sim3 per tracked frame recomputed through the
        pose tree after graph optimisation (merged PGO results included)."""
        return np.stack([node.cam_to_world()
                         for node in self.all_frame_poses])
