"""Keyframe graph: candidate search, Sim(3) constraint pipeline, PGO glue
(torch).

Port of lsd_slam_tpu/mapping/keyframe_graph.py (KeyFrameGraph,
TrackableKeyFrameSearch and the constraint pipeline of SlamSystem,
SlamSystem.cpp:1043-1587). Device work is batched:
the quick SE3 pre-checks track one frame against N permaRefs (or one
permaRef against N frames) and pull one (B, 11) pack; the reciprocal Sim3
tests run both directions of each level range over all live candidates
and pull one (B, 70) pack per direction; the pose graph assembles on the
device. Bookkeeping (neighbour sets, BFS, failed-constraint memory, the
far-candidate cap's `random.Random(0)` draws) stays on the host, in the
JAX package's order.

With `use_fabmap=True` the graph keeps an `AppearanceIndex`
(mapping/appearance.py): every keyframe added to the graph is described
on the device, and `find_candidates` adds the appearance hit and its
neighbours to the Euclidean overlap set, as in the JAX package.

Not ported yet: the mesh / multi-host batches (ROADMAP Queue 1 item 8);
the port runs on one device, as a one-device JAX run does (`mesh` is
None).
"""

from __future__ import annotations

import math
import random
import time
from collections import deque
from typing import Dict, List, Set

import numpy as np
import torch

from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.mapping.appearance import AppearanceIndex
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
from lsd_slam_tpu_torch.tracking import quick_tracker as qt
from lsd_slam_tpu_torch.tracking.quick_tracker import QuickTracker
from lsd_slam_tpu_torch.tracking.reference import TrackingRef
from lsd_slam_tpu_torch.tracking.sim3_tracker import (
    SIM3_PACK as SP, Sim3Tracker, stack_refs)

class Constraint:
    """== KFConstraintStruct (KeyFrameGraph.h:42-78)."""

    __slots__ = ("first", "second", "second_to_first", "information",
                 "huber_delta", "mean_residual", "mean_residual_d",
                 "mean_residual_p", "usage", "reciprocal_consistency")

    def __init__(self, first, second, second_to_first, information,
                 huber_delta, mean_residual=0.0, mean_residual_d=0.0,
                 mean_residual_p=0.0, usage=0.0, reciprocal_consistency=0.0):
        self.first = first
        self.second = second
        self.second_to_first = second_to_first
        self.information = information
        self.huber_delta = huber_delta
        self.mean_residual = mean_residual
        self.mean_residual_d = mean_residual_d
        self.mean_residual_p = mean_residual_p
        self.usage = usage
        self.reciprocal_consistency = reciprocal_consistency


def bfs_hops(n_nodes: int, efrom, eto, start: int) -> np.ndarray:
    """Hop distances from `start` over an undirected edge list; -1 where
    unreachable (the pure-Python path of the JAX package's native BFS)."""
    adj = [[] for _ in range(n_nodes)]
    for a, b in zip(list(efrom), list(eto)):
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full(n_nodes, -1, np.int32)
    dist[start] = 0
    dq = deque([start])
    while dq:
        v = dq.popleft()
        for n in adj[v]:
            if dist[n] < 0:
                dist[n] = dist[v] + 1
                dq.append(n)
    return dist


def pad_batch(n: int, minimum: int = 4) -> int:
    """The JAX package's batch bucket without a mesh (`pad_to_mesh`): the
    smallest power-of-two multiple of `minimum` >= n."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _zeros_like_ref(ref: TrackingRef, levels) -> TrackingRef:
    return TrackingRef(
        pts=tuple(qt.zeros_like_points(p) if (lvl in levels and p is not None)
                  else p for lvl, p in enumerate(ref.pts)),
        sim3_quad=tuple(torch.zeros_like(q) if (lvl in levels
                                                and q is not None) else q
                        for lvl, q in enumerate(ref.sim3_quad)))


class KeyFrameGraph:
    def __init__(self, system):
        self.system = system
        cam = system.cam
        cfg = system.cfg
        self.device = system.device
        self.sim3_tracker = Sim3Tracker(cam, cfg.sim3_tracker,
                                        sigma2=cfg.mapping.camera_pixel_noise2)
        self.quick_tracker = QuickTracker(cam, cfg.tracker,
                                          sigma2=cfg.mapping.camera_pixel_noise2)
        self.pose_graph = PoseGraph(device=self.device)
        self.kf_to_vertex: Dict[int, int] = {}     # kf.id -> vertex idx
        self.neighbors: Dict[int, Set[int]] = {}   # kf.id -> set of kf.id
        self.edges: List[Constraint] = []
        # == keyframesForRetrack (KeyFrameGraph.h:171-174): the idle
        # re-track pool of the constraint thread
        self.keyframes_for_retrack: List = []
        self.last_constraint_tracked_c2w: Dict[int, np.ndarray] = {}
        self._rng = random.Random(0)
        self._pose_cache_key = None
        self._pose_cache = None
        # optional appearance retrieval (== useFabMap, settings.cpp:92)
        self.appearance = (AppearanceIndex(device=self.device)
                           if cfg.system.use_fabmap else None)
        self.fow_x = 2.0 * math.atan(cam.width / (cam.fx * 2.0))
        self.fow_y = 2.0 * math.atan(cam.height / (cam.fy * 2.0))
        # permaRef store (== Frame::setPermaRef, Frame.cpp:149-174): the
        # always-resident quick-level point set + frame quad layout per
        # keyframe, so a minimized keyframe serves quick checks unrestored
        self._permaref: Dict[int, tuple] = {}

    def _bump(self, key, n=1):
        self.system.stats.bump(key, n)

    # ------------------------------------------------------------ permaref

    def set_permaref(self, kf):
        """== Frame::setPermaRef at finishCurrentKeyframe
        (SlamSystem.cpp:404-405)."""
        lvl = self.quick_tracker.level
        self._permaref[kf.id] = (kf.tracking_ref.pts[lvl], kf.pyr.quad[lvl])

    def _get_permaref(self, kf):
        if kf.id not in self._permaref:
            self.set_permaref(kf)
        return self._permaref[kf.id]

    # --------------------------------------------------- batched tracking

    def _pull_quick(self, res, n):
        """One packed (B, 11) pull for the five quick-track outputs."""
        arr = qt.pack_result(res).cpu().numpy()
        self._bump("quick_syncs", res.n_syncs)
        self._bump("backend_pulls")
        return (arr[:n, 0:7], arr[:n, 7] > 0.5, arr[:n, 8], arr[:n, 9],
                arr[:n, 10])

    def _inits(self, inits, n, b):
        ident = nps.se3_identity().astype(np.float32)
        arr = np.concatenate([np.asarray(inits, np.float32).reshape(n, 7),
                              np.tile(ident, (b - n, 1))])
        return torch.as_tensor(arr, device=self.device)

    def _batch_track_refs(self, pts_list, frame_quad, inits):
        """Quick-track one frame against N keyframe point sets in one padded
        batch. Returns host (ref_to_frame (N, 7), good (N,), usage,
        good_count, bad_count)."""
        n = len(pts_list)
        b = pad_batch(n)
        pad = qt.zeros_like_points(pts_list[0])
        refs = qt.stack_points(list(pts_list) + [pad] * (b - n))
        res = self.quick_tracker.track_batch_pts(refs, frame_quad,
                                                 self._inits(inits, n, b))
        return self._pull_quick(res, n)

    def _batch_track_frames(self, ref_pts, quads_list, inits):
        """Quick-track ONE reference against N frame quad layouts (the
        reciprocal direction)."""
        n = len(quads_list)
        b = pad_batch(n)
        quads = torch.stack(list(quads_list)
                            + [torch.zeros_like(quads_list[0])] * (b - n))
        res = self.quick_tracker.track_batch_frames(ref_pts, quads,
                                                    self._inits(inits, n, b))
        return self._pull_quick(res, n)

    # ------------------------------------------------------------ vertices

    def add_keyframe(self, kf):
        """== KeyFrameGraph::addKeyFrame (KeyFrameGraph.cpp:234-255)."""
        if kf.id in self.kf_to_vertex:
            return
        fixed = kf.pose.parent is None
        vid = self.pose_graph.add_vertex(kf.pose.cam_to_world(), fixed=fixed)
        self.kf_to_vertex[kf.id] = vid
        self.neighbors.setdefault(kf.id, set())
        kf.pose.is_in_graph = True
        self.set_permaref(kf)
        self.keyframes_for_retrack.append(kf)
        if self.appearance is not None:
            self.appearance.add(kf.id, kf.pyr)

    def insert_constraint(self, c: Constraint):
        """== insertConstraint (KeyFrameGraph.cpp:258-294)."""
        self.add_keyframe(c.first)
        self.add_keyframe(c.second)
        self.pose_graph.add_edge(
            self.kf_to_vertex[c.first.id], self.kf_to_vertex[c.second.id],
            c.second_to_first, c.information, c.huber_delta)
        self.edges.append(c)
        self.neighbors[c.first.id].add(c.second.id)
        self.neighbors[c.second.id].add(c.first.id)
        c.first.edge_error_sum += c.mean_residual
        c.first.edges_num += 1
        c.second.edge_error_sum += c.mean_residual
        c.second.edges_num += 1

    # ------------------------------------------------------------ dijkstra

    def graph_distances_from(self, start_kf) -> Dict[int, int]:
        """Hop-count graph distances (calculateGraphDistancesToFrame,
        KeyFrameGraph.cpp:340-374)."""
        # a snapshot: in threaded mode another thread adds keyframes (and
        # their neighbour sets) while the constraint thread searches
        nbrs = {fid: list(ns) for fid, ns in list(self.neighbors.items())}
        ids = sorted(nbrs)
        idx = {fid: i for i, fid in enumerate(ids)}
        if start_kf.id not in idx:
            return {start_kf.id: 0}
        efrom, eto = [], []
        for fid, ns in nbrs.items():
            for nid in ns:
                if fid < nid:
                    efrom.append(idx[fid])
                    eto.append(idx[nid])
        d = bfs_hops(len(ids), efrom, eto, idx[start_kf.id])
        return {fid: int(d[i]) for fid, i in idx.items() if d[i] >= 0}

    # ------------------------------------------------------------ search

    def _kf_pose_matrix(self):
        """(N, 8) camToWorld matrix + positions, view axes and distance
        factors of all keyframes, cached on the pose epoch."""
        sys = self.system
        key = (len(sys.keyframes), sys.registry.epoch)
        if self._pose_cache_key != key:
            kfs = sys.keyframes
            if kfs:
                c2w = np.stack([kf.pose.cam_to_world() for kf in kfs])
                mean_id = np.asarray([kf.mean_idepth for kf in kfs])
            else:
                c2w = np.zeros((0, 8), np.float64)
                mean_id = np.zeros((0,), np.float64)
            z_axis = (nps.quat_to_matrix(c2w[:, 0:4])[:, :, 2]
                      if len(kfs) else np.zeros((0, 3)))
            self._pose_cache = (c2w, c2w[:, 4:7], z_axis,
                                mean_id / np.maximum(c2w[:, 7], 1e-30))
            self._pose_cache_key = key
        return self._pose_cache

    def find_euclidean_overlap_frames(self, frame_c2w, mean_idepth,
                                      distance_th, angle_th,
                                      check_both_scales=False):
        """== findEuclideanOverlapFrames (TrackableKeyFrameSearch.cpp:56-98)
        as one batched distance/angle pass. Returns [(kf, dist_sq,
        frame->kf SE3)] in keyframe order."""
        cos_angle_th = math.cos(angle_th * 0.5 * (self.fow_x + self.fow_y))
        frame_c2w = np.asarray(frame_c2w, np.float64)
        pos = frame_c2w[4:7]
        view = nps.quat_to_matrix(frame_c2w[0:4])[:, 2]
        dist_fac_recip = mean_idepth / frame_c2w[7]

        c2w_all, pos_all, z_all, dist_fac = self._kf_pose_matrix()
        if len(c2w_all) == 0:
            return []
        if check_both_scales:
            dist_fac = np.minimum(dist_fac, dist_fac_recip)
        d = (pos[None, :] - pos_all) * dist_fac[:, None]
        d2 = np.einsum("ni,ni->n", d, d)
        ok = (d2 <= distance_th) & (z_all @ view >= cos_angle_th)

        sel = np.nonzero(ok)[0]
        if len(sel) == 0:
            return []
        f2r = nps.se3_inverse(nps.se3_from_sim3(
            nps.sim3_mul(nps.sim3_inverse(c2w_all[sel]),
                         frame_c2w[None, :])))
        return [(self.system.keyframes[i], float(d2[i]), f2r[k])
                for k, i in enumerate(sel)]

    def find_candidates(self, kf, closeness_th: float, use_fabmap=True):
        """== findCandidates (TrackableKeyFrameSearch.cpp:174-203): the
        Euclidean overlap set, with the appearance hit and its neighbours
        (when the index exists and `use_fabmap`)."""
        kcfg = self.system.cfg.keyframe
        frames = self.find_euclidean_overlap_frames(
            kf.pose.cam_to_world(), kf.mean_idepth,
            closeness_th * 15.0 / (kcfg.kf_dist_weight ** 2),
            1.0 - 0.25 * closeness_th, check_both_scales=True)
        cands = {f.id: f for f, _, _ in frames}
        fabmap_id = None
        if self.appearance is not None and use_fabmap:
            id_to_kf = self.system.id_to_keyframe
            fabmap_id = self.appearance.query(kf.pyr, kf.id)
            if fabmap_id is not None and fabmap_id in id_to_kf:
                cands[fabmap_id] = id_to_kf[fabmap_id]
                for nid in self.neighbors.get(fabmap_id, ()):
                    if nid in id_to_kf:
                        cands[nid] = id_to_kf[nid]
            else:
                fabmap_id = None
        return cands, fabmap_id

    def find_reposition_candidate(self, tracked, max_score: float):
        """== findRePositionCandidate (TrackableKeyFrameSearch.cpp:103-172)."""
        if tracked is None:
            return None
        kcfg = self.system.cfg.keyframe
        c2w = tracked.pose.cam_to_world()
        parent = self.system.id_to_keyframe.get(tracked.parent_kf_id)
        mean_id = parent.mean_idepth if parent else 1.0
        cands = self.find_euclidean_overlap_frames(
            c2w, mean_id, max_score / (kcfg.kf_dist_weight ** 2), 0.75)

        frame_quad = tracked.pyr.quad[self.quick_tracker.level]
        best = None
        best_score = max_score
        for kf, dist_sq, ref_to_frame in cands:
            if kf.id == tracked.parent_kf_id:
                continue
            if kf.idx_in_keyframes < kcfg.initialization_phase_count:
                continue
            pts, _ = self._get_permaref(kf)
            usage = self.quick_tracker.check_overlap_pts(pts, frame_quad,
                                                         ref_to_frame)
            self._bump("backend_pulls")
            score = self.system._ref_frame_score(dist_sq, usage)
            if score < max_score:
                # trackFrameOnPermaref: one lane (a lane's result equals
                # its unbatched run), one pull
                p, r_good, r_usage, good, bad = (
                    a[0] for a in self._batch_track_refs(
                        [pts], frame_quad, ref_to_frame[None]))
                tracked_pose = np.asarray(p, np.float64)
                dist = tracked_pose[4:7] * kf.mean_idepth
                new_score = self.system._ref_frame_score(
                    float(dist @ dist), float(r_usage))
                discrepancy = nps.sim3_log_norm(nps.sim3_from_se3(
                    nps.se3_mul(ref_to_frame, nps.se3_inverse(tracked_pose))))
                good_val = float(r_usage) * float(good) / max(
                    float(good) + float(bad), 1.0)
                if (bool(r_good) and good_val > kcfg.relocalization_th
                        and new_score < best_score and discrepancy < 0.2):
                    best_score = score
                    best = kf
        return best

    # ---------------------------------------------------- batched testing

    def _record_failure(self, kf, candidate, init_estimate):
        kf.tracking_failed.setdefault(candidate.id, []).append(
            np.asarray(init_estimate, np.float64))

    def test_constraints_batch(self, new_kf, cands, inits, stricts):
        """Coarse-to-fine testConstraint (SlamSystem.cpp:1129-1216) over all
        candidates: per level range (4,3), (2,2), (1,1), the two reciprocal
        directions run as two batched Sim3 tracks over the live candidates,
        re-compacted between stages. Returns (e1, e2) or None per
        candidate."""
        kcfg = self.system.cfg.keyframe
        n = len(cands)
        if n == 0:
            return []
        new_ref = new_kf.sim3_ref
        th_per_stage = (kcfg.constraint_err_lvl3, kcfg.constraint_err_lvl2,
                        kcfg.constraint_err_lvl1)
        live = list(range(n))
        c_to_f_all = np.stack([np.asarray(i, np.float64) for i in inits])
        f_to_c_all = np.stack([nps.sim3_inverse(p) for p in c_to_f_all])
        cons_all = np.full(n, 1e20)
        last = None
        for stage, (ls, le) in enumerate(((4, 3), (2, 2), (1, 1))):
            t_stage = time.perf_counter()
            m = len(live)
            pad = pad_batch(m)
            levels = tuple(range(le, ls + 1))
            refs = [cands[i].sim3_ref for i in live]
            if pad > m:
                # dead padding lanes get zero point sets: they diverge on
                # the first LM iteration
                refs = refs + [_zeros_like_ref(refs[0], levels)] * (pad - m)
            stacked = stack_refs(refs, levels)
            ident = nps.sim3_identity()
            c_to_f = np.stack([c_to_f_all[i] for i in live]
                              + [ident] * (pad - m))
            f_to_c = np.stack([f_to_c_all[i] for i in live]
                              + [ident] * (pad - m))
            pk_ba, s_ba = self.sim3_tracker.track_batch_frames_packed(
                new_ref, stacked, np.asarray(c_to_f, np.float32), ls, le)
            pk_ab, s_ab = self.sim3_tracker.track_batch_packed(
                stacked, new_ref, np.asarray(f_to_c, np.float32), ls, le)
            both = torch.stack([pk_ba, pk_ab]).cpu().numpy().astype(
                np.float64)                                  # one pull
            ba, ab = both[0], both[1]
            self._bump("sim3_syncs", s_ba + s_ab)
            self._bump("backend_pulls")
            ba_pose = ba[:, SP["frame_to_ref"]]
            ab_pose = ab[:, SP["frame_to_ref"]]
            ba_div = ba[:, SP["diverged"]] > 0.5
            ab_div = ab[:, SP["diverged"]] > 0.5
            info_ba = ba[:, SP["hessian"]].reshape(-1, 7, 7)
            info_ab = ab[:, SP["hessian"]].reshape(-1, 7, 7)

            survivors = []
            lane_of = {}
            for k in range(m):
                ci = live[k]
                cons_all[ci] = 1e20
                if (ba_div[k] or ba_pose[k, 7] > 1e10 or ba_pose[k, 7] < 1e-10
                        or info_ba[k, 0, 0] == 0 or info_ba[k, 6, 6] == 0
                        or ab_div[k] or ab_pose[k, 7] > 1e10
                        or ab_pose[k, 7] < 1e-10 or info_ab[k, 0, 0] == 0
                        or info_ab[k, 6, 6] == 0):
                    self._record_failure(new_kf, cands[ci], inits[ci])
                    continue
                adj = nps.sim3_adjoint(ab_pose[k])
                try:
                    diff_hesse = np.linalg.inv(
                        np.linalg.inv(info_ab[k])
                        + adj @ np.linalg.inv(info_ba[k]) @ adj.T)
                except np.linalg.LinAlgError:
                    self._record_failure(new_kf, cands[ci], inits[ci])
                    continue
                diff = nps.sim3_log(nps.sim3_mul(ab_pose[k], ba_pose[k]))
                cons_all[ci] = float(diff @ diff_hesse @ diff)
                if cons_all[ci] > th_per_stage[stage] * stricts[ci]:
                    self._record_failure(new_kf, cands[ci], inits[ci])
                    continue
                f_to_c_all[ci] = ab_pose[k]
                c_to_f_all[ci] = ba_pose[k]
                lane_of[ci] = k
                survivors.append(ci)

            live = survivors
            last = (ba, ab, lane_of)
            dt = (time.perf_counter() - t_stage) * 1000.0
            self._bump(f"sim3_stage{stage}_ms", dt)
            self._bump(f"sim3_stage{stage}_n")
            self.system.stats.high_water(f"sim3_stage{stage}_ms_max", dt)
            if not live:
                return [None] * n

        ba, ab, lane_of = last
        alive = set(live)
        # the robust-kernel delta uses the global strictness; a candidate's
        # strictness only relaxes its thresholds (SlamSystem.cpp:1211-1215)
        kernel_delta = 5.0 * math.sqrt(6000.0 * kcfg.loop_closure_strictness)
        out = []
        for ci in range(n):
            if ci not in alive:
                out.append(None)
                continue
            k = lane_of[ci]
            e1 = Constraint(
                new_kf, cands[ci], ba[k, SP["frame_to_ref"]],
                ba[k, SP["hessian"]].reshape(7, 7), kernel_delta,
                float(ba[k, SP["last_residual"]]),
                float(ba[k, SP["depth_residual"]]),
                float(ba[k, SP["photo_residual"]]),
                float(ba[k, SP["point_usage"]]), cons_all[ci])
            e2 = Constraint(
                cands[ci], new_kf, ab[k, SP["frame_to_ref"]],
                ab[k, SP["hessian"]].reshape(7, 7), kernel_delta,
                float(ab[k, SP["last_residual"]]),
                float(ab[k, SP["depth_residual"]]),
                float(ab[k, SP["photo_residual"]]),
                float(ab[k, SP["point_usage"]]), cons_all[ci])
            out.append((e1, e2))
        return out

    # ------------------------------------------------------------ pipeline

    def find_constraints_for_new_keyframe(self, new_kf, force_parent=True,
                                          use_fabmap=True,
                                          close_candidates_th=1.0) -> int:
        """== findConstraintsForNewKeyFrames (SlamSystem.cpp:1218-1587)."""
        sys = self.system
        kcfg = sys.cfg.keyframe
        parent_kf = (sys.id_to_keyframe.get(new_kf.pose.parent.frame_id)
                     if new_kf.pose.parent is not None else None)

        if parent_kf is None:
            self.add_keyframe(new_kf)
            return 0

        if not force_parent:
            last = self.last_constraint_tracked_c2w.get(new_kf.id)
            if last is not None:
                d = nps.sim3_log_norm(
                    nps.sim3_mul(last, nps.sim3_inverse(
                        new_kf.pose.cam_to_world())))
                if d < 0.01:
                    return 0
        self.last_constraint_tracked_c2w[new_kf.id] = \
            new_kf.pose.cam_to_world().copy()

        candidates, fabmap_id = self.find_candidates(
            new_kf, close_candidates_th, use_fabmap=use_fabmap)
        my_neighbors = self.neighbors.get(new_kf.id, set())
        candidates = {fid: f for fid, f in candidates.items()
                      if fid not in my_neighbors}

        new_c2w = new_kf.pose.cam_to_world()
        init_map = {
            fid: nps.sim3_mul(nps.sim3_inverse(new_c2w),
                              f.pose.cam_to_world())
            for fid, f in candidates.items()}
        distances = self.graph_distances_from(parent_kf)

        def eligible(fid, cand):
            return not (fid == new_kf.id or not cand.pose.is_in_graph
                        or fid == parent_kf.id
                        or cand.idx_in_keyframes
                        < kcfg.initialization_phase_count)

        # -------- close candidates: reciprocal SE3 quick check with SO3
        # disturbance (SlamSystem.cpp:1283-1310) as two batched tracks
        disturb = np.array([math.cos(0.025), math.sin(0.025), 0, 0])
        pre = [cand for fid, cand in candidates.items() if eligible(fid, cand)]
        close: List = []
        if pre:
            lvl = self.quick_tracker.level
            c2f_inits, f2c_inits, cand_pts, cand_quads = [], [], [], []
            for cand in pre:
                # project to SE3 *then* invert, like the reference's
                # se3FromSim3(x.inverse()).inverse()
                c2f = nps.se3_inverse(
                    nps.se3_from_sim3(nps.sim3_inverse(init_map[cand.id])))
                c2f_inits.append(np.concatenate(
                    [nps.quat_mul(c2f[0:4], disturb), c2f[4:7]]))
                f2c = nps.se3_inverse(nps.se3_from_sim3(init_map[cand.id]))
                f2c_inits.append(np.concatenate(
                    [nps.quat_mul(disturb, f2c[0:4]), f2c[4:7]]))
                pts, quad = self._get_permaref(cand)
                cand_pts.append(pts)
                cand_quads.append(quad)
            p1, good1, _, _, _ = self._batch_track_refs(
                cand_pts, new_kf.pyr.quad[lvl], np.stack(c2f_inits))
            new_pts, _ = self._get_permaref(new_kf)
            p2, good2, _, _, _ = self._batch_track_frames(
                new_pts, cand_quads, np.stack(f2c_inits))
            rot = nps.quat_mul(np.asarray(p2, np.float64)[:, 0:4],
                               np.asarray(p1, np.float64)[:, 0:4])
            rot_err = np.linalg.norm(nps.so3_log(rot), axis=-1)
            keep = (np.asarray(good1, bool) & np.asarray(good2, bool)
                    & (rot_err < kcfg.close_consistency_th))
            close = [cand for cand, k in zip(pre, keep) if k]

        # -------- far candidates (SlamSystem.cpp:1314-1337)
        far: List = []
        for fid, cand in candidates.items():
            if not eligible(fid, cand):
                continue
            if fid != fabmap_id and \
                    distances.get(fid, 1 << 30) < kcfg.far_graph_dist_min:
                continue
            far.append(cand)

        # -------- drop previously-failed inits (SlamSystem.cpp:1345-1402)
        def failed_before(cand, th, check_pose):
            fails = new_kf.tracking_failed.get(cand.id)
            if not fails:
                return False
            f2c = nps.sim3_inverse(init_map[cand.id]) if check_pose else None
            for old in fails:
                if check_pose:
                    if nps.sim3_log_norm(nps.sim3_mul(f2c, old)) < th:
                        return True
                elif nps.sim3_log_norm(old) < th:
                    return True
            return False

        close = [c for c in close if not failed_before(c, 0.1, True)]
        far = [c for c in far if not failed_before(c, 0.2, False)]

        # -------- caps (SlamSystem.cpp:1414-1450); the close cap's
        # tie-break keeps list order, the far cap draws from Random(0)
        while len(close) > kcfg.max_loop_closure_candidates:
            worst, worst_n = None, -1
            for f in close:
                nb = sum(1 for other in close
                         if other.id in self.neighbors.get(f.id, ()))
                if nb > worst_n:
                    worst, worst_n = f, nb
            close.remove(worst)
        max_far = max((kcfg.max_loop_closure_candidates + 1) // 2, 5)
        while len(far) > max_far:
            far.pop(self._rng.randrange(len(far)))

        # -------- full Sim3 tests, batched: close + far + forced parent
        # ride one coarse-to-fine batch; a failed close candidate that is
        # also far retries with the identity init
        constraints: List[Constraint] = []
        strict = kcfg.loop_closure_strictness
        test_cands = list(close)
        test_inits = [init_map[c.id] for c in close]
        test_stricts = [strict] * len(close)
        close_ids = {c.id for c in close}
        far_only = [f for f in far if f.id not in close_ids]
        test_cands += far_only
        test_inits += [nps.sim3_identity() for _ in far_only]
        test_stricts += [strict] * len(far_only)
        parent_pos = -1
        if force_parent:
            parent_pos = len(test_cands)
            test_cands.append(parent_kf)
            test_inits.append(nps.sim3_mul(nps.sim3_inverse(new_c2w),
                                           parent_kf.pose.cam_to_world()))
            test_stricts.append(100.0)

        results = self.test_constraints_batch(new_kf, test_cands,
                                              test_inits, test_stricts)
        parent_ok = False
        far_ids = {f.id for f in far}
        failed_close = []
        for i, (cand, res) in enumerate(zip(test_cands, results)):
            if res is not None:
                constraints.extend(res)
                if i == parent_pos:
                    parent_ok = True
            elif i < len(close) and cand.id in far_ids:
                failed_close.append(cand)
        if failed_close:
            retry = self.test_constraints_batch(
                new_kf, failed_close,
                [nps.sim3_identity() for _ in failed_close],
                [strict] * len(failed_close))
            for res in retry:
                if res is not None:
                    constraints.extend(res)

        # -------- forced parent fallback (SlamSystem.cpp:1520-1566)
        if force_parent and not parent_ok:
            downweight = 5.0
            kernel_delta = 5.0 * math.sqrt(6000.0 * strict) / downweight
            info = _ODOMETRY_INFORMATION * (1e9 / downweight ** 2)
            s2f = nps.sim3_mul(nps.sim3_inverse(new_c2w),
                               parent_kf.pose.cam_to_world())
            constraints.append(Constraint(
                new_kf, parent_kf, s2f, info, kernel_delta,
                mean_residual=10, mean_residual_d=10, mean_residual_p=10,
                usage=0))

        self.add_keyframe(new_kf)
        for c in constraints:
            self.insert_constraint(c)
        return len(constraints)

    # ------------------------------------------------------------ optimize

    def _push_poses_to_graph(self):
        # g2o semantics (KeyFrameGraph.cpp:296-336): vertices keep their
        # optimizer estimates across optimize() calls; only never-optimized
        # vertices carry the live pose in
        for kf in list(self.system.keyframes):
            vid = self.kf_to_vertex.get(kf.id)
            if vid is None:
                continue
            pose = kf.pose
            if pose.is_optimized or pose.has_unmerged_pose:
                continue
            self.pose_graph.set_vertex(vid, pose.cam_to_world())

    def _pull_poses_from_graph(self) -> float:
        max_change = 0.0
        for kf in list(self.system.keyframes):
            vid = self.kf_to_vertex.get(kf.id)
            if vid is None or self.pose_graph.fixed[vid]:
                continue
            new_pose = self.pose_graph.poses[vid]
            old = kf.pose.cam_to_world()
            change = nps.sim3_log_norm(
                nps.sim3_mul(nps.sim3_inverse(old), new_pose))
            max_change = max(max_change, float(change))
            kf.pose.set_graph_opt_result(new_pose)
        return max_change

    def _optimize(self, iterations: int):
        t0 = time.perf_counter()
        pulls = self.pose_graph.n_pulls
        self.pose_graph.optimize(iterations)
        self._bump("pgo_ms", (time.perf_counter() - t0) * 1000.0)
        self._bump("pgo_calls")
        self._bump("backend_pulls", self.pose_graph.n_pulls - pulls)

    def optimize_slices(self, max_slices: int = 20) -> bool:
        """Slices of `pgo_iterations_per_slice` until the change is small
        (SlamSystem.cpp:371-377), at most `max_slices` per call."""
        cfg = self.system.cfg.system
        if self.pose_graph.n_edges == 0:
            return False
        self._push_poses_to_graph()
        changed = False
        for _ in range(max_slices):
            self._optimize(cfg.pgo_iterations_per_slice)
            change = self._pull_poses_from_graph()
            changed = changed or change > 1e-12
            if change < cfg.pgo_min_change:
                break
        return changed

    def optimize_final(self):
        if self.pose_graph.n_edges == 0:
            return
        self._push_poses_to_graph()
        self._optimize(self.system.cfg.system.pgo_final_iterations)
        self._pull_poses_from_graph()

    # ------------------------------------------------------------ reloc

    def relocalize(self, pyr):
        """Batched permaRef relocalisation with neighbour voting
        (Relocalizer.cpp:117-243): one batched quick track of the frame
        against every keyframe's permaRef, then, for the best few
        candidates, one batched track against the candidate's graph
        neighbours (sorted ids), each voting good when it agrees (goodVal >
        0.8 TH and pose within 0.1 of the prediction). Accepted when good >
        bad or good >= 5. Returns (keyframe, frame->keyframe SE3 init) for
        the full re-verification in SlamSystem, or None."""
        kfs = [kf for kf in self.system.keyframes if kf.id in self._permaref]
        if not kfs:
            return None
        kcfg = self.system.cfg.keyframe
        frame_quad = pyr.quad[self.quick_tracker.level]
        pts_list = [self._permaref[kf.id][0] for kf in kfs]
        inits = np.tile(nps.se3_identity(), (len(kfs), 1))
        k2f, good, usage, gc, bc = self._batch_track_refs(
            pts_list, frame_quad, inits)
        good_val = usage * gc / np.maximum(gc + bc, 1.0)
        good_val = np.where(np.isfinite(good_val), good_val, -1.0)

        for cand_idx in np.argsort(good_val)[::-1][:3]:
            if good_val[cand_idx] <= kcfg.relocalization_th:
                break
            todo = kfs[cand_idx]
            todo_to_frame = np.asarray(k2f[cand_idx], np.float64)
            n_ids = [nid for nid in sorted(self.neighbors.get(todo.id, ()))
                     if nid in self._permaref]
            best_kf, best_pose = todo, todo_to_frame
            best_val = good_val[cand_idx]
            n_good = n_bad = 0
            if n_ids:
                # predicted init per neighbour (Relocalizer.cpp:187)
                todo_c2w = todo.pose.cam_to_world()
                n_inits, n_pts = [], []
                for nid in n_ids:
                    nkf = self.system.id_to_keyframe[nid]
                    inner = nps.sim3_mul(
                        nps.sim3_mul(nps.sim3_inverse(nkf.pose.cam_to_world()),
                                     todo_c2w),
                        nps.sim3_from_se3(nps.se3_inverse(todo_to_frame)))
                    n_inits.append(nps.se3_inverse(nps.se3_from_sim3(inner)))
                    n_pts.append(self._permaref[nid][0])
                nk2f, _, n_usage, n_gc, n_bc = self._batch_track_refs(
                    n_pts, frame_quad, np.stack(n_inits))
                n_val = n_usage * n_gc / np.maximum(n_gc + n_bc, 1.0)
                for j, nid in enumerate(n_ids):
                    drift = nps.se3_log(nps.se3_mul(
                        np.asarray(nk2f[j], np.float64),
                        nps.se3_inverse(np.asarray(n_inits[j]))))
                    if (n_val[j] > kcfg.relocalization_th * 0.8
                            and float(np.linalg.norm(drift)) < 0.1):
                        n_good += 1
                    else:
                        n_bad += 1
                    if n_val[j] > best_val:
                        best_val = n_val[j]
                        best_kf = self.system.id_to_keyframe[nid]
                        best_pose = np.asarray(nk2f[j], np.float64)
            if n_good > n_bad or n_good >= 5:
                return best_kf, nps.se3_inverse(best_pose)
        return None


# hard-coded odometry-edge information matrix (SlamSystem.cpp:1546-1553)
_ODOMETRY_INFORMATION = np.array([
    [0.8098, -0.1507, -0.0557, 0.1211, 0.7657, 0.0120, 0],
    [-0.1507, 2.1724, -0.1103, -1.9279, -0.1182, 0.1943, 0],
    [-0.0557, -0.1103, 0.2643, -0.0021, -0.0657, -0.0028, 0.0304],
    [0.1211, -1.9279, -0.0021, 2.3110, 0.1039, -0.0934, 0.0005],
    [0.7657, -0.1182, -0.0657, 0.1039, 1.0545, 0.0743, -0.0028],
    [0.0120, 0.1943, -0.0028, -0.0934, 0.0743, 0.4511, 0],
    [0, 0, 0.0304, 0.0005, -0.0028, 0, 0.0228],
])
