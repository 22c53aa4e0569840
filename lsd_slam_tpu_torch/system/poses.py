"""Host-side pose tree with epoch-cached absolute poses (a copy of
lsd_slam_tpu/system/poses.py; pure numpy).

Equivalent of FramePoseStruct (src/DataStructures/FramePoseStruct.{h,cpp}):
each frame stores its Sim3 transform to its tracking parent; absolute poses
are computed lazily by recursion up the parent tree with a global epoch
counter invalidating all caches at once (FramePoseStruct.cpp:84-105).
Graph-optimization results are staged (`set_graph_opt_result`) and applied
atomically by the merge step (`apply_graph_opt_result`,
== SlamSystem::mergeOptimizationOffset, SlamSystem.cpp:176-202).

All math is numpy float64 on host — matching the reference's use of
double-precision Sophus for pose chains.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lsd_slam_tpu_torch.lie import np_sim3 as nps


class PoseRegistry:
    """Holds the global cache-validity epoch (== cacheValidCounter)."""

    def __init__(self):
        self.epoch = 1

    def invalidate_all(self):
        self.epoch += 1


class PoseNode:
    def __init__(self, frame_id: int, registry: PoseRegistry):
        self.frame_id = frame_id
        self.registry = registry
        self.this_to_parent = nps.sim3_identity()  # Sim3 (8,)
        self.parent: Optional[PoseNode] = None
        self.is_registered_to_graph = False
        self.is_in_graph = False
        # graph-opt staging
        self._cam_to_world_new: Optional[np.ndarray] = None
        self.has_unmerged_pose = False
        # cache
        self._cam_to_world = nps.sim3_identity()
        self._cache_epoch = 0
        # when a node is baked into the optimized graph its absolute pose is
        # authoritative (isOptimized in the reference)
        self.is_optimized = False

    def invalidate_cache(self):
        self._cache_epoch = 0

    def cam_to_world(self) -> np.ndarray:
        """Lazy recursive absolute pose (FramePoseStruct.cpp:84-105)."""
        if self.is_optimized:
            return self._cam_to_world
        if self._cache_epoch == self.registry.epoch:
            return self._cam_to_world
        if self.parent is None:
            self._cam_to_world = self.this_to_parent.copy()
        else:
            self._cam_to_world = nps.sim3_mul(self.parent.cam_to_world(),
                                              self.this_to_parent)
        self._cache_epoch = self.registry.epoch
        return self._cam_to_world

    def set_graph_opt_result(self, cam_to_world: np.ndarray):
        self._cam_to_world_new = np.asarray(cam_to_world, np.float64)
        self.has_unmerged_pose = True

    def apply_graph_opt_result(self) -> bool:
        if not self.has_unmerged_pose:
            return False
        self._cam_to_world = self._cam_to_world_new
        self.is_optimized = True
        self.has_unmerged_pose = False
        return True
