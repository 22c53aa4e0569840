"""Output wrappers: the engine's publish surface.

Port of lsd_slam_tpu/io/output.py (== Output3DWrapper,
src/IOWrapper/Output3DWrapper.h:43-66, and the ROS serialization,
ROSOutput3DWrapper.cpp:70-193). The wire design is kept: keyframe messages
carry pose + intrinsics + dense idepth/var/color buffers in keyframe-local
coordinates; graph messages carry only poses+constraints, so the point
clouds never need re-sending (README.md:310-324). The transport is npz
files per keyframe + a jsonl graph stream, byte for byte the JAX
package's format: a viewer of either package tails them.

A keyframe's level-0 idepth, ivar and image live on the engine's device;
each is pulled to the host once per message (`host_keyframe`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.utils.native import write_ply_binary


def host_keyframe(kf):
    """(idepth, ivar, image) of a keyframe's level 0 as host float32
    arrays, one device -> host copy per field."""
    return (kf.depth.idepth[0].cpu().numpy(), kf.depth.ivar[0].cpu().numpy(),
            kf.pyr.images[0].cpu().numpy())


class Output3DWrapper:
    """Abstract publisher — users implement their own (README.md:324)."""

    def publish_keyframe(self, kf) -> None:
        pass

    def publish_tracked_frame(self, frame_id, timestamp, cam_to_world) -> None:
        pass

    def publish_keyframe_graph(self, keyframes, edges) -> None:
        pass

    def publish_trajectory(self, trajectory) -> None:
        pass

    def publish_debug_info(self, data) -> None:
        pass


class FileOutput3DWrapper(Output3DWrapper):
    """Streams keyframes as npz + graph/pose updates as jsonl.

    A live viewer (lsd_slam_tpu_torch.viewer.live) tails the directory like
    the reference viewer subscribes to the keyframe/graph topics."""

    def __init__(self, out_dir: str, cam=None):
        self.out_dir = out_dir
        self.cam = cam
        os.makedirs(out_dir, exist_ok=True)
        self._pose_f = open(os.path.join(out_dir, "poses.jsonl"), "w")
        self._graph_f = open(os.path.join(out_dir, "graph.jsonl"), "w")

    def publish_keyframe(self, kf) -> None:
        """== keyframeMsg: id, time, camToWorld, intrinsics, dense
        idepth/var/color (ROSOutput3DWrapper.cpp:70-112). Written to a
        temp file then renamed so a tailing viewer never reads a partial
        npz."""
        intr = {}
        if self.cam is not None:
            intr = dict(fx=self.cam.fx, fy=self.cam.fy,
                        cx=self.cam.cx, cy=self.cam.cy)
        idepth, ivar, color = host_keyframe(kf)
        path = os.path.join(self.out_dir, f"kf_{kf.id:06d}.npz")
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            id=kf.id,
            time=kf.timestamp,
            cam_to_world=kf.pose.cam_to_world(),
            idepth=idepth,
            idepth_var=ivar,
            color=color,
            mean_idepth=kf.mean_idepth,
            num_points=kf.num_points,
            **intr,
        )
        os.replace(tmp, path)

    def publish_tracked_frame(self, frame_id, timestamp, cam_to_world) -> None:
        self._pose_f.write(json.dumps({
            "id": int(frame_id), "time": float(timestamp),
            "cam_to_world": [float(v) for v in cam_to_world]}) + "\n")
        self._pose_f.flush()

    def publish_keyframe_graph(self, keyframes, edges) -> None:
        """== keyframeGraphMsg: packed poses + constraints
        (ROSOutput3DWrapper.cpp:164-193)."""
        self._graph_f.write(json.dumps({
            "frames": [{"id": kf.id,
                        "cam_to_world": [float(v)
                                         for v in kf.pose.cam_to_world()]}
                       for kf in keyframes],
            "constraints": [{"from": e.first.id, "to": e.second.id,
                             "err": float(e.mean_residual)} for e in edges],
        }) + "\n")
        self._graph_f.flush()

    def close(self):
        self._pose_f.close()
        self._graph_f.close()


def export_ply(path: str, keyframes, cam, scaled_var_th: float = 0.02,
               abs_var_th: float = 0.1, min_near_support: int = 3,
               sparsify: int = 1) -> int:
    """Assemble the global point cloud and write it as binary PLY.

    == the viewer's refreshPC + PLY export (KeyFrameDisplay.cpp:106-222,
    KeyFrameGraphDisplay.cpp:60-94): unproject per-keyframe idepth maps,
    filter by scaled/absolute variance and near-support, transform by the
    keyframe's Sim3 camToWorld. Returns the number of points written."""
    pts_all = []
    cols_all = []
    for kf in keyframes:
        idepth, var, color = host_keyframe(kf)
        valid = (var > 0) & (idepth > 0)
        # scaled variance threshold (KeyFrameDisplay.cpp:149-162)
        c2w = kf.pose.cam_to_world()
        scale = c2w[7]
        depth = np.where(valid, 1.0 / np.maximum(idepth, 1e-9), 0.0)
        valid &= var * depth ** 4 * scale ** 2 < scaled_var_th
        valid &= var < abs_var_th
        if min_near_support > 1:
            sup = np.zeros_like(idepth)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == 0 and dy == 0:
                        continue
                    neigh_id = np.roll(np.roll(idepth, dy, 0), dx, 1)
                    neigh_var = np.roll(np.roll(var, dy, 0), dx, 1)
                    ok = (neigh_var > 0) & (np.abs(neigh_id - idepth)
                                            < 0.2 * np.abs(idepth))
                    sup += ok
            valid &= sup >= min_near_support
        ys, xs = np.nonzero(valid)
        if sparsify > 1:
            keep = np.random.default_rng(0).random(len(ys)) < 1.0 / sparsify
            ys, xs = ys[keep], xs[keep]
        if len(ys) == 0:
            continue
        z = 1.0 / idepth[ys, xs]
        x = (xs - cam.cx) / cam.fx * z
        y = (ys - cam.cy) / cam.fy * z
        pts_local = np.stack([x, y, z], axis=-1)
        rot = nps.quat_to_matrix(c2w[0:4])
        pts_world = scale * pts_local @ rot.T + c2w[4:7]
        pts_all.append(pts_world)
        cols_all.append(color[ys, xs])

    if pts_all:
        xyz = np.concatenate(pts_all).astype(np.float32)
        gray = np.clip(np.concatenate(cols_all), 0, 255).astype(np.uint8)
        rgb = np.stack([gray, gray, gray], axis=-1)
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.uint8)
    write_ply_binary(path, xyz, rgb)
    return len(xyz)
