"""Checkpoint / resume: serialize the keyframe + graph store.

Port of lsd_slam_tpu/io/checkpoint.py, in the same npz format
(FORMAT_VERSION 1, the same keys and dtypes), so a checkpoint written by
either package loads in the other. The reference has no true
checkpointing (SURVEY.md 5.4); here the durable state is exactly the
keyframe+graph store — host images, level-0 depth, Sim3 pose tree,
edges — so save/load is one compressed npz and a resumed system can keep
tracking, re-activate old keyframes, and keep optimizing the graph.
Device tensors are pulled with `.cpu()`; a loaded keyframe restores onto
the system's device on first access.
"""

from __future__ import annotations

import numpy as np
import torch

FORMAT_VERSION = 1


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_system(path: str, system) -> None:
    """Serialize keyframes, pose tree, graph edges and trajectory."""
    blobs = {"format_version": FORMAT_VERSION,
             "cam": np.array([system.cam.fx, system.cam.fy, system.cam.cx,
                              system.cam.cy, system.cam.width,
                              system.cam.height])}

    kf_ids = []
    for kf in system.keyframes:
        k = f"kf{kf.id}"
        kf_ids.append(kf.id)
        blobs[f"{k}_image"] = _host(kf.pyr.images[0]).astype(np.float32)
        blobs[f"{k}_idepth"] = _host(kf.depth.idepth[0]).astype(np.float32)
        blobs[f"{k}_ivar"] = _host(kf.depth.ivar[0]).astype(np.float32)
        blobs[f"{k}_meta"] = np.array([kf.timestamp, kf.mean_idepth,
                                       kf.num_points, kf.idx_in_keyframes,
                                       kf.initial_tracked_residual])
        blobs[f"{k}_this_to_parent"] = kf.pose.this_to_parent
        blobs[f"{k}_parent"] = np.array(
            [kf.pose.parent.frame_id if kf.pose.parent else -1])
        blobs[f"{k}_c2w"] = kf.pose.cam_to_world()
        if kf.reactivation is not None:
            re_id, re_var, re_val = (_host(a) for a in kf.reactivation)
            blobs[f"{k}_re_idepth"] = re_id
            blobs[f"{k}_re_var"] = re_var
            blobs[f"{k}_re_validity"] = re_val
    blobs["kf_ids"] = np.asarray(kf_ids, np.int64)

    if system.backend is not None and system.backend._graph is not None:
        g = system.backend.graph
        blobs["edge_first"] = np.asarray([e.first.id for e in g.edges])
        blobs["edge_second"] = np.asarray([e.second.id for e in g.edges])
        blobs["edge_meas"] = (np.stack([e.second_to_first for e in g.edges])
                              if g.edges else np.zeros((0, 8)))
        blobs["edge_info"] = (np.stack([e.information for e in g.edges])
                              if g.edges else np.zeros((0, 7, 7)))
        blobs["edge_delta"] = np.asarray([e.huber_delta for e in g.edges])
        blobs["edge_residual"] = np.asarray([e.mean_residual
                                             for e in g.edges])

    if system.trajectory:
        blobs["traj_ts"] = np.asarray([t for t, _, _ in system.trajectory])
        blobs["traj_id"] = np.asarray([i for _, i, _ in system.trajectory])
        blobs["traj_pose"] = np.stack([p for _, _, p in system.trajectory])

    np.savez_compressed(path, **blobs)


def load_system(path: str, cfg=None, enable_slam: bool = True, device=None):
    """Rebuild a SlamSystem on `device` (the CUDA device unless the caller
    names one) from a checkpoint; tracking can resume against the last
    keyframe (keyframes restore lazily from host data)."""
    from lsd_slam_tpu_torch.camera import Camera
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.system.keyframe import Keyframe

    data = np.load(path, allow_pickle=False)
    fx, fy, cx, cy, w, h = data["cam"]
    cam = Camera(float(fx), float(fy), float(cx), float(cy), int(w), int(h))
    cfg = cfg or LSDConfig(width=int(w), height=int(h))
    system = SlamSystem(cam, cfg, enable_slam=enable_slam, device=device)

    nodes = {}
    kfs = {}
    for kf_id in data["kf_ids"].tolist():
        k = f"kf{kf_id}"
        node = system._new_pose_node(kf_id)
        node.this_to_parent = np.asarray(data[f"{k}_this_to_parent"],
                                         np.float64)
        nodes[kf_id] = node
        kf = Keyframe(kf_id, float(data[f"{k}_meta"][0]), None, node,
                      cfg.system.pyramid_levels, cfg.mapping.min_use_grad,
                      device=system.device)
        kf._host_image = data[f"{k}_image"]
        kf._host_idepth = data[f"{k}_idepth"]
        kf._host_ivar = data[f"{k}_ivar"]
        meta = data[f"{k}_meta"]
        kf.mean_idepth = float(meta[1])
        kf.num_points = int(meta[2])
        kf.idx_in_keyframes = int(meta[3])
        kf.initial_tracked_residual = float(meta[4])
        if f"{k}_re_idepth" in data:
            kf.reactivation = (data[f"{k}_re_idepth"], data[f"{k}_re_var"],
                               data[f"{k}_re_validity"])
        kfs[kf_id] = kf
        system.id_to_keyframe[kf_id] = kf

    # re-link parents and rebuild the ordered keyframe list
    for kf_id, kf in kfs.items():
        pid = int(data[f"kf{kf_id}_parent"][0])
        if pid >= 0 and pid in nodes:
            kf.pose.parent = nodes[pid]
    system.keyframes = sorted(kfs.values(), key=lambda kf: kf.idx_in_keyframes)
    system.registry.invalidate_all()

    # restore graph edges
    if enable_slam and "edge_first" in data and len(data["edge_first"]):
        from lsd_slam_tpu_torch.mapping.keyframe_graph import Constraint

        graph = system.backend.graph
        for kf in system.keyframes:
            graph.add_keyframe(kf)
        for i in range(len(data["edge_first"])):
            f_id = int(data["edge_first"][i])
            s_id = int(data["edge_second"][i])
            if f_id not in kfs or s_id not in kfs:
                continue
            graph.insert_constraint(Constraint(
                kfs[f_id], kfs[s_id], data["edge_meas"][i],
                data["edge_info"][i], float(data["edge_delta"][i]),
                float(data["edge_residual"][i])))

    # trajectory
    if "traj_ts" in data:
        system.trajectory = [
            (float(data["traj_ts"][i]), int(data["traj_id"][i]),
             data["traj_pose"][i])
            for i in range(len(data["traj_ts"]))]

    # resume against the last keyframe
    if system.keyframes:
        last = system.keyframes[-1]
        system.current_keyframe = last
        re = last.reactivation
        if re is not None:
            system.map.set_from_existing_kf(*re)
        else:
            system.map.set_from_existing_kf(
                last._host_idepth,
                np.where(last._host_ivar > 0, last._host_ivar, -1.0),
                np.full_like(last._host_idepth, 20.0))
        system._export_depth_to(last)
    return system
