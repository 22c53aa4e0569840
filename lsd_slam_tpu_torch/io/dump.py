"""Map dump for offline inspection.

Port of lsd_slam_tpu/io/dump.py (== KeyFrameGraph::dumpMap,
KeyFrameGraph.cpp:118-230): per-keyframe depth / variance / image PNGs
plus cross-edge statistics matrices as text files. Each keyframe's level-0
buffers are pulled from the device once.
"""

from __future__ import annotations

import os

import numpy as np

from lsd_slam_tpu_torch.io.output import host_keyframe


def dump_map(out_dir: str, system) -> None:
    """Write kf images + depth visualizations + graph statistics."""
    from lsd_slam_tpu_torch.utils import debug_viz

    os.makedirs(out_dir, exist_ok=True)
    kfs = system.keyframes
    for kf in kfs:
        idepth, var, img = host_keyframe(kf)
        valid = var > 0
        debug_viz.save_png(
            os.path.join(out_dir, f"depth-{kf.id:06d}.png"),
            debug_viz.rainbow_depth(idepth, valid, background=img))
        debug_viz.save_png(
            os.path.join(out_dir, f"var-{kf.id:06d}.png"),
            debug_viz.variance_map(var, valid))
        debug_viz.save_png(
            os.path.join(out_dir, f"frame-{kf.id:06d}.png"),
            np.stack([np.clip(img, 0, 255).astype(np.uint8)] * 3, -1))

    # edge statistics matrices (KeyFrameGraph.cpp:140-213): distances,
    # error and points between every keyframe pair that shares an edge
    n = len(kfs)
    idx = {kf.id: i for i, kf in enumerate(kfs)}
    dist = np.full((n, n), -1.0)
    err = np.full((n, n), -1.0)
    usage = np.full((n, n), -1.0)
    if system.backend is not None and system.backend._graph is not None:
        for e in system.backend.graph.edges:
            i = idx.get(e.first.id)
            j = idx.get(e.second.id)
            if i is None or j is None:
                continue
            d = float(np.linalg.norm(np.asarray(e.second_to_first[4:7])))
            dist[i, j] = dist[j, i] = d
            err[i, j] = err[j, i] = e.mean_residual
            usage[i, j] = usage[j, i] = e.usage
    np.savetxt(os.path.join(out_dir, "distanceMatrix.txt"), dist, fmt="%.5f")
    np.savetxt(os.path.join(out_dir, "errorMatrix.txt"), err, fmt="%.5f")
    np.savetxt(os.path.join(out_dir, "usageMatrix.txt"), usage, fmt="%.5f")
    with open(os.path.join(out_dir, "keyframes.txt"), "w") as f:
        for kf in kfs:
            c2w = kf.pose.cam_to_world()
            f.write(f"{kf.id} " + " ".join(f"{v:.6f}" for v in c2w) + "\n")
