"""Trajectory evaluation: ATE/RPE a la the TUM benchmark tools.

The reference ecosystem evaluates `estimated_poses.txt` with the external
TUM scripts (LiveSLAMWrapper.cpp:141-161, README.md:10-14); this module is
the built-in equivalent so benchmarks run hermetically.
"""

from __future__ import annotations

import numpy as np

from lsd_slam_tpu_torch.lie import np_sim3 as nps


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning x (N,3) onto y (N,3).

    Returns (s, R, t) with y ~ s R x + t. Monocular SLAM needs the scale."""
    mx = x.mean(0)
    my = y.mean(0)
    xc = x - mx
    yc = y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1
    rot = u @ s_fix @ vt
    if with_scale:
        var_x = (xc * xc).sum() / len(x)
        scale = np.trace(np.diag(d) @ s_fix) / var_x
    else:
        scale = 1.0
    t = my - scale * rot @ mx
    return scale, rot, t


def ate_rmse(est_c2w: np.ndarray, gt_w2c: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error between estimated camToWorld Sim3/SE3
    poses (N, 7 or 8) and ground-truth world->cam poses (N, 7)."""
    est_pos = np.asarray([p[4:7] for p in est_c2w], np.float64)
    gt_pos = np.asarray(
        [nps.se3_inverse(p)[4:7] for p in np.asarray(gt_w2c, np.float64)])
    s, rot, t = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (rot @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err * err).sum(axis=1).mean()))
