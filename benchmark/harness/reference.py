"""The plain reference that decides `correct`.

The benchmark's scene gives every frame's true pose, so the reference is
the truth itself: the harness's trajectory (scene.bench_trajectory, drawn
from the seed) and, for a distorting camera, the output camera and the
undistorted frame worked out again here
(cameras/<model>.reference_undistort, float64).
It reads the program's outputs only to judge them, and imports nothing
of the program.

The numbers compared, each against its limit (`limits/<cell>.json`):
- lost: frames whose call returned no pose (a lost track), over the
  whole run; limit 0.
- ate_m: the ATE (RMSE in metres after a Sim(3) Umeyama
  alignment) of the answers, every frame from 0 to the last, against the
  true camera centres.
- rpe_rad: the RMS, over consecutive answered frames, of
  the angle between the answers' relative rotation and the true one
  (frame-to-frame tracking, free of the monocular scale).
- undistort_err (cameras that undistort): the largest gray-level gap
  between the program's undistorted frames kept from the window and the
  reference's; infinite where the output cameras differ.

The Umeyama alignment and the ATE are a frozen copy of
`lsd_slam_tpu_torch/utils/evaluate.py` at commit 30445d6 (lines 16-48),
with the true camera centres taken by a numpy SE(3) inverse of its own.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.spec import BENCH_DIR


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning x (N,3) onto y (N,3):
    (s, R, t) with y ~ s R x + t."""
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
        # poses that never move align to their mean (the original divides
        # by zero)
        scale = np.trace(np.diag(d) @ s_fix) / var_x if var_x > 0 else 0.0
    else:
        scale = 1.0
    t = my - scale * rot @ mx
    return scale, rot, t


def _quat_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def camera_centre(w2c: np.ndarray) -> np.ndarray:
    """The camera centre in the world of a world->camera SE(3) (7,)."""
    p = np.asarray(w2c, np.float64)
    q = p[0:4] / np.linalg.norm(p[0:4])
    return -_quat_matrix(q).T @ p[4:7]


def ate(est_c2w: List[np.ndarray], gt_w2c: List[np.ndarray]) -> float:
    """ATE of camToWorld Sim(3)/SE(3) poses against true world->camera
    poses, after a Sim(3) alignment; 0 with fewer than three poses."""
    if len(est_c2w) < 3:
        return 0.0
    est = np.asarray([p[4:7] for p in est_c2w], np.float64)
    gt = np.asarray([camera_centre(p) for p in gt_w2c])
    s, rot, t = umeyama_alignment(est, gt)
    err = (s * (rot @ est.T)).T + t - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def load_limits(cell_name: str) -> Dict[str, float]:
    with open(BENCH_DIR / "limits" / f"{cell_name}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def _trajectory_ate(out, replace=None) -> float:
    idx = sorted(i for i, p in out["answers"].items() if p is not None)
    est = [out["answers"][i] if replace is None else replace(i)
           for i in idx]
    return ate(est, [out["gt"][i % out["lap"]] for i in idx])


def _rotations(quats: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotation matrices of (N, 4) [w, x, y, z] quaternions."""
    q = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    return np.stack([_quat_matrix(r) for r in q])


def _angles(r: np.ndarray) -> np.ndarray:
    """Rotation angles of (N, 3, 3) matrices."""
    c = (np.trace(r, axis1=1, axis2=2) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def rpe_rad(pairs) -> float:
    """RMS angle between the relative rotation of each pair of consecutive
    estimated camToWorld poses and that of their true world->camera poses;
    `pairs` holds (est_a, est_b, gt_a, gt_b); 0 for no pair."""
    if not pairs:
        return 0.0
    est_a, est_b, gt_a, gt_b = (_rotations(np.asarray([p[k][0:4] for p in
                                                       pairs], np.float64))
                                for k in range(4))
    # a world->camera rotation's transpose is the camera's camToWorld one
    rel_est = est_a.transpose(0, 2, 1) @ est_b
    rel_gt = gt_a @ gt_b.transpose(0, 2, 1)
    err = _angles(rel_gt.transpose(0, 2, 1) @ rel_est)
    return float(np.sqrt(np.mean(err * err)))


def _trajectory_rpe(out, replace=None) -> float:
    """rpe_rad over every two consecutive answered frames."""
    idx = sorted(i for i, p in out["answers"].items() if p is not None)
    pick = (lambda i: out["answers"][i]) if replace is None else replace
    lap, gt = out["lap"], out["gt"]
    return rpe_rad([(pick(a), pick(a + 1), gt[a % lap], gt[(a + 1) % lap])
                    for a, b in zip(idx[:-1], idx[1:]) if b == a + 1])


def _undistort_err(out, camera, program_cam, dtype=torch.float64) -> float:
    p = camera.pinhole
    got = (program_cam.fx, program_cam.fy, program_cam.cx, program_cam.cy)
    want = (p.fx, p.fy, p.cx, p.cy)
    if any(abs(a - b) > 1e-9 * max(1.0, abs(b)) for a, b in zip(got, want)) \
            or (program_cam.width, program_cam.height) != (p.width, p.height):
        return float("inf")
    worst = 0.0
    for i, img in out["kept"].items():
        ref, _ = camera.reference_undistort(out["kept_raw"][i])
        if dtype is not torch.float64:
            img, _ = camera.reference_undistort(out["kept_raw"][i], dtype)
        worst = max(worst, float(np.max(np.abs(
            np.asarray(img, np.float64) - ref))))
    return worst


def judge(cell, out, camera, program_cam) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number the cell compares."""
    limits = load_limits(cell.name)
    got = {
        "lost": float(sum(p is None for p in out["answers"].values())),
        "ate_m": _trajectory_ate(out),
        "rpe_rad": _trajectory_rpe(out),
    }
    if camera.undistorts:
        got["undistort_err"] = _undistort_err(out, camera, program_cam)
    return {k: {"value": v, "limit": limits[k]} for k, v in got.items()}


def passed(numbers: Dict[str, dict]) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())


def control(out, camera) -> Dict[str, float]:
    """The control's readings, computed from the same run: the tracker's
    answer replaced by the pose of the keyframe it tracked against (a
    step that answers without the frame), and, for a distorting camera,
    the reference's undistortion computed in bfloat16 in the program's
    place."""
    poses = dict(out["keyframes"])

    def kf_pose(i):
        return poses.get(out["kf_of_frame"].get(i), out["answers"][i])

    got = {"ate_m": _trajectory_ate(out, kf_pose),
           "rpe_rad": _trajectory_rpe(out, kf_pose)}
    if camera.undistorts:
        got["undistort_err"] = _undistort_err(out, camera, camera.pinhole,
                                              torch.bfloat16)
    return got
