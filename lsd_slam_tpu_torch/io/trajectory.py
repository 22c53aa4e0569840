"""TUM-format trajectory logging.

A copy of lsd_slam_tpu/io/trajectory.py (== LiveSLAMWrapper::logCameraPose,
LiveSLAMWrapper.cpp:141-161): one line per tracked frame,
`time tx ty tz qx qy qz qw` (camToWorld), consumable by the TUM RGB-D
benchmark scripts.
"""

from __future__ import annotations

import numpy as np


def save_tum_trajectory(path: str, trajectory) -> None:
    """trajectory: iterable of (timestamp, frame_id, cam_to_world Sim3 (8,))."""
    with open(path, "w") as f:
        for ts, _fid, pose in trajectory:
            qw, qx, qy, qz = pose[0:4]
            tx, ty, tz = pose[4:7]
            f.write(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def load_tum_trajectory(path: str) -> np.ndarray:
    """Returns (N, 8) [ts, tx, ty, tz, qx, qy, qz, qw]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    return np.asarray(rows)
