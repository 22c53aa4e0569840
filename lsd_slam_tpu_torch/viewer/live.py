"""Live map viewer: a separate process consuming the engine's output stream.

A numpy copy of lsd_slam_tpu/viewer/live.py; it reads the session
directory of either package (the same files), and writes its PNG through
utils.image_io.

Equivalent of the lsd_slam_viewer package (PointCloudViewer.cpp:106-298,
KeyFrameGraphDisplay.cpp, KeyFrameDisplay.cpp): the reference viewer is a
Qt/QGLViewer app subscribing to the keyframe/graph ROS topics; here the
transport is the FileOutput3DWrapper session directory (kf_*.npz +
graph.jsonl + poses.jsonl) tailed incrementally, and the display is a
z-buffer splat render refreshed to a PNG (headless-safe; point a browser /
image watcher at it) or an interactive matplotlib window when a display
exists.

The two load-bearing reference design points are preserved exactly:
  * per-keyframe points are unprojected ONCE when its npz first lands (==
    the one-time GL vertex-buffer upload, KeyFrameDisplay.cpp:106-222;
    re-uploaded only if the file is re-written);
  * graph messages re-pose the cached buffers WITHOUT touching points (==
    the memcpy of camToWorld per frame, KeyFrameGraphDisplay.cpp:158-208)
    — a million-point map never re-sends its points (README.md:310-324).

CLI:
    python -m lsd_slam_tpu_torch.viewer.live <session_dir> [out:view.png]
        [interval:0.5] [once] [frames:N]
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.viewer.render import MapRenderer


class KeyFrameDisplay:
    """Cached per-keyframe point buffer (== KeyFrameDisplay.{h,cpp}):
    keyframe-LOCAL points computed once from the npz, plus the current
    Sim3 camToWorld applied at draw time."""

    def __init__(self, path: str, scaled_var_th: float = 0.02,
                 abs_var_th: float = 0.1, sparsify: int = 1):
        self.path = path
        self.mtime = os.path.getmtime(path)
        d = np.load(path)
        self.id = int(d["id"])
        self.cam_to_world = np.asarray(d["cam_to_world"], np.float64)
        idepth = np.asarray(d["idepth"])
        var = np.asarray(d["idepth_var"])
        color = np.asarray(d["color"])
        h, w = idepth.shape
        fx = float(d["fx"]) if "fx" in d else 0.7 * w
        fy = float(d["fy"]) if "fy" in d else 0.7 * w
        cx = float(d["cx"]) if "cx" in d else (w - 1) / 2.0
        cy = float(d["cy"]) if "cy" in d else (h - 1) / 2.0

        valid = (var > 0) & (idepth > 0)
        scale = self.cam_to_world[7]
        depth = np.where(valid, 1.0 / np.maximum(idepth, 1e-9), 0.0)
        # the viewer's variance filters (KeyFrameDisplay.cpp:149-162)
        valid &= (var * depth ** 4 * scale ** 2 < scaled_var_th) \
            & (var < abs_var_th)
        ys, xs = np.nonzero(valid)
        if sparsify > 1 and len(ys):
            keep = np.random.default_rng(0).random(len(ys)) < 1.0 / sparsify
            ys, xs = ys[keep], xs[keep]
        z = 1.0 / idepth[ys, xs] if len(ys) else np.zeros(0)
        self.local_points = np.stack(
            [(xs - cx) / fx * z, (ys - cy) / fy * z, z], -1) \
            if len(ys) else np.zeros((0, 3))
        self.colors = color[ys, xs] if len(ys) else np.zeros(0)

    def world_points(self) -> Tuple[np.ndarray, np.ndarray]:
        c2w = self.cam_to_world
        rot = nps.quat_to_matrix(c2w[0:4])
        return (c2w[7] * self.local_points @ rot.T + c2w[4:7], self.colors)


class LiveViewer:
    """Incremental consumer of a FileOutput3DWrapper session directory
    (== KeyFrameGraphDisplay + PointCloudViewer main loop)."""

    def __init__(self, session_dir: str, out_png: Optional[str] = None,
                 width: int = 960, height: int = 720, sparsify: int = 1):
        self.dir = session_dir
        self.out_png = out_png or os.path.join(session_dir, "live_view.png")
        self.sparsify = sparsify
        self.displays: Dict[int, KeyFrameDisplay] = {}
        self.constraints: List[dict] = []
        self.current_pose: Optional[np.ndarray] = None
        self._graph_pos = 0
        self._poses_pos = 0
        self.renderer = MapRenderer(width, height)
        self.n_graph_updates = 0
        self.n_pose_updates = 0

    # -------------------------------------------------------------- ingest

    def poll(self) -> bool:
        """Consume everything new in the session dir; True if anything
        changed (== the viewer's ros spin + message callbacks)."""
        changed = False
        for path in sorted(glob.glob(os.path.join(self.dir, "kf_*.npz"))):
            if path.endswith(".tmp.npz"):
                continue
            try:
                mtime = os.path.getmtime(path)
                known = None
                for kd in self.displays.values():
                    if kd.path == path:
                        known = kd
                        break
                if known is None or mtime > known.mtime:
                    kd = KeyFrameDisplay(path, sparsify=self.sparsify)
                    self.displays[kd.id] = kd
                    changed = True
            except (OSError, ValueError, KeyError, EOFError):
                continue  # partially-written file: retry next poll
        changed |= self._tail_graph()
        changed |= self._tail_poses()
        return changed

    def _tail_graph(self) -> bool:
        path = os.path.join(self.dir, "graph.jsonl")
        if not os.path.exists(path):
            return False
        changed = False
        with open(path) as f:
            f.seek(self._graph_pos)
            for line in f:
                if not line.endswith("\n"):
                    break  # partial line; re-read next poll
                self._graph_pos += len(line)
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                # poses-only update: re-pose cached buffers, points
                # untouched (KeyFrameGraphDisplay.cpp:158-208)
                for fr in msg.get("frames", ()):
                    kd = self.displays.get(int(fr["id"]))
                    if kd is not None:
                        kd.cam_to_world = np.asarray(fr["cam_to_world"],
                                                     np.float64)
                self.constraints = msg.get("constraints", self.constraints)
                self.n_graph_updates += 1
                changed = True
        return changed

    def _tail_poses(self) -> bool:
        path = os.path.join(self.dir, "poses.jsonl")
        if not os.path.exists(path):
            return False
        changed = False
        with open(path) as f:
            f.seek(self._poses_pos)
            for line in f:
                if not line.endswith("\n"):
                    break
                self._poses_pos += len(line)
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                self.current_pose = np.asarray(msg["cam_to_world"],
                                               np.float64)
                self.n_pose_updates += 1
                changed = True
        return changed

    # -------------------------------------------------------------- render

    def assemble(self) -> Tuple[np.ndarray, np.ndarray]:
        pts, cols = [], []
        for kd in self.displays.values():
            p, c = kd.world_points()
            if len(p):
                pts.append(p)
                cols.append(c)
        if not pts:
            return np.zeros((0, 3)), np.zeros((0,))
        return np.concatenate(pts), np.concatenate(cols)

    def default_view(self) -> np.ndarray:
        """A pulled-back view behind the map centroid (the reference
        viewer's camera follows the current frame; stand back from it)."""
        if self.current_pose is not None:
            # behind the tracked camera: world->cam of the tracked pose,
            # then dolly back 1.5 units
            w2c = nps.sim3_inverse(self.current_pose)
            back = np.array([1, 0, 0, 0, 0, 0.0, 1.5, 1.0])
            return nps.sim3_mul(back, w2c)
        return np.array([1, 0, 0, 0, 0, 0, 1.5, 1.0])

    def render(self, view_w2c: Optional[np.ndarray] = None) -> np.ndarray:
        pts, cols = self.assemble()
        img = self.renderer.render(
            pts, cols, view_w2c if view_w2c is not None
            else self.default_view(), splat=2)
        return img

    def save(self, img: Optional[np.ndarray] = None) -> str:
        from lsd_slam_tpu_torch.utils.debug_viz import save_png
        if img is None:
            img = self.render()
        tmp = self.out_png + ".tmp.png"
        save_png(tmp, img)
        os.replace(tmp, self.out_png)
        return self.out_png

    # ----------------------------------------------------------------- run

    def run(self, interval: float = 0.5, max_frames: Optional[int] = None,
            stop_when_idle_s: Optional[float] = None) -> int:
        """Main loop: poll -> re-render on change (== the viewer's Qt timer
        loop). Returns the number of re-renders."""
        n = 0
        last_change = time.time()
        while True:
            if self.poll():
                self.save()
                n += 1
                last_change = time.time()
            if max_frames is not None and n >= max_frames:
                break
            if (stop_when_idle_s is not None
                    and time.time() - last_change > stop_when_idle_s):
                break
            time.sleep(interval)
        return n


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    session = argv[0]
    out_png = None
    interval = 0.5
    once = False
    frames = None
    for a in argv[1:]:
        if a.startswith("out:"):
            out_png = a[4:]
        elif a.startswith("interval:"):
            interval = float(a[9:])
        elif a.startswith("frames:"):
            frames = int(a[7:])
        elif a == "once":
            once = True
    v = LiveViewer(session, out_png)
    if once:
        v.poll()
        path = v.save()
        print(f"{len(v.displays)} keyframes, {len(v.constraints)} "
              f"constraints -> {path}")
        return 0
    n = v.run(interval=interval, max_frames=frames,
              stop_when_idle_s=30.0 if frames is None else None)
    print(f"live viewer exited after {n} renders "
          f"({len(v.displays)} keyframes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
