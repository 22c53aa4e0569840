"""The camera stream of a cell: its scene texture, trajectory jitter and
sensor noise drawn from the seed, and its engine, driven as a closed loop
(the next frame goes in as soon as the previous call returns).

What the stream hands the program is only the generated frames: the raw
image of each frame, which the program's undistorter (where the camera
has one) and then `SlamSystem.track_frame` take. Everything the
reference later needs (true poses, the scene's seeds) stays here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import room, scene

MASK64 = (1 << 64) - 1


def stream_seeds(seed: int):
    """(texture, jitter, noise) seeds of a run with `seed`: any whole
    number, negative or past 64 bits included."""
    ss = np.random.SeedSequence([int(seed) & MASK64, 0])
    return tuple(int(x) for x in ss.generate_state(3))


def check_offset(seed: int, every: int) -> int:
    """The frames whose undistorted image the check keeps are those with
    index % every == this offset, drawn from the seed."""
    ss = np.random.SeedSequence([int(seed) & MASK64, 1 << 20])
    return int(ss.generate_state(1)[0] % every)


def engine_config(cell, cam_prog):
    """The program's LSDConfig at the camera's size with the
    configuration's `engine` sections applied by field name."""
    from lsd_slam_tpu_torch.config import LSDConfig
    cfg = LSDConfig(width=cam_prog.width, height=cam_prog.height)
    for section, values in cell.config["engine"].items():
        if isinstance(values, dict):
            cfg = cfg.replace(**{section: dataclasses.replace(
                getattr(cfg, section), **values)})
    return cfg


@dataclasses.dataclass
class Frame:
    index: int
    t_start: int          # perf_counter_ns at the call into the program
    t_end: int            # ... and at its return
    pose: Optional[np.ndarray]   # camToWorld Sim(3) (8,); None: lost
    kf_before: int
    kf_after: int

    @property
    def switched(self) -> bool:
        return self.kf_after != self.kf_before


class Stream:
    def __init__(self, cell, seed: int, device, camera, dirs_cam,
                 trace: bool = False):
        self.cell = cell
        self.device = torch.device(device)
        self.camera = camera                 # the cameras/<model>.Setup
        self.dirs_cam = dirs_cam
        self.trace = trace
        tr = cell.traffic
        self.tex_seed, self.jit_seed, self.noise_seed = stream_seeds(seed)
        self.lap = int(tr["lap_frames"])
        self.fps = float(cell.config["fps"])
        self.every = int(tr["check_every"])
        self.offset = check_offset(seed, self.every)
        self.frames: List[Frame] = []
        self.kept = {}            # frame index -> undistorted image
        self.und_spans = []       # (start, end) perf_counter_ns, traced runs

    # ------------------------------------------------------------- set-up
    def setup(self, program_camera, cfg, undistorter):
        """Render the lap on the device, build the engine and seed its map
        from frame 0's true depth."""
        from lsd_slam_tpu_torch.system import SlamSystem
        tr = self.cell.traffic
        self.gt = scene.bench_trajectory(self.lap, tr["span_m"],
                                         tr["yaw_amp_rad"],
                                         seed=self.jit_seed)
        scn, render = self.scene()
        w, h = self.camera.raw
        self.raw = torch.empty((self.lap, h, w), dtype=torch.float32,
                               device=self.device)
        for i in range(self.lap):
            self.raw[i] = scene.render_realistic(
                scn, self.camera.pinhole, self.gt[i], i,
                float(tr["noise_sigma"]), self.device, self.noise_seed,
                self.dirs_cam, render=render)[0]
        # frame 0's true depth in the camera of the images the program
        # tracks (the undistorted one where the camera distorts)
        _, depth0 = (render or scene.render_bench)(
            scn, self.camera.pinhole, self.gt[0], self.device)
        self.undistorter = undistorter
        self.sys = SlamSystem(program_camera, cfg,
                              enable_slam=bool(self.cell.config["engine"]
                                               .get("enable_slam", True)),
                              device=self.device)
        img0 = self.raw[0]
        if undistorter is not None:
            img0 = undistorter(img0)
        self.sys.gt_depth_init(img0, depth0, 0, 0.0)
        self.answers = {0: self.sys.trajectory[-1][2].copy()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def scene(self):
        """(scene, renderer; None: `scene.render_bench`): the room with the
        seed's texture (`room.RoomScene`), or, where the mix names a
        `texture_seed`, the frozen `scene.BenchScene` of that seed."""
        tex = self.cell.traffic.get("texture_seed")
        if tex is None:
            return room.RoomScene(seed=self.tex_seed), room.render_room
        return scene.BenchScene(seed=int(tex)), None

    # ------------------------------------------------------------- window
    def run(self, t0_ns: int, t_end_ns: int):
        """The closed loop from t0 until t_end (perf_counter_ns); the call
        in flight at t_end finishes and is recorded."""
        sys_, und, raw, n = self.sys, self.undistorter, self.raw, self.lap
        self.stats_start = sys_.stats.snapshot()
        self.timer_start = len(sys_.timers.samples.get("frame_step", ()))
        i = 1
        while time.perf_counter_ns() < t0_ns:
            time.sleep(0.0005)
        while True:
            t_s = time.perf_counter_ns()
            if t_s >= t_end_ns:
                break
            kf_before = sys_.current_keyframe.id
            img = raw[i % n]
            if und is not None:
                img = und(img)
                if self.trace:
                    self.und_spans.append((t_s, time.perf_counter_ns()))
                if i % self.every == self.offset:
                    self.kept[i] = img
            pose = sys_.track_frame(img, i, i / self.fps)
            t_e = time.perf_counter_ns()
            self.frames.append(Frame(i, t_s, t_e, pose,
                                     kf_before, sys_.current_keyframe.id))
            i += 1
        self.stats_end = sys_.stats.snapshot()
        self.timer_samples = list(
            sys_.timers.samples.get("frame_step", ()))[self.timer_start:]

    # ------------------------------------------------------------- results
    def in_window(self, t_end_ns: int) -> List[Frame]:
        """The frames that completed inside the window."""
        return [f for f in self.frames if f.t_end <= t_end_ns]

    def counter(self, key: str) -> float:
        return float(self.stats_end.get(key, 0.0)
                     - self.stats_start.get(key, 0.0))

    def take_outputs(self) -> dict:
        """What the check judges, copied to the host: every frame's answer,
        each keyframe's id and pose, the undistorted frames kept; then the
        engine and the frames are released."""
        sys_ = self.sys
        kfs = list(sys_.keyframes)
        if sys_.current_keyframe is not None and \
                sys_.current_keyframe not in kfs:
            kfs.append(sys_.current_keyframe)
        keyframes = [(kf.id, np.asarray(kf.cam_to_world())) for kf in kfs]
        kept = {i: t.cpu().numpy() for i, t in self.kept.items()}
        kept_raw = {i: self.raw[i % self.lap].cpu().numpy()
                    for i in self.kept}
        self.summary = dict(
            frames=len(self.frames),
            first_lost=next((f.index for f in self.frames if f.pose is None),
                            None),
            keyframes=len(keyframes),
            **{k: int(self.counter(k)) for k in (
                "keyframes_created", "keyframes_reactivated", "relocalized",
                "pgo_calls", "sim3_stage0_n")},
            pgo_ms=round(self.counter("pgo_ms"), 1),
            switch_frames=sum(f.switched for f in self.frames))
        answers = dict(self.answers)
        for f in self.frames:
            answers[f.index] = None if f.pose is None else np.asarray(f.pose)
        out = dict(lap=self.lap, gt=self.gt, answers=answers,
                   keyframes=keyframes, kept=kept, kept_raw=kept_raw,
                   kf_of_frame={f.index: f.kf_before for f in self.frames})
        self.sys = None
        self.raw = None
        self.kept = {}
        self.undistorter = None
        return out
