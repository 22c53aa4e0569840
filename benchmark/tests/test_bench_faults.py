"""The rest of a run with the timed path broken underneath: the harness
driven on the CPU at 160x128 and 192x128, the lap twice as slow (the look
for a card skipped), each cell's own limits, and `correct` read. A sound
run passes; each fault the cells can have fails it: a step that returns
its state unchanged (every answer frame 0's pose), an answer altered
where it is produced (a pose's position, its rotation, an undistorted
frame). Each cell's control (answers replaced by keyframe poses; at
`euroc_cam0_wvga.creep` also the undistortion in bfloat16) reads above a
limit in a run, and at `tum_fr3_vga.loop`'s own lap and keyframe spacing
the pose control reads above both pose limits. A cell has no batch to
halve and no exchange between chips to leave out.

About three minutes on the CPU, most of it two warm-ups."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.cameras import pinhole as pinhole_model
from benchmark.harness import reference, scene
from benchmark.harness.spec import Cell

BENCH = Path(__file__).resolve().parents[1]
SECONDS = 6.0


def tiny_cell(cell_name, config_name, traffic_name, size):
    """The cell's configuration at `size` (intrinsics scaled with it, per
    axis; the program needs multiples of 16) and its mix with the lap at
    260 frames, so a window on the CPU tracks a few dozen frames; the
    cell's own name, so its own limits hold."""
    config = json.load(open(BENCH / "configs" / f"{config_name}.json"))
    traffic = json.load(open(BENCH / "traffic" / f"{traffic_name}.json"))
    cam = config["camera"]
    sx, sy = size[0] / cam["width"], size[1] / cam["height"]
    cam["fx"] *= sx
    cam["fy"] *= sy
    cam["cx"] = (cam["cx"] + 0.5) * sx - 0.5
    cam["cy"] = (cam["cy"] + 0.5) * sy - 0.5
    cam["width"], cam["height"] = size
    if "out_width" in cam:
        cam["out_width"], cam["out_height"] = size
    traffic.update(lap_frames=2 * 130, check_every=4)
    return Cell(name=cell_name, chips=1, config=config, traffic=traffic)


def pinhole_camera():
    cam = json.load(open(BENCH / "configs" / "tum_fr3_vga.json"))["camera"]
    return pinhole_model.Setup(cam)


@pytest.fixture(scope="module")
def pinhole():
    cell = tiny_cell("tum_fr3_vga.loop", "tum_fr3_vga", "loop", (160, 128))
    return cell, bench_run.Prepared(cell, "cpu")


@pytest.fixture(scope="module")
def radtan():
    cell = tiny_cell("euroc_cam0_wvga.creep", "euroc_cam0_wvga", "creep",
                     (192, 128))
    return cell, bench_run.Prepared(cell, "cpu")


def run(cell, prep, control=False, seconds=SECONDS):
    import time
    return bench_run.run_once(cell, prep, 2**31 + 3, seconds, False,
                              time.perf_counter_ns(), control)[:2]


def test_sound_run_is_correct_and_its_control_is_not(pinhole):
    cell, prep = pinhole
    result, ctrl = run(cell, prep, control=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 10
    assert ctrl["rpe_rad"] > result["checks"]["rpe_rad"]["limit"], ctrl


def test_pose_control_fails_at_the_loop_cells_own_lap():
    """A tracker that answers each frame with its keyframe's pose, on the
    loop mix's lap at a keyframe every 16 frames (the 6% of switch frames
    the cell reads on the card), with every other answer exact: it passes
    neither pose limit; exact answers pass both."""
    traffic = json.load(open(BENCH / "traffic" / "loop.json"))
    limits = reference.load_limits("tum_fr3_vga.loop")
    gt = scene.bench_trajectory(traffic["lap_frames"], traffic["span_m"],
                                traffic["yaw_amp_rad"], seed=2)
    lap = len(gt)

    def c2w(w2c):
        q = np.asarray(w2c[0:4], np.float64) * np.array([1, -1, -1, -1])
        return np.concatenate([q, reference.camera_centre(w2c), [1.0]])

    n = 3 * lap
    answers = {i: c2w(gt[i % lap]) for i in range(n)}
    kf_of = {i: i - i % 16 for i in range(n)}
    out = dict(lap=lap, gt=gt, answers=answers, kf_of_frame=kf_of,
               keyframes=[(k, answers[k])
                          for k in sorted(set(kf_of.values()))])
    assert reference._trajectory_ate(out) < 1e-6
    assert reference._trajectory_rpe(out) < 1e-6
    ctrl = reference.control(out, pinhole_camera())
    assert ctrl["ate_m"] > limits["ate_m"], ctrl
    assert ctrl["rpe_rad"] > limits["rpe_rad"], ctrl


def test_state_left_unchanged_fails(pinhole, monkeypatch):
    from lsd_slam_tpu_torch.system import SlamSystem
    cell, prep = pinhole
    orig = SlamSystem.track_frame

    def frozen(self, image, frame_id, timestamp=0.0):
        orig(self, image, frame_id, timestamp)
        return self.trajectory[0][2].copy()

    monkeypatch.setattr(SlamSystem, "track_frame", frozen)
    # long enough for the true path to spread past the cell's ATE limit
    result, _ = run(cell, prep, seconds=3 * SECONDS)
    assert not result["correct"]
    assert result["checks"]["ate_m"]["value"] > \
        result["checks"]["ate_m"]["limit"]


def test_altered_pose_fails(pinhole, monkeypatch):
    from lsd_slam_tpu_torch.system import SlamSystem
    cell, prep = pinhole
    orig = SlamSystem.track_frame

    def altered(self, image, frame_id, timestamp=0.0):
        pose = orig(self, image, frame_id, timestamp)
        if pose is not None and frame_id % 2:
            pose = pose.copy()
            pose[4] += 0.5
        return pose

    monkeypatch.setattr(SlamSystem, "track_frame", altered)
    # a Sim(3)-aligned ATE is at most the true path's spread: run long
    # enough for that spread to pass the cell's limit
    result, _ = run(cell, prep, seconds=3 * SECONDS)
    assert not result["correct"]
    assert result["checks"]["ate_m"]["value"] > \
        result["checks"]["ate_m"]["limit"]


def test_altered_rotation_fails(pinhole, monkeypatch):
    from lsd_slam_tpu_torch.system import SlamSystem
    cell, prep = pinhole
    orig = SlamSystem.track_frame
    turn = np.array([np.cos(0.025), 0.0, np.sin(0.025), 0.0])  # 0.05 rad

    def altered(self, image, frame_id, timestamp=0.0):
        pose = orig(self, image, frame_id, timestamp)
        if pose is not None and frame_id % 2:
            pose = pose.copy()
            w, x, y, z = pose[0:4]
            a, b, c, d = turn
            pose[0:4] = [a * w - b * x - c * y - d * z,
                         a * x + b * w + c * z - d * y,
                         a * y - b * z + c * w + d * x,
                         a * z + b * y - c * x + d * w]
        return pose

    monkeypatch.setattr(SlamSystem, "track_frame", altered)
    result, _ = run(cell, prep)
    assert not result["correct"]
    assert result["checks"]["rpe_rad"]["value"] > \
        result["checks"]["rpe_rad"]["limit"]


def test_undistortion_sound_altered_and_control(radtan, monkeypatch):
    from lsd_slam_tpu_torch.camera.undistort import Undistorter
    cell, prep = radtan
    result, ctrl = run(cell, prep, control=True)
    assert result["correct"], result["checks"]
    limit = result["checks"]["undistort_err"]["limit"]
    assert ctrl["undistort_err"] > limit, ctrl
    assert ctrl["rpe_rad"] > result["checks"]["rpe_rad"]["limit"], ctrl
    orig = Undistorter.__call__

    def shifted(self, image):
        return torch.roll(orig(self, image), 1, dims=1)

    monkeypatch.setattr(Undistorter, "__call__", shifted)
    result, _ = run(cell, prep)
    assert not result["correct"]
    assert result["checks"]["undistort_err"]["value"] > limit


def test_ate_of_a_frozen_trajectory_is_its_spread():
    gt = [np.array([1, 0, 0, 0, -x, 0, 0], np.float64) for x in
          (0.0, 0.5, 1.0)]
    est = [np.array([1, 0, 0, 0, 0, 0, 0, 1.0])] * 3
    assert reference.ate(est, gt) == pytest.approx(np.sqrt(1 / 6))
    assert reference.ate(copy.deepcopy(est[:2]), gt[:2]) == 0.0
