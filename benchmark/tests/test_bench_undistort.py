"""The radtan camera at a small size: the raw frame the generator renders
through the model, undistorted by the program's `Undistorter`, lands on
the pinhole render at the output camera; the reference's output camera
and remap agree with the program's; the control (the reference computed
in bfloat16) does not."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.cameras import radtan
from benchmark.harness import scene

CONFIG = Path(__file__).resolve().parents[1] / "configs" / \
    "euroc_cam0_wvga.json"


def small_camera(scale=4):
    cam = dict(json.load(open(CONFIG))["camera"])
    for k in ("fx", "fy"):
        cam[k] /= scale
    for k in ("cx", "cy"):
        cam[k] = (cam[k] + 0.5) / scale - 0.5
    for k in ("width", "height", "out_width", "out_height"):
        cam[k] //= scale
    return radtan.Setup(cam)


def test_undistorted_raw_frame_lands_on_the_pinhole_render():
    cam = small_camera()
    prog_cam, und = cam.program("cpu")
    scn = scene.BenchScene(seed=4)
    pose = scene.bench_trajectory(130, seed=4)[20]
    raw, _ = scene.render_bench(scn, cam.pinhole, pose, "cpu",
                                cam.dirs_cam("cpu"))
    want, depth = scene.render_bench(scn, cam.pinhole, pose, "cpu")
    got = und(raw)
    inner = torch.zeros_like(depth, dtype=torch.bool)
    inner[4:-4, 4:-4] = True
    diff = (got - want).abs()[inner & (depth > 0)]
    # bilinear resampling of a textured image: small on most pixels
    assert float(diff.median()) < 2.0, float(diff.median())
    # a wrong camera (the raw intrinsics) misses by far more
    wrong = radtan.Setup(dict(json.load(open(CONFIG))["camera"]))
    assert wrong.pinhole.fx != cam.pinhole.fx


def test_reference_remap_and_camera_agree_with_the_program():
    cam = small_camera()
    prog_cam, und = cam.program("cpu")
    p = cam.pinhole
    for a, b in zip((prog_cam.fx, prog_cam.fy, prog_cam.cx, prog_cam.cy),
                    (p.fx, p.fy, p.cx, p.cy)):
        assert abs(a - b) <= 1e-9 * max(1.0, abs(b))
    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 255, cam.raw[::-1]).astype(np.float32)
    ref, valid = cam.reference_undistort(raw)
    got = und(torch.as_tensor(raw)).numpy()
    assert np.max(np.abs(got - ref)) < 0.01
    assert np.all(got[~valid] == 0)
    bf16, _ = cam.reference_undistort(raw, torch.bfloat16)
    assert np.max(np.abs(bf16 - ref)) > 1.0
