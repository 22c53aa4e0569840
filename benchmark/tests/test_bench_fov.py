"""The FOV camera (`cameras/fov.py`) at a quarter of its size: the raw
frame the generator renders through the model, undistorted by the
program's `Undistorter`, lands on the pinhole render at the output
camera; the reference's output camera and remap agree with the
program's; the control (the reference computed in bfloat16) does not.
At the configuration's full size, tables only: the program's output
camera is the reference's (else `undistort_err` reads infinite) and every
pixel of the crop is valid."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark.cameras import fov
from benchmark.harness import scene

BENCH = Path(__file__).resolve().parents[1]
CONFIG = BENCH / "configs" / "tum_monovo_sxga.json"
LIMITS = BENCH / "limits" / "tum_monovo_sxga.creep.json"


def config_camera():
    return dict(json.load(open(CONFIG))["camera"])


def small_camera(scale=4):
    """The camera at 1/scale of its size; its intrinsics are relative to
    the image size, so they stay as they are."""
    cam = config_camera()
    for k in ("width", "height", "out_width", "out_height"):
        cam[k] //= scale
    return fov.Setup(cam)


def same_camera(got, want):
    return all(abs(a - b) <= 1e-9 * max(1.0, abs(b)) for a, b in zip(
        (got.fx, got.fy, got.cx, got.cy), (want.fx, want.fy, want.cx,
                                           want.cy))) \
        and (got.width, got.height) == (want.width, want.height)


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
    # the raw frame itself (no undistortion) misses by far more
    miss = (raw - want).abs()[inner & (depth > 0)]
    assert float(miss.median()) > 4 * float(diff.median())


def test_reference_remap_and_camera_agree_with_the_program():
    cam = small_camera()
    prog_cam, und = cam.program("cpu")
    assert same_camera(prog_cam, cam.pinhole)
    rng = np.random.default_rng(0)
    raw = rng.uniform(0, 255, cam.raw[::-1]).astype(np.float32)
    ref, valid = cam.reference_undistort(raw)
    got = und(torch.as_tensor(raw)).numpy()
    # the program gathers in float32 from float32 tables
    assert np.max(np.abs(got - ref)) < 0.01
    assert np.all(got[~valid] == 0)


def test_the_bfloat16_control_misses():
    cam = small_camera()
    rng = np.random.default_rng(1)
    raw = rng.uniform(0, 255, cam.raw[::-1]).astype(np.float32)
    ref, _ = cam.reference_undistort(raw)
    bf16, _ = cam.reference_undistort(raw, torch.bfloat16)
    miss = np.max(np.abs(bf16 - ref))
    limit = json.load(open(LIMITS))["limits"]["undistort_err"]
    assert miss > 1.0 and miss > limit, (miss, limit)


def test_full_size_tables_give_the_reference_camera_and_a_valid_crop():
    cam = fov.Setup(config_camera())
    prog_cam, und = cam.program("cpu")
    assert (prog_cam.width, prog_cam.height) == (1280, 1024)
    assert same_camera(prog_cam, cam.pinhole)
    assert bool(und._valid.all())
    assert np.all((cam.map_x >= 0) & (cam.map_y >= 0))
