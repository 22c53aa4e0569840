"""One full pyramidal SE(3) track in both packages from the same reference
and frame (carried across as numpy through lsd_slam_tpu_torch.interop).

The whole 23-scalar host pack and the good-pixel mask are compared.
Tolerances: poses to 2e-5 (the LM sums reduce ~10^4 points in another
order, so each accepted step differs in the last f32 bits), residuals and
usage to 1e-4 relative, the good/bad counts to 0.2% of the points, the
affine gain/offset to 1e-3 (they come from differences of large moment
sums), the good mask at no more than 0.2% of the pixels.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.frames import build_frame, build_depth_pyramid
from lsd_slam_tpu.tracking import SE3Tracker as JaxTracker, make_tracking_ref
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.interop import (frame_pyramid_from_dict,
                                        tracking_ref_from_dict)
from lsd_slam_tpu_torch.tracking import SE3Tracker
from lsd_slam_tpu_torch.tracking.se3_tracker import HOST_PACK

from _torch_parity import to_dict, np_

W, H = 160, 128


@pytest.fixture(scope="module")
def tracked():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=5)
    pose_a = jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32)
    tangent = np.array([0.02, -0.012, 0.015, 0.006, -0.01, 0.004], np.float32)
    pose_b = jlie.se3_mul(jlie.se3_exp(jnp.asarray(tangent)), pose_a)
    img_a, dep_a = (np.asarray(x) for x in synth.render(scene, cam, pose_a))
    img_b, _ = (np.asarray(x) for x in synth.render(scene, cam, pose_b))
    # an exported depth: -1 marks invalid pixels, like Keyframe.set_depth
    rng = np.random.default_rng(0)
    keep = (rng.uniform(size=dep_a.shape) < 0.7) & (dep_a > 0)
    idepth = np.where(keep, 1.0 / np.maximum(dep_a, 1e-6), -1.0)
    ivar = np.where(keep, rng.uniform(5e-4, 2e-3, dep_a.shape), -1.0)
    ref = make_tracking_ref(
        build_frame(jnp.asarray(img_a)),
        build_depth_pyramid(jnp.asarray(idepth, jnp.float32),
                            jnp.asarray(ivar, jnp.float32)),
        min_level=1, with_sim3=False)
    frame = build_frame(jnp.asarray(img_b))
    cfg = JaxConfig(width=W, height=H)
    init = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    jres = JaxTracker(cam, cfg.tracker, 16.0, True).track(ref, frame, init)
    tres = SE3Tracker(Camera(**dataclasses.asdict(cam)),
                      LSDConfig(width=W, height=H).tracker, 16.0, True).track(
        tracking_ref_from_dict(to_dict(ref), device="cpu"),
        frame_pyramid_from_dict(to_dict(frame), device="cpu"),
        torch.from_numpy(init))
    return to_dict(jres), np_(tres), tres


def test_track_host_pack_matches(tracked):
    j, t, _ = tracked
    a, b = j["host_pack"].astype(np.float64), t["host_pack"].astype(np.float64)
    assert a.shape == b.shape == (23,)
    assert a[HOST_PACK["tracking_good"]] == 1.0
    for key in ("ref_to_frame", "frame_to_ref"):
        np.testing.assert_allclose(b[HOST_PACK[key]], a[HOST_PACK[key]],
                                   rtol=0, atol=2e-5, err_msg=key)
    assert b[HOST_PACK["diverged"]] == a[HOST_PACK["diverged"]]
    assert b[HOST_PACK["tracking_good"]] == a[HOST_PACK["tracking_good"]]
    for key in ("last_residual", "point_usage", "initial_residual"):
        np.testing.assert_allclose(b[HOST_PACK[key]], a[HOST_PACK[key]],
                                   rtol=1e-4, err_msg=key)
    n_pts = a[HOST_PACK["good_count"]] + a[HOST_PACK["bad_count"]]
    for key in ("good_count", "bad_count"):
        assert abs(b[HOST_PACK[key]] - a[HOST_PACK[key]]) <= 0.002 * n_pts
    for key in ("affine_a", "affine_b"):
        np.testing.assert_allclose(b[HOST_PACK[key]], a[HOST_PACK[key]],
                                   rtol=0, atol=1e-3, err_msg=key)


def test_track_recovers_motion_and_good_mask(tracked):
    j, t, tres = tracked
    assert t["good_mask"].shape == j["good_mask"].shape == (H // 2, W // 2)
    assert (t["good_mask"] != j["good_mask"]).mean() <= 0.002
    assert tres.n_syncs > 4  # one per level start plus one per LM trial
    assert not bool(tres.diverged)
