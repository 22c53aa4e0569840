"""End-to-end visual odometry of the port on the CPU (sequential, hz=0).

The four tests of tests/test_vo_e2e.py, run against lsd_slam_tpu_torch on
the same synthetic sequence (rendered by the JAX synth and handed over as
numpy), plus frame-by-frame parity of the gt-init trajectory with the JAX
engine: the same keyframe frame ids, and per-frame camera centres within
1e-3 (scene depths are 1.5-4.5) and rotations within 1e-3 rad. The two
engines differ only by f32 rounding order (XLA contracts multiply-adds
into FMAs, reductions sum in another order), which the LM loop and the
depth filter damp rather than amplify.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.system import SlamSystem as JaxSystem
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

W, H = 160, 128
N_FRAMES = 18


@pytest.fixture(scope="module")
def sequence():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=7)
    poses = synth.orbit_trajectory(N_FRAMES, radius=0.06, fwd=0.01)
    imgs, deps = [], []
    for i in range(N_FRAMES):
        img, dep = synth.render(scene, cam, jnp.asarray(poses[i]))
        imgs.append(np.asarray(img))
        deps.append(np.asarray(dep))
    tcam = Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W,
                  height=H)
    return tcam, np.stack(imgs), np.stack(deps), poses


def _run(cam, imgs, deps, n, finalize=True):
    sys_ = SlamSystem(cam, LSDConfig(width=W, height=H), device="cpu")
    sys_.gt_depth_init(imgs[0], deps[0], frame_id=0, timestamp=0.0)
    for i in range(1, n):
        sys_.track_frame(imgs[i], i, float(i) / 30.0)
    if finalize:
        sys_.finalize()
    return sys_


@pytest.fixture(scope="module")
def gt_run(sequence):
    cam, imgs, deps, _ = sequence
    return _run(cam, imgs, deps, N_FRAMES)


def test_vo_gt_init_tracks_sequence(sequence, gt_run):
    *_, gt_poses = sequence
    assert gt_run.tracking_is_good
    traj = gt_run.trajectory_array()
    assert traj.shape[0] == N_FRAMES
    err = ate_rmse(traj, gt_poses)
    assert err < 0.01, f"ATE {err}"


def test_vo_creates_keyframes(gt_run):
    assert len(gt_run.keyframes) >= 1
    kf = gt_run.current_keyframe
    assert kf.num_points > 0.05 * W * H


def test_vo_depth_improves_with_observations(sequence):
    cam, imgs, deps, _ = sequence
    sys_ = _run(cam, imgs, deps, 8, finalize=False)
    counters = sys_.stats.snapshot()
    assert counters.get("observe_updated", 0) > 500, counters
    kf = sys_.current_keyframe
    if kf.id == 0:
        idepth = kf.depth.idepth[0].numpy()
        valid = kf.depth.ivar[0].numpy() > 0
        gt_idepth = 1.0 / np.maximum(deps[0], 1e-6)
        rel = np.abs(idepth - gt_idepth) / gt_idepth
        assert valid.mean() > 0.1
        assert np.median(rel[valid]) < 0.05, float(np.median(rel[valid]))


def test_vo_random_init_converges(sequence):
    cam, imgs, _, _ = sequence
    sys_ = SlamSystem(cam, LSDConfig(width=W, height=H), seed=3,
                      device="cpu")
    sys_.random_init(imgs[0], 0, 0.0)
    for i in range(1, N_FRAMES):
        sys_.track_frame(imgs[i], i, float(i) / 30.0)
    assert sys_.current_keyframe is not None
    assert sys_.current_keyframe.num_points > 0


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def test_vo_trajectory_matches_jax_engine(sequence, gt_run):
    _, imgs, deps, _ = sequence
    jsys = JaxSystem(synth.default_camera(W, H), JaxConfig(width=W, height=H),
                     enable_slam=False)
    jsys.gt_depth_init(imgs[0], deps[0], frame_id=0, timestamp=0.0)
    for i in range(1, N_FRAMES):
        jsys.track_frame(imgs[i], i, float(i) / 30.0)
    jsys.finalize()
    assert [kf.id for kf in gt_run.keyframes] == \
        [kf.id for kf in jsys.keyframes]
    assert gt_run.stats.snapshot()["keyframes_created"] == \
        jsys.stats.snapshot()["keyframes_created"]
    a, b = jsys.trajectory_array(), gt_run.trajectory_array()
    assert a.shape == b.shape
    centre = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1)
    rot = np.asarray([_rotation_angle(x[0:4], y[0:4]) for x, y in zip(a, b)])
    assert centre.max() <= 1e-3, centre
    assert rot.max() <= 1e-3, rot
