"""Checkpoints cross between the packages: one npz format (FORMAT_VERSION 1).

The scenario of tests/test_checkpoint.py: 160x128, PlaneScene(seed=31),
orbit_trajectory(16, radius=0.08, fwd=0.012), SLAM on, gt-depth init,
frames 0-9, a checkpoint, then frames 10-15 resumed from it. The JAX
engine's checkpoint loads in the port (on the CPU) and the port's in the
JAX engine, with the same keyframe ids, edge count and keyframe poses
(Sim(3) log of the difference < 1e-6, as in tests/test_checkpoint.py).
Both engines resume frames 10-15 from the JAX file; their trajectories
agree per frame within the 160x128 loop bounds of chip_smoke.py's
SLAM_RUNS (6e-3 in centre, 2.5e-3 rad).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lsd_slam_tpu.config import KeyframeConfig as JaxKeyframeConfig
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.io import checkpoint as jax_ckpt
from lsd_slam_tpu.system import SlamSystem as JaxSystem
from lsd_slam_tpu.utils import synth as jax_synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
from lsd_slam_tpu_torch.io import checkpoint
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.system import SlamSystem

W, H, N, SAVE_AT = 160, 128, 16, 10
TRAJ_C, TRAJ_R = 6e-3, 2.5e-3
KEYFRAME = dict(kf_dist_weight=12.0, initialization_phase_count=1,
                min_num_mapped=2)


def jax_cfg():
    return JaxConfig(width=W, height=H).replace(
        keyframe=JaxKeyframeConfig(**KEYFRAME))


def port_cfg():
    return LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME))


@pytest.fixture(scope="module")
def seq():
    cam = jax_synth.default_camera(W, H)
    scene = jax_synth.PlaneScene(seed=31)
    poses = jax_synth.orbit_trajectory(N, radius=0.08, fwd=0.012)
    imgs, deps = [], []
    for i in range(N):
        img, dep = jax_synth.render(scene, cam, jnp.asarray(poses[i]))
        imgs.append(np.asarray(img))
        deps.append(np.asarray(dep))
    tcam = Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W,
                  height=H)
    return cam, tcam, np.stack(imgs), np.stack(deps)


def _track_first(sys_, imgs, deps):
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, SAVE_AT):
        sys_.track_frame(imgs[i], i, i / 30.0)
    # force at least one finished keyframe in the store
    if not sys_.keyframes:
        sys_.finish_current_keyframe()
    return sys_


def _resume(sys_, imgs):
    for i in range(SAVE_AT, N):
        sys_.track_frame(imgs[i], i, i / 30.0)
    return sys_


@pytest.fixture(scope="module")
def jax_saved(seq, tmp_path_factory):
    cam, _, imgs, deps = seq
    sys_ = _track_first(JaxSystem(cam, jax_cfg(), enable_slam=True), imgs,
                        deps)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jax_ckpt.save_system(path, sys_)
    return sys_, path


@pytest.fixture(scope="module")
def port_saved(seq, tmp_path_factory):
    _, tcam, imgs, deps = seq
    sys_ = _track_first(SlamSystem(tcam, port_cfg(), device="cpu"), imgs,
                        deps)
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    checkpoint.save_system(path, sys_)
    return sys_, path


def _same_store(a, b):
    """The keyframe ids, edge count, keyframe poses and trajectory length
    of two systems (of either package) agree."""
    assert [kf.id for kf in a.keyframes] == [kf.id for kf in b.keyframes]
    assert a.backend.graph.pose_graph.n_edges == \
        b.backend.graph.pose_graph.n_edges
    assert [(e.first.id, e.second.id) for e in a.backend.graph.edges] == \
        [(e.first.id, e.second.id) for e in b.backend.graph.edges]
    for ka, kb in zip(a.keyframes, b.keyframes):
        d = nps.sim3_log_norm(nps.sim3_mul(
            nps.sim3_inverse(ka.pose.cam_to_world()),
            kb.pose.cam_to_world()))
        assert d < 1e-6, (ka.id, d)
    assert len(a.trajectory) == len(b.trajectory)


def test_checkpoint_files_have_the_same_keys_and_dtypes(jax_saved,
                                                         port_saved):
    a, b = np.load(port_saved[1]), np.load(jax_saved[1])
    assert int(a["format_version"]) == int(b["format_version"]) == \
        checkpoint.FORMAT_VERSION == jax_ckpt.FORMAT_VERSION
    assert a["kf_ids"].tolist() == b["kf_ids"].tolist()
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)


def test_jax_checkpoint_loads_in_the_port(jax_saved):
    jsys, path = jax_saved
    tsys = checkpoint.load_system(path, port_cfg(), device="cpu")
    assert tsys.device.type == "cpu"
    assert len(tsys.keyframes) >= 1
    _same_store(jsys, tsys)


def test_port_checkpoint_loads_in_jax(port_saved, seq):
    tsys, path = port_saved
    _, _, imgs, _ = seq
    jsys = jax_ckpt.load_system(path, jax_cfg())
    _same_store(tsys, jsys)
    _resume(jsys, imgs)
    assert jsys.tracking_is_good
    assert len(jsys.trajectory) == N


def test_port_checkpoint_roundtrip_and_resume(port_saved, seq):
    """tests/test_checkpoint.py's round trip, all in the port."""
    tsys, path = port_saved
    _, _, imgs, _ = seq
    sys2 = checkpoint.load_system(path, port_cfg(), device="cpu")
    _same_store(tsys, sys2)
    _resume(sys2, imgs)
    assert sys2.tracking_is_good
    assert len(sys2.trajectory) > len(tsys.trajectory)


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def test_both_engines_resume_the_jax_checkpoint_alike(jax_saved, seq):
    _, path = jax_saved
    _, _, imgs, _ = seq
    jsys = _resume(jax_ckpt.load_system(path, jax_cfg()), imgs)
    tsys = _resume(checkpoint.load_system(path, port_cfg(), device="cpu"),
                   imgs)
    assert jsys.tracking_is_good and tsys.tracking_is_good
    assert [kf.id for kf in tsys.keyframes] == [kf.id for kf in jsys.keyframes]
    a, b = tsys.trajectory_array(), jsys.trajectory_array()
    assert a.shape == b.shape and len(a) == N
    centre = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1)
    rot = np.asarray([_rotation_angle(x[0:4], y[0:4]) for x, y in zip(a, b)])
    assert centre.max() <= TRAJ_C, centre
    assert rot.max() <= TRAJ_R, rot
