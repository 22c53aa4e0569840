"""The port's viewer, stitcher, map dump, live wrapper and threaded mode.

Counterparts of tests/test_live_viewer.py, tests/test_stitch.py and the
dump, viewer, live-wrapper and async-mode cases of
tests/test_product_surface.py, on the CPU. Besides: the port's
LiveViewer renders a session directory exactly as the JAX package's does,
and its stitcher writes the same frames (bit for bit, labels and the
`scale:` resize included).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from lsd_slam_tpu.viewer import live as jax_live
from lsd_slam_tpu.viewer import stitch as jax_stitch

from lsd_slam_tpu_torch.config import (KeyframeConfig, LSDConfig,
                                       SystemConfig)
from lsd_slam_tpu_torch.io.output import FileOutput3DWrapper
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils import synth
from lsd_slam_tpu_torch.utils.evaluate import ate_rmse
from lsd_slam_tpu_torch.viewer.live import LiveViewer
from lsd_slam_tpu_torch.viewer.stitch import stitch_dirs, stitch_grid

W, H = 160, 128


def _write_kf(d, kf_id, tx=0.0):
    h, w = 24, 32
    rng = np.random.default_rng(kf_id)
    idepth = rng.uniform(0.4, 0.6, (h, w)).astype(np.float32)
    var = np.full((h, w), 1e-4, np.float32)
    color = rng.uniform(0, 255, (h, w)).astype(np.float32)
    c2w = np.array([1, 0, 0, 0, tx, 0, 0, 1.0], np.float64)
    path = os.path.join(d, f"kf_{kf_id:06d}.npz")
    np.savez_compressed(path, id=kf_id, time=float(kf_id),
                        cam_to_world=c2w, idepth=idepth, idepth_var=var,
                        color=color, mean_idepth=0.5, num_points=h * w,
                        fx=22.4, fy=22.4, cx=(w - 1) / 2, cy=(h - 1) / 2)
    return path


# ------------------------------------------------ tests/test_live_viewer.py

def test_viewer_consumes_incrementally(tmp_path):
    d = str(tmp_path)
    v = LiveViewer(d, out_png=os.path.join(d, "v.png"))
    assert v.poll() is False

    _write_kf(d, 0)
    assert v.poll() is True
    assert set(v.displays) == {0}
    img1 = v.render(np.array([1, 0, 0, 0, 0, 0, 3.0, 1.0]))
    assert img1.any(), "first keyframe must render points"

    _write_kf(d, 7, tx=0.5)
    with open(os.path.join(d, "poses.jsonl"), "w") as f:
        f.write(json.dumps({"id": 8, "time": 0.2,
                            "cam_to_world": [1, 0, 0, 0, 0.5, 0, 0, 1]})
                + "\n")
    assert v.poll() is True
    assert set(v.displays) == {0, 7}
    assert v.current_pose is not None and v.current_pose[4] == 0.5
    assert v.poll() is False
    v.save()
    assert os.path.exists(v.out_png)
    np.testing.assert_array_equal(np.asarray(Image.open(v.out_png)),
                                  v.render())


def test_graph_update_reposes_without_recompute(tmp_path):
    d = str(tmp_path)
    _write_kf(d, 0)
    _write_kf(d, 3)
    v = LiveViewer(d, out_png=os.path.join(d, "v.png"))
    v.poll()
    kd = v.displays[3]
    pts_buf = kd.local_points
    w0, _ = kd.world_points()

    new_c2w = np.asarray(nps.sim3_mul(
        nps.sim3_exp(np.array([0.3, 0, 0, 0, 0, 0, 0.0])),
        kd.cam_to_world))
    with open(os.path.join(d, "graph.jsonl"), "w") as f:
        f.write(json.dumps({
            "frames": [{"id": 3, "cam_to_world": list(map(float, new_c2w))}],
            "constraints": [{"from": 0, "to": 3, "err": 0.1}],
        }) + "\n")
    assert v.poll() is True
    assert v.displays[3].local_points is pts_buf, \
        "graph update must NOT touch the cached point buffer"
    w1, _ = v.displays[3].world_points()
    assert np.abs(w1 - w0).max() > 0.05, "pose update must move the points"
    assert len(v.constraints) == 1


def test_rewritten_keyframe_reloads(tmp_path):
    d = str(tmp_path)
    p = _write_kf(d, 0)
    v = LiveViewer(d, out_png=os.path.join(d, "v.png"))
    v.poll()
    old_buf = v.displays[0].local_points
    os.utime(p, (os.path.getmtime(p) + 5, os.path.getmtime(p) + 5))
    assert v.poll() is True
    assert v.displays[0].local_points is not old_buf


def test_live_viewer_renders_as_jax_does(tmp_path):
    """The same session directory (keyframes, a graph update, a tracked
    pose) renders to the same image in both packages."""
    d = str(tmp_path)
    for kf_id, tx in ((0, 0.0), (4, 0.3), (9, -0.2)):
        _write_kf(d, kf_id, tx)
    with open(os.path.join(d, "graph.jsonl"), "w") as f:
        f.write(json.dumps({"frames": [
            {"id": 4, "cam_to_world": [0.995, 0.0998, 0, 0, 0.3, 0.1, 0, 1.2]}],
            "constraints": [{"from": 0, "to": 4, "err": 0.1}]}) + "\n")
    with open(os.path.join(d, "poses.jsonl"), "w") as f:
        f.write(json.dumps({"id": 10, "time": 0.3,
                            "cam_to_world": [1, 0, 0, 0, 0.1, 0, -0.5, 1]})
                + "\n")
    port = LiveViewer(d, width=320, height=240)
    ref = jax_live.LiveViewer(d, width=320, height=240)
    assert port.poll() and ref.poll()
    img = port.render()
    assert img.any()
    np.testing.assert_array_equal(img, ref.render())
    view = np.array([1, 0, 0, 0, 0, 0, 3.0, 1.0])
    np.testing.assert_array_equal(port.render(view), ref.render(view))


# ----------------------------------------------------- tests/test_stitch.py

def _write_frames(d, n, color):
    os.makedirs(d)
    for i in range(n):
        img = np.full((24, 32, 3), color, np.uint8)
        img[0, 0] = i
        img[5:9, 3:30] = (i * 40, 255 - color, 7)
        Image.fromarray(img).save(os.path.join(d, f"{i:04d}.png"))


def test_stitch_grid_pads_and_tiles():
    a = np.full((10, 20, 3), 10, np.uint8)
    b = np.full((8, 16, 3), 20, np.uint8)
    g = stitch_grid([a, b, a], cols=2)
    assert g.shape == (20, 40, 3)
    assert g[0, 0, 0] == 10 and g[0, 20, 0] == 20
    assert g[10, 20:].max() == 0


def test_stitch_dirs_truncates_to_shortest(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    _write_frames(d1, 5, 100)
    _write_frames(d2, 3, 200)
    out = str(tmp_path / "out")
    n = stitch_dirs([d1, d2], out, labels=["run a", "run b"])
    assert n == 3
    files = sorted(os.listdir(out))
    assert files == ["00000.png", "00001.png", "00002.png"]
    img = np.asarray(Image.open(os.path.join(out, "00002.png")))
    assert img.shape == (24, 64, 3)


@pytest.mark.parametrize("scale", [1.0, 0.5, 1.5])
def test_stitch_writes_what_jax_writes(tmp_path, scale):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    _write_frames(d1, 2, 100)
    _write_frames(d2, 2, 200)
    kw = dict(cols=1, labels=["a", ""], scale=scale)
    assert stitch_dirs([d1, d2], str(tmp_path / "port"), **kw) == \
        jax_stitch.stitch_dirs([d1, d2], str(tmp_path / "jax"), **kw) == 2
    for name in ("00000.png", "00001.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / name)),
            np.asarray(Image.open(tmp_path / "jax" / name)))


# ---------------------------------------- tests/test_product_surface.py

@pytest.fixture(scope="module")
def short_seq():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=21)
    poses = synth.orbit_trajectory(10, radius=0.05, fwd=0.01)
    imgs, deps = [], []
    for i in range(10):
        img, dep = synth.render(scene, cam, poses[i], device="cpu")
        imgs.append(img.numpy())
        deps.append(dep.numpy())
    return cam, np.stack(imgs), np.stack(deps), poses


def run_vo(cam, imgs, deps, cfg=None, output=None):
    sys_ = SlamSystem(cam, cfg or LSDConfig(width=W, height=H),
                      enable_slam=False, device="cpu")
    if output is not None:
        sys_.set_visualization(output)
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, len(imgs)):
        sys_.track_frame(imgs[i], i, i / 30.0)
    sys_.finalize()
    return sys_


@pytest.fixture(scope="module")
def vo_run(short_seq, tmp_path_factory):
    """A VO run with a FileOutput3DWrapper attached: the engine publishes
    every keyframe it finishes. The keyframe settings of
    tests/test_checkpoint.py switch keyframes within the 10 frames, so the
    camera-path animation has two keyframes to fly between."""
    cam, imgs, deps, _ = short_seq
    out_dir = tmp_path_factory.mktemp("session")
    out = FileOutput3DWrapper(str(out_dir), cam=cam)
    cfg = LSDConfig(width=W, height=H).replace(keyframe=KeyframeConfig(
        kf_dist_weight=12.0, initialization_phase_count=1, min_num_mapped=2))
    sys_ = run_vo(cam, imgs, deps, cfg, output=out)
    out.close()
    return sys_, out_dir


def test_engine_publishes_finished_keyframes(vo_run):
    sys_, out_dir = vo_run
    assert sys_.keyframes
    names = sorted(p.name for p in out_dir.glob("kf_*.npz"))
    assert names == [f"kf_{kf.id:06d}.npz" for kf in sys_.keyframes]
    d = np.load(out_dir / names[0])
    assert d["idepth"].shape == (H, W) and d["idepth"].dtype == np.float32
    assert int(d["id"]) == sys_.keyframes[0].id


def test_dump_map(tmp_path, vo_run):
    sys_, _ = vo_run
    from lsd_slam_tpu_torch.io.dump import dump_map

    dump_map(str(tmp_path), sys_)
    files = os.listdir(tmp_path)
    assert any(f.startswith("depth-") for f in files)
    assert "errorMatrix.txt" in files
    assert "keyframes.txt" in files
    kf = sys_.keyframes[0]
    img = np.asarray(Image.open(tmp_path / f"frame-{kf.id:06d}.png"))
    assert img.shape == (H, W, 3)
    np.testing.assert_array_equal(img[..., 0], np.clip(
        kf.pyr.images[0].numpy(), 0, 255).astype(np.uint8))


def test_viewer_renders_map(tmp_path, vo_run):
    sys_, _ = vo_run
    cam = sys_.cam
    kfs = sys_.keyframes
    from lsd_slam_tpu_torch.viewer import animate_camera_path, render_map_view

    img = render_map_view(kfs, cam, out_path=str(tmp_path / "view.png"),
                          width=320, height=240)
    assert img.shape == (240, 320, 3)
    assert img.max() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path /
                                                        "view.png")), img)
    assert len(kfs) >= 2
    n = animate_camera_path(kfs, cam, str(tmp_path / "anim"), n_frames=4,
                            width=160, height=120)
    assert n == 4 and len(os.listdir(tmp_path / "anim")) == 4


def test_live_wrapper_runs_and_resets(short_seq):
    cam, imgs, _, _ = short_seq
    from lsd_slam_tpu_torch.io.live import LiveSLAMWrapper

    w = LiveSLAMWrapper(cam, LSDConfig(width=W, height=H), enable_slam=False,
                        device="cpu")
    assert w.system.device.type == "cpu"
    for i in range(6):
        w.process_frame(imgs[i], i / 30.0)
    assert w.system.current_keyframe is not None
    assert len(w.system.trajectory) >= 1
    w.request_reset()
    for i in range(6, 10):
        w.process_frame(imgs[i], i / 30.0)
    assert w.system.current_keyframe is not None
    assert w.system.device.type == "cpu"
    assert w._frame_count == 10


def test_live_wrapper_loop_drains_the_queue(short_seq, tmp_path):
    """Frames pushed from a capture thread's side are tracked by `loop`,
    and each tracked pose is published."""
    cam, imgs, _, _ = short_seq
    from lsd_slam_tpu_torch.io.live import LiveSLAMWrapper

    out = FileOutput3DWrapper(str(tmp_path), cam=cam)
    w = LiveSLAMWrapper(cam, LSDConfig(width=W, height=H), enable_slam=False,
                        output=out, device="cpu")
    for i in range(4):
        assert w.push_image(imgs[i], i / 30.0)
    w.loop(stop_condition=lambda: w.queue.size() == 0)
    out.close()
    assert w._frame_count == 4
    with open(tmp_path / "poses.jsonl") as f:
        assert len(f.readlines()) == 3
    w.save_trajectory(str(tmp_path / "traj.txt"))
    assert len(open(tmp_path / "traj.txt").readlines()) == 4


def test_async_mapping_mode(short_seq):
    """Threaded mode: tracking pushes to the mapping thread; tracking
    stays good over the whole sequence."""
    cam, imgs, deps, gt = short_seq
    cfg = LSDConfig(width=W, height=H).replace(
        system=SystemConfig(sequential=False))
    sys_ = SlamSystem(cam, cfg, enable_slam=False, device="cpu")
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, len(imgs)):
        sys_.track_frame(imgs[i], i, i / 30.0)
        sys_.block_until_mapped(30.0)
    sys_.finalize()
    assert sys_.tracking_is_good
    assert sys_.current_keyframe.num_mapped_on_this_total >= 1
    err = ate_rmse(sys_.trajectory_array(), gt)
    assert err < 0.02, err
