"""The frozen generator against the program's own (`lsd_slam_tpu_torch.
utils.synth`) at 160x128, bit for bit: the scene's draws, the trajectory,
and the realistic render with its noise; and the generator's additions
(a stream's noise seed, a distorting camera's rays, another renderer)
left off by default."""

import numpy as np
import torch

from benchmark.cameras.pinhole import Pinhole
from benchmark.harness import scene
from benchmark.harness.stream import check_offset, stream_seeds
from lsd_slam_tpu_torch.utils import synth


def _cam():
    cam = synth.default_camera(160, 128)
    return cam, Pinhole(cam.fx, cam.fy, cam.cx, cam.cy, 160, 128)


def test_trajectory_is_the_programs():
    for n, seed in ((130, 2), (40, 7), (1040, 123)):
        assert np.array_equal(scene.bench_trajectory(n, seed=seed),
                              synth.bench_trajectory(n, seed=seed))
    a = scene.bench_trajectory(130, span=1.2, yaw_amp=0.4, seed=3)
    b = synth.bench_trajectory(130, span=1.2, yaw_amp=0.4, seed=3)
    assert np.array_equal(a, b)


def test_scene_and_render_are_the_programs():
    cam, pin = _cam()
    poses = synth.bench_trajectory(130, seed=5)
    for seed in (0, 11, 2**31 + 5):
        ours, theirs = scene.BenchScene(seed=seed), synth.BenchScene(seed=seed)
        for k in ("normals", "offsets", "freqs", "phases", "amps", "panel_c",
                  "panel_n", "panel_u", "panel_v"):
            assert torch.equal(getattr(ours, k), getattr(theirs, k)), k
        for i in (0, 17, 64):
            a = scene.render_realistic(ours, pin, poses[i], i, 1.5, "cpu")
            b = synth.render_realistic(theirs, cam, poses[i], frame_index=i,
                                       noise_sigma=1.5, device="cpu")
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            c = scene.render_bench(ours, pin, poses[i], "cpu")
            d = synth.render_bench(theirs, cam, poses[i], device="cpu")
            assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])


def test_additions_change_only_what_they_name():
    _, pin = _cam()
    scn = scene.BenchScene(seed=3)
    pose = scene.bench_trajectory(130, seed=3)[9]
    a, da = scene.render_realistic(scn, pin, pose, 9, 1.5, "cpu")
    b, db = scene.render_realistic(scn, pin, pose, 9, 1.5, "cpu",
                                   noise_seed=99)
    assert torch.equal(da, db) and not torch.equal(a, b)
    dirs = scene.pinhole_dirs(pin.fx, pin.fy, pin.cx, pin.cy, 160, 128,
                              torch.device("cpu"))
    c, dc = scene.render_realistic(scn, pin, pose, 9, 1.5, "cpu",
                                   dirs_cam=dirs)
    assert torch.equal(a, c) and torch.equal(da, dc)


def test_seeds_take_any_whole_number():
    big = 2**31 + 12345
    assert stream_seeds(big) == stream_seeds(big)
    assert stream_seeds(big) != stream_seeds(big + 1)
    assert len(set(stream_seeds(-7))) == 3
    assert stream_seeds(2**70)        # wider than 64 bits: masked, no error
    assert 0 <= check_offset(big, 32) < 32
