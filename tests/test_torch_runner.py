"""The dataset runner of the port against the JAX runner, on one PNG folder.

Both packages' `io.runner.main` run the same folder of 30 PNG frames
(160x128, the port's `make_sequence` quantised to uint8 and written by
Pillow, so its adaptive row filters reach the port's decoder) with an
identity calibration (FOV omega 0, `none`), once with `vo` and once with
SLAM on, each engine in a fresh process, the two started
together (tests/_torch_runner_scenario.py). The runner starts from
`random_init`; the port's run takes JAX's draw.

Bounds:
- trajectory, per frame: VO 1e-3 in centre and rotation (rad), as
  tests/test_torch_vo.py; SLAM 6e-3 / 2.5e-3 rad (the 160x128 loop bounds
  of chip_smoke.py's SLAM_RUNS);
- keyframe npz files: the same names, keys, dtypes and shapes; the valid
  masks (idepth_var > 0) differ on at most 1% of the pixels (the run:
  0.48%); where both are valid, per keyframe the median of
  |idepth / idepth_jax - 1| is at most 2.5e-3, its 90th percentile at
  most 7e-3, its 99th percentile at most 2.5e-2 and its maximum at most
  0.3 (a fault confined to a few pixels of the depth filter moves them by
  far more). A max bound of 1e-3 does not hold from the third keyframe on,
  not even between two runs of the port that differ only in their torch
  thread count (1 or 3 against 8): their medians reach 1.04e-3, 90th
  percentiles 3.37e-3, 99th percentiles 1.2e-2, maxima 0.143 (the port
  against JAX: 1.34e-3, 2.02e-3, 9.64e-3, 0.117); the bounds are about
  twice that spread;
- SLAM: the same keyframe ids and graph.jsonl edge pairs, message by
  message; the PLY's point count within 2% of JAX's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from lsd_slam_tpu.io import runner as jax_runner

from lsd_slam_tpu_torch.io import runner
from lsd_slam_tpu_torch.io.trajectory import load_tum_trajectory
from lsd_slam_tpu_torch.utils import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 160, 128, 30
VO_TOL = 1e-3
SLAM_C, SLAM_R = 6e-3, 2.5e-3
MASK_FRAC = 0.01
IDEPTH_MEDIAN, IDEPTH_P90, IDEPTH_P99, IDEPTH_MAX = (2.5e-3, 7e-3,
                                                     2.5e-2, 0.3)
PLY_FRAC = 0.02
OUTPUTS = ("estimated_poses.txt", "poses.jsonl", "graph.jsonl",
           "pointcloud.ply")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    files = root / "frames"
    files.mkdir()
    _, imgs, _, _ = synth.make_sequence(n_frames=N, width=W, height=H,
                                        device="cpu")
    for i, img in enumerate(imgs.numpy()):
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            files / f"{i:05d}.png")
    calib = root / "calib.cfg"
    calib.write_text(f"0.7 {0.7 * W / H} {((W - 1) / 2 + 0.5) / W} "
                     f"{((H - 1) / 2 + 0.5) / H} 0\n{W} {H}\nnone\n{W} {H}\n")
    draw = root / "draw.npy"
    np.save(draw, np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (H, W), jnp.float32, 0.5, 1.5)))
    return root, files, calib, draw


@pytest.fixture(scope="module")
def runs(dataset):
    """{engine: {mode: output dir}}, each engine's runs in a fresh
    process, the two started together."""
    root, files, calib, draw = dataset
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_WAIT_POLICY="PASSIVE")
    procs = {}
    try:
        for engine in ("jax", "port"):
            out = root / engine
            procs[engine] = out, subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "_torch_runner_scenario.py"),
                 engine, str(files), str(calib), str(out), str(draw)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        done = {}
        for engine, (out, proc) in procs.items():
            stdout, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (engine, err[-4000:])
            assert stdout.count("done: 30 frames") == 2, stdout
            done[engine] = {m: out / m for m in ("vo", "slam")}
        return done
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def _traj_diff(a_dir, b_dir):
    a = load_tum_trajectory(str(a_dir / "estimated_poses.txt"))
    b = load_tum_trajectory(str(b_dir / "estimated_poses.txt"))
    assert a.shape == b.shape == (N, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    centre = np.linalg.norm(a[:, 1:4] - b[:, 1:4], axis=1)
    # TUM rows are [ts, tx, ty, tz, qx, qy, qz, qw]
    rot = [_rotation_angle(x[4:8], y[4:8]) for x, y in zip(a, b)]
    return centre.max(), max(rot)


def _graph_messages(d):
    with open(d / "graph.jsonl") as f:
        return [json.loads(line) for line in f]


def _ply_count(path):
    with open(path, "rb") as f:
        head = f.read(256).split(b"end_header\n")[0].decode()
    return int(head.split("element vertex ")[1].split()[0])


@pytest.mark.parametrize("argv", [
    ["files:/d", "calib:/c.cfg"],
    ["files:/d", "calib:/c.cfg", "hz:30", "out:/o", "vo", "dump",
     "checkpoint:/k.npz", "resume:/r.npz", "profile:/p", "pipeline:3"],
    ["hz:0.5", "pipeline:0", "unknown", "out:rel/dir"],
])
def test_parse_args_matches_jax(argv):
    """Every flag of the JAX grammar parses to the same value; the port
    adds only `device` (None unless given)."""
    got = runner.parse_args(argv)
    assert got.pop("device") is None
    assert got == jax_runner.parse_args(argv)
    assert runner.parse_args(argv + ["device:cpu"])["device"] == "cpu"


def test_multihost_raises():
    """`multihost:` raised until the multi-process slice was ported (the
    name is kept); it now parses as the JAX runner parses it, spec and
    ports alike."""
    for spec in ("0:2", "1:2:5000", "1:4:5000:6000"):
        argv = ["files:/d", f"multihost:{spec}"]
        got = runner.parse_args(argv)
        assert got.pop("device") is None
        assert got == jax_runner.parse_args(argv)
        assert (runner.parse_multihost(spec)
                == jax_runner._parse_multihost(spec))


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert runner.run_device(runner.parse_args([])) == torch.device("cuda")
    assert runner.run_device(runner.parse_args(["device:cpu"])) == \
        torch.device("cpu")


def test_runner_without_cuda_names_the_cpu_option(monkeypatch, dataset):
    _, files, calib, _ = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device:cpu"):
        runner.main([f"files:{files}", f"calib:{calib}"])


@pytest.mark.parametrize("mode", ["vo", "slam"])
def test_runner_writes_every_output(runs, mode):
    for engine in ("jax", "port"):
        d = runs[engine][mode]
        for name in OUTPUTS:
            assert (d / name).is_file(), (engine, mode, name)
        assert len(list(d.glob("kf_*.npz"))) >= 2


def test_vo_trajectory_matches_jax(runs):
    centre, rot = _traj_diff(runs["port"]["vo"], runs["jax"]["vo"])
    assert centre <= VO_TOL and rot <= VO_TOL, (centre, rot)


def test_vo_keyframes_match_jax(runs):
    port, ref = runs["port"]["vo"], runs["jax"]["vo"]
    names = sorted(p.name for p in port.glob("kf_*.npz"))
    assert names == sorted(p.name for p in ref.glob("kf_*.npz"))
    for name in names:
        a, b = np.load(port / name), np.load(ref / name)
        assert sorted(a.files) == sorted(b.files), name
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, \
                (name, k, a[k].dtype, b[k].dtype, a[k].shape, b[k].shape)
        assert int(a["id"]) == int(b["id"])
        va, vb = a["idepth_var"] > 0, b["idepth_var"] > 0
        assert (va != vb).mean() <= MASK_FRAC, (name, (va != vb).mean())
        both = va & vb
        rel = np.abs(a["idepth"][both] / b["idepth"][both] - 1.0)
        assert np.median(rel) <= IDEPTH_MEDIAN, (name, np.median(rel))
        assert np.percentile(rel, 90) <= IDEPTH_P90, (
            name, np.percentile(rel, 90))
        assert np.percentile(rel, 99) <= IDEPTH_P99, (
            name, np.percentile(rel, 99))
        assert rel.max() <= IDEPTH_MAX, (name, rel.max())


def test_vo_pose_stream_matches_jax(runs):
    counts = {}
    for engine in ("jax", "port"):
        with open(runs[engine]["vo"] / "poses.jsonl") as f:
            msgs = [json.loads(line) for line in f]
        assert all(len(m["cam_to_world"]) == 8 for m in msgs)
        counts[engine] = len(msgs)
    assert counts["port"] == counts["jax"] == N - 1, counts


def test_slam_graph_matches_jax(runs):
    port, ref = runs["port"]["slam"], runs["jax"]["slam"]
    assert sorted(p.name for p in port.glob("kf_*.npz")) == \
        sorted(p.name for p in ref.glob("kf_*.npz"))
    gp, gj = _graph_messages(port), _graph_messages(ref)
    assert len(gp) == len(gj) >= 1
    for mp, mj in zip(gp, gj):
        assert [f["id"] for f in mp["frames"]] == \
            [f["id"] for f in mj["frames"]]
        assert [(c["from"], c["to"]) for c in mp["constraints"]] == \
            [(c["from"], c["to"]) for c in mj["constraints"]]


def test_slam_trajectory_matches_jax(runs):
    centre, rot = _traj_diff(runs["port"]["slam"], runs["jax"]["slam"])
    assert centre <= SLAM_C and rot <= SLAM_R, (centre, rot)


def test_slam_point_cloud_matches_jax(runs):
    n_port = _ply_count(runs["port"]["slam"] / "pointcloud.ply")
    n_jax = _ply_count(runs["jax"]["slam"] / "pointcloud.ply")
    assert n_jax > 0
    assert abs(n_port - n_jax) <= PLY_FRAC * n_jax, (n_port, n_jax)


def test_checkpoint_resume_dump_and_profile_on_the_cpu(dataset, tmp_path,
                                                       capsys):
    """The port's runner in this process (device:cpu, SLAM on): frames
    0-14 with `checkpoint:`, `dump` and `profile:`, then frames 15-29 from
    a second folder with `resume:`; the resumed trajectory holds all 30
    frames and its tracking stays good."""
    _, files, calib, _ = dataset
    first, second = tmp_path / "first", tmp_path / "second"
    first.mkdir()
    second.mkdir()
    for i, p in enumerate(sorted(files.glob("*.png"))):
        (first if i < N // 2 else second).joinpath(p.name).write_bytes(
            p.read_bytes())
    ckpt, prof = tmp_path / "ckpt.npz", tmp_path / "prof"
    runner.main([f"files:{first}", f"calib:{calib}",
                 f"out:{tmp_path / 'a'}", f"checkpoint:{ckpt}", "dump",
                 f"profile:{prof}", "device:cpu"])
    assert ckpt.is_file() and (prof / "trace.json").is_file()
    assert (tmp_path / "a" / "dump" / "keyframes.txt").is_file()
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    runner.main([f"files:{second}", f"calib:{calib}",
                 f"out:{tmp_path / 'b'}", f"resume:{ckpt}", "device:cpu"])
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "done: 15 frames" in printed
    traj = load_tum_trajectory(str(tmp_path / "b" / "estimated_poses.txt"))
    assert traj.shape == (N, 8)
    np.testing.assert_array_equal(traj[:, 0], np.arange(N))
    with open(tmp_path / "b" / "poses.jsonl") as f:
        assert len(f.readlines()) == N // 2
