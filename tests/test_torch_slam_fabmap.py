"""Sequential SLAM with the appearance index on (`use_fabmap=True`): the
port against the JAX engine on the CPU, over the whole path.

The scenario and sequence of tests/test_torch_slam.py (160x128, the
36-frame loop of PlaneScene(seed=13), gt-depth init, a manual loss and the
relocaliser's recovery, finalize), with `use_fabmap=True`, so every
keyframe is described into the AppearanceIndex and every constraint
search queries it. Each engine runs once in a fresh process
(tests/_torch_slam_scenario.py says why), the two started together.

Bounds: the same keyframe ids, tracking parents, edge pairs (in order),
counters and recovery frame; per frame, the trajectory as logged and as
optimised within SLAM_RUNS["slam-loop"]'s bounds of chip_smoke.py (6e-3
in camera centre, 2.5e-3 rad), about twice the spread of runs of this
scenario that differ only in rounding (`make_torch_slam_reference.py
--scene loop --fabmap --check-port --threads T / --noise-seed S`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from lsd_slam_tpu.utils import synth

from _torch_slam_scenario import COUNTERS, H, N, W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CENTRE_TOL, ROT_TOL = 6e-3, 2.5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=13)
    poses = synth.loop_trajectory(N)
    imgs, deps = [], []
    for i in range(N):
        img, dep = synth.render(scene, cam, jnp.asarray(poses[i]))
        imgs.append(np.asarray(img))
        deps.append(np.asarray(dep))
    seq = tmp_path_factory.mktemp("fabmap") / "seq.npz"
    np.savez(seq, imgs=np.stack(imgs), deps=np.stack(deps),
             cam=np.asarray([cam.fx, cam.fy, cam.cx, cam.cy]))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_WAIT_POLICY="PASSIVE")
    procs = {}
    try:
        for engine in ("jax", "port"):
            out = seq.with_name(f"{engine}.npz")
            procs[engine] = out, subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "_torch_slam_scenario.py"),
                 engine, str(seq), str(out), "0", "1"],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)
        done = {}
        for engine, (out, proc) in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (engine, err[-4000:])
            done[engine] = dict(np.load(out))
        return done
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def test_stored_fabmap_reference_is_the_jax_run(runs):
    """reference_data/slam_loop_160x128_fabmap.json (written by
    `make_torch_slam_reference.py --scene loop --fabmap`) holds this JAX
    run's graph."""
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "slam_loop_160x128_fabmap.json")) as f:
        ref = json.load(f)
    j = runs["jax"]
    assert ref["use_fabmap"] and ref["n_frames"] == N
    assert j["keyframe_ids"].tolist() == ref["keyframe_ids"]
    assert j["parent_ids"].tolist() == ref["parent_ids"]
    assert j["edges"].tolist() == ref["edges"]
    assert int(j["recovered"]) == ref["recovered_at"]


def test_fabmap_slam_matches_jax_engine(runs):
    t, j = runs["port"], runs["jax"]
    n_kf = len(j["keyframe_ids"])
    assert n_kf >= 3 and int(j["appearance_size"]) == n_kf
    assert int(t["appearance_size"]) == n_kf
    assert int(t["appearance_queries"]) >= 1
    assert t["keyframe_ids"].tolist() == j["keyframe_ids"].tolist()
    assert t["parent_ids"].tolist() == j["parent_ids"].tolist()
    assert t["edges"].tolist() == j["edges"].tolist()
    assert t["counters"].tolist() == j["counters"].tolist()
    assert int(t["recovered"]) == int(j["recovered"]) >= 0
    assert t["counters"][COUNTERS.index("relocalized")] >= 1
    assert bool(t["tracking_is_good"])
    for key in ("trajectory", "optimized"):
        a, b = t[key], j[key]
        assert a.shape == b.shape, key
        centre = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1)
        rot = np.asarray([_rotation_angle(x[0:4], y[0:4])
                          for x, y in zip(a, b)])
        assert centre.max() <= CENTRE_TOL, (key, centre.max())
        assert rot.max() <= ROT_TOL, (key, rot.max())
