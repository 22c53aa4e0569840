"""Sequential SLAM of the port on the CPU, and its parity with the JAX engine.

The sequence of tests/test_slam_e2e.py: PlaneScene(seed=13), 160x128, the
36-frame out-and-back loop, its `slam_config()` (aggressive keyframes, no
initialisation gating), rendered by the JAX synth and handed over as
numpy. One scenario serves every test, run once by each engine in a fresh
process (tests/_torch_slam_scenario.py says why): gt-depth init, 35
tracked frames (keyframe switches, re-activations, constraint search and
pose-graph optimisation per new keyframe), then a manual tracking loss and
the return leg fed backwards until the relocaliser recovers, then
finalize.

Parity bounds: the same keyframe ids, edge pairs (in insertion order) and
counters; per frame, camera centres within 1e-3 (scene depths are
1.5-4.5) and rotations within 1e-3 rad, for the trajectory as logged at
track time and as recomputed through the optimised pose tree. The
engines differ only by f32 rounding order. That order depends on the
number of CPU threads the port's reductions are split over, and the
scenario is sensitive to it: the Sim(3) LM stops on a relative-error test,
so with one thread the constraint of keyframe 5 lands elsewhere and the
optimised trajectory 1.37e-3 away. The port's run therefore pins
`PORT_THREADS` torch threads, so that its rounding is the same on every
host.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.config import KeyframeConfig as JaxKeyframeConfig
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch import interop
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

from _torch_slam_scenario import (COUNTERS, H, KEYFRAME, N, W,
                                  nonparent_edges)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_TOL = 1e-3


def jax_config():
    return JaxConfig(width=W, height=H).replace(
        keyframe=JaxKeyframeConfig(**KEYFRAME))


@pytest.fixture(scope="module")
def loop_seq():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=13)
    poses = synth.loop_trajectory(N)
    imgs, deps = [], []
    for i in range(N):
        img, dep = synth.render(scene, cam, jnp.asarray(poses[i]))
        imgs.append(np.asarray(img))
        deps.append(np.asarray(dep))
    tcam = Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W,
                  height=H)
    return cam, tcam, np.stack(imgs), np.stack(deps), poses


@pytest.fixture(scope="module")
def seq_file(loop_seq, tmp_path_factory):
    cam, _, imgs, deps, _ = loop_seq
    path = tmp_path_factory.mktemp("slam") / "seq.npz"
    np.savez(path, imgs=imgs, deps=deps,
             cam=np.asarray([cam.fx, cam.fy, cam.cx, cam.cy]))
    return path


@pytest.fixture(scope="module")
def runs(seq_file):
    """Each engine's run of the scenario in a fresh process, the two
    started together. OMP_WAIT_POLICY=PASSIVE keeps the port's idle
    OpenMP threads from spinning on a busy host; it changes no result."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_WAIT_POLICY="PASSIVE")
    procs = {}
    try:
        for engine in ("jax", "port"):
            out = seq_file.with_name(f"{engine}.npz")
            procs[engine] = out, subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "_torch_slam_scenario.py"),
                 engine, str(seq_file), str(out)],
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


@pytest.fixture(scope="module")
def port_run(runs):
    return runs["port"]


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs["jax"]


def test_slam_is_the_default_mode(loop_seq):
    _, tcam, *_ = loop_seq
    sys_ = SlamSystem(tcam, interop.config_from_dict(
        dataclasses.asdict(jax_config())), device="cpu")
    assert sys_.enable_slam and sys_.backend is not None


def test_slam_builds_graph_and_constraints(loop_seq, port_run):
    *_, gt = loop_seq
    r = port_run
    assert r["good_before"] and r["tracking_is_good"]
    n_kf = len(r["keyframe_ids"])
    assert n_kf >= 3, n_kf
    assert r["n_vertices"] == n_kf
    assert r["n_edges"] >= n_kf - 1
    err = ate_rmse(r["trajectory"][:N], gt)
    assert err < 0.02, err


def test_slam_finds_nonparent_constraint(port_run):
    """A loop closure: an edge between two keyframes of which neither was
    tracked on the other (keyframe 17, tracked on 10, constrained to 5)."""
    parents = dict(zip(port_run["keyframe_ids"].tolist(),
                       port_run["parent_ids"].tolist()))
    edges = [tuple(e) for e in port_run["edges"].tolist()]
    assert nonparent_edges(parents, edges), (parents, edges)


def test_slam_relocalizes_after_manual_loss(loop_seq, port_run):
    *_, gt = loop_seq
    recovered = int(port_run["recovered"])
    assert recovered >= 0, "relocaliser never recovered"
    assert port_run["counters"][COUNTERS.index("relocalized")] >= 1
    est_c2w = port_run["trajectory"][-1]
    gt_c2w = np.asarray(jlie.se3_inverse(jnp.asarray(gt[recovered],
                                                     jnp.float32)))
    assert np.linalg.norm(est_c2w[4:7] - gt_c2w[4:7]) < 0.05


def test_slam_reactivates_keyframe(port_run):
    ids = port_run["keyframe_ids"].tolist()
    assert len(set(ids)) == len(ids)
    assert port_run["counters"][COUNTERS.index("keyframes_reactivated")] >= 1


def test_promotion_uses_latest_tracked_not_popped(loop_seq):
    """A promotion uses the freshest tracked frame (latestTrackedFrame,
    SlamSystem.cpp:783-786), not the frame handed to the mapping call."""
    _, tcam, imgs, deps, _ = loop_seq
    sys_ = SlamSystem(tcam, interop.config_from_dict(
        dataclasses.asdict(jax_config())), device="cpu")
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, 8):
        sys_.track_frame(imgs[i], i, i / 30.0)
    stale = sys_.latest_tracked
    sys_.track_frame(imgs[8], 8, 8 / 30.0)
    fresh = sys_.latest_tracked
    assert fresh is not stale and fresh.id != stale.id
    sys_.create_new_keyframe = True
    sys_.do_mapping_iteration(stale)
    assert sys_.current_keyframe.id == fresh.id
    assert sys_.latest_tracked is fresh


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def test_slam_matches_jax_engine(port_run, jax_run):
    t, j = port_run, jax_run
    assert t["keyframe_ids"].tolist() == j["keyframe_ids"].tolist()
    assert t["parent_ids"].tolist() == j["parent_ids"].tolist()
    assert t["edges"].tolist() == j["edges"].tolist()
    assert t["counters"].tolist() == j["counters"].tolist()
    assert int(t["recovered"]) == int(j["recovered"])
    for key in ("trajectory", "optimized"):
        a, b = t[key], j[key]
        assert a.shape == b.shape, key
        centre = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1)
        rot = np.asarray([_rotation_angle(x[0:4], y[0:4])
                          for x, y in zip(a, b)])
        assert centre.max() <= TRAJ_TOL, (key, centre.max())
        assert rot.max() <= TRAJ_TOL, (key, rot.max())
