"""The engine's concurrent modes on the CPU: the pipelined frame loop and
the threaded back-end and mapping thread, against the JAX engine.

The sequence of tests/test_torch_slam.py (PlaneScene(seed=13), 160x128,
the 36-frame out-and-back loop, the aggressive keyframe settings of
tests/test_slam_e2e.py), rendered by the JAX synth.

- `pipeline_lag=3` (sequential): each engine runs the scenario of
  tests/_torch_slam_scenario.py in a fresh process (that file says why),
  the port twice; all three start together. Bounds as in
  tests/test_torch_slam.py: the same keyframe ids, parents, edge pairs
  and counters, per-frame camera centres and rotations within 1e-3; the
  two port runs bit-identical (a fixed lag is a fixed retire schedule);
  the stored lag-3 JAX reference of this sequence has the live graph.
- A manual loss with frames in flight empties the ring, rolls the depth
  state back and recovers (tests/test_slam_e2e.py:271-289).
- `sequential=False` at lag 0 (mapping, constraint and optimisation
  threads) and at lag 3 (the pipelined ring with the threaded back-end):
  free-running, so not deterministic; held to properties: tracking good,
  every frame retired once, `n_edges >= keyframes - 1`, ATE < 0.03
  (tests/test_slam_e2e.py:134), no worker left alive after finalize.

Waits: on a thread or a queue at most 60 s; on the fresh processes up to
600 s, as in tests/test_torch_slam.py (the JAX engine's compile alone
takes about a minute on a loaded host).
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig, SystemConfig
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

from _torch_slam_scenario import H, KEYFRAME, N, W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_TOL = 1e-3
LAG = 3


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
def lag_runs(loop_seq, tmp_path_factory):
    """The JAX engine and two port runs at lag 3, each in a fresh process,
    started together (OMP_WAIT_POLICY=PASSIVE: idle OpenMP threads do not
    spin; it changes no result)."""
    cam, _, imgs, deps, _ = loop_seq
    seq = tmp_path_factory.mktemp("modes") / "seq.npz"
    np.savez(seq, imgs=imgs, deps=deps,
             cam=np.asarray([cam.fx, cam.fy, cam.cx, cam.cy]))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_WAIT_POLICY="PASSIVE")
    procs = {}
    try:
        for name, engine in (("jax", "jax"), ("port", "port"),
                             ("port2", "port")):
            out = seq.with_name(f"{name}.npz")
            procs[name] = out, subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "_torch_slam_scenario.py"),
                 engine, str(seq), str(out), str(LAG)],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)
        done = {}
        for name, (out, proc) in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (name, err[-4000:])
            done[name] = dict(np.load(out))
        return done
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def test_pipelined_matches_jax_engine(lag_runs):
    t, j = lag_runs["port"], lag_runs["jax"]
    assert t["good_before"] and t["tracking_is_good"]
    assert t["keyframe_ids"].tolist() == j["keyframe_ids"].tolist()
    assert t["parent_ids"].tolist() == j["parent_ids"].tolist()
    assert t["edges"].tolist() == j["edges"].tolist()
    assert t["counters"].tolist() == j["counters"].tolist()
    assert int(t["recovered"]) == int(j["recovered"]) >= 0
    for key in ("trajectory", "optimized"):
        a, b = t[key], j[key]
        assert a.shape == b.shape, key
        centre = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=1)
        rot = np.asarray([_rotation_angle(x[0:4], y[0:4])
                          for x, y in zip(a, b)])
        assert centre.max() <= TRAJ_TOL, (key, centre.max())
        assert rot.max() <= TRAJ_TOL, (key, rot.max())


def test_stored_lag3_reference_has_the_live_graph(lag_runs):
    """lsd_slam_tpu_torch/reference_data/slam_loop_160x128_lag3.json (the
    JAX engine on the port renderer's images of this sequence, written by
    tests/make_torch_slam_reference.py --scene loop --lag 3) builds the
    graph both live runs build."""
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "slam_loop_160x128_lag3.json")) as f:
        ref = json.load(f)
    assert ref["pipeline_lag"] == LAG and ref["n_frames"] == N
    for run in (lag_runs["jax"], lag_runs["port"]):
        assert run["keyframe_ids"].tolist() == ref["keyframe_ids"]
        assert run["parent_ids"].tolist() == ref["parent_ids"]
        assert run["edges"].tolist() == ref["edges"]
        assert int(run["recovered"]) == ref["recovered_at"]


def test_pipelined_runs_are_bit_identical(lag_runs):
    a, b = lag_runs["port"], lag_runs["port2"]
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _config(**system):
    return LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME), system=SystemConfig(**system))


def test_pipelined_loss_rolls_back_ring(loop_seq):
    """A manual loss while frames are in flight discards the ring, restores
    the depth state of before the lost frame and recovers through the
    relocaliser (tests/test_slam_e2e.py:271-289)."""
    _, tcam, imgs, deps, _ = loop_seq
    sys_ = SlamSystem(tcam, _config(pipeline_lag=LAG), device="cpu")
    sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, N):
        sys_.track_frame(imgs[i], i, i / 30.0)
    assert sys_.tracking_is_good
    assert len(sys_._ring) == LAG       # frames in flight
    # the retire of the oldest in-flight frame sees the loss: the state
    # rolls back to that frame's snapshot and the ring is discarded
    oldest = sys_._ring[0]
    sys_.manual_tracking_loss = True
    sys_.track_frame(imgs[N - 2], N, N / 30.0)
    assert not sys_._ring and not sys_.tracking_is_good
    assert sys_.map.state is oldest.snapshot[0]
    assert len(sys_.trajectory) == N - LAG
    for j, i in enumerate(range(N - 2, N // 2, -1)):
        sys_.track_frame(imgs[i], N + 1 + j, (N + 1 + j) / 30.0)
        if sys_.tracking_is_good:
            break
    assert not sys_._ring
    assert sys_.tracking_is_good, "no recovery after the pipelined loss"
    assert sys_.stats.snapshot().get("relocalized", 0) >= 1
    sys_.finalize()


@pytest.fixture
def few_threads():
    """Pin four torch threads for a threaded run, then restore."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("lag", [0, LAG])
def test_threaded_modes_hold_properties(loop_seq, few_threads, lag):
    """Free-running threaded runs (sequential=False): lag 0 tracks on the
    caller's thread and maps on the mapping thread; lag 3 keeps the ring
    and runs constraint search and PGO on their threads."""
    _, tcam, imgs, deps, gt = loop_seq
    sys_ = SlamSystem(tcam, _config(sequential=False, pipeline_lag=lag),
                      device="cpu")
    assert (sys_.mapping_thread is not None) == (lag == 0)
    try:
        sys_.gt_depth_init(imgs[0], deps[0], 0, 0.0)
        for i in range(1, N):
            sys_.track_frame(imgs[i], i, i / 30.0)
        sys_.block_until_mapped(60.0)
    finally:
        sys_.finalize()
    assert not any(w.alive() for w in sys_.workers())
    st = sys_.stats.snapshot()
    assert sys_.tracking_is_good
    frame_ids = [f for _, f, _ in sys_.trajectory]
    assert frame_ids == list(range(N))          # each retired exactly once
    graph = sys_.backend.graph
    assert graph.pose_graph.n_edges >= len(sys_.keyframes) - 1
    assert len(sys_.keyframes) >= 3
    assert ate_rmse(sys_.trajectory_array(), gt) < 0.03
    if lag == 0:
        assert st["mapping_batches"] >= 1 and st["mapping_batch_max"] >= 1
        assert st["mapping_frames_consumed"] >= 1
        assert sys_.mapping_thread.queue.dropped == 0
    assert st.get("constraint_searches", 0) >= len(sys_.keyframes) - 1
