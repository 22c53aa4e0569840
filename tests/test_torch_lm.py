"""The trackers' LM level loop (lsd_slam_tpu_torch/tracking/lm.py) against
the JAX `while_loop` programs it ports, at 160x128, from inputs made with a
numpy seed as in tests/test_torch_tracker.py.

* the SE(3) schedule, level by level (4..1, affine on), against
  `se3_tracker._track_level` under `jax.jit`;
* the quick schedule over a 4-lane batch (a good track, a lane started on
  the solution that stops on a small step, one that diverges at once, one
  from the identity) against `quick_tracker._quick_impl`, vmapped as the
  JAX package batches it.

Bounds (those of tests/test_torch_tracker.py): pose 2e-5, the level's error
1e-4 relative, affine gain/offset 1e-3, the diverged flags equal, and the
trial and accept counts equal. The counts come from the JAX loop's own
final state (its `trials` and `iter`), read through a wrapper of
`jax.lax.while_loop` while the program is traced.

On the card the same function launches the kernel `lm_level`; that it
equals the plain version there is `chip_smoke.py`'s `[lm]` phase and the
`cuda`-marked tests of tests/test_torch_rules.py (which imports no JAX, so
it runs on the card's host).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.frames import build_frame, build_depth_pyramid
from lsd_slam_tpu.tracking import make_tracking_ref
from lsd_slam_tpu.tracking import quick_tracker as jquick
from lsd_slam_tpu.tracking import se3_tracker as jse3
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.interop import (frame_pyramid_from_dict,
                                        tracking_ref_from_dict)
from lsd_slam_tpu_torch.ops import lm_track
from lsd_slam_tpu_torch.tracking import lm
from lsd_slam_tpu_torch.tracking.quick_tracker import (QuickTracker,
                                                       stack_points)

from _torch_parity import to_dict

W, H = 160, 128
SIGMA2 = 16.0


@contextlib.contextmanager
def loop_states():
    """Collect the final state of every `jax.lax.while_loop` traced inside
    (the JAX trackers' loops carry `trials` and `iter`)."""
    orig = jax.lax.while_loop
    seen = []

    def wrapped(cond, body, init):
        out = orig(cond, body, init)
        seen.append(out)
        return out

    jax.lax.while_loop = wrapped
    try:
        yield seen
    finally:
        jax.lax.while_loop = orig


@pytest.fixture(scope="module")
def scene():
    cam = synth.default_camera(W, H)
    world = synth.PlaneScene(seed=5)
    pose_a = jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32)
    tangent = np.array([0.02, -0.012, 0.015, 0.006, -0.01, 0.004], np.float32)
    pose_b = jlie.se3_mul(jlie.se3_exp(jnp.asarray(tangent)), pose_a)
    img_a, dep_a = (np.asarray(x) for x in synth.render(world, cam, pose_a))
    img_b, _ = (np.asarray(x) for x in synth.render(world, cam, pose_b))
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
    tref = tracking_ref_from_dict(to_dict(ref), device="cpu")
    tframe = frame_pyramid_from_dict(to_dict(frame), device="cpu")
    return dict(cam=cam, tcam=Camera(**dataclasses.asdict(cam)),
                cfg=JaxConfig(width=W, height=H).tracker,
                tcfg=LSDConfig(width=W, height=H).tracker, ref=ref,
                frame=frame, tref=tref, tframe=tframe,
                truth=np.asarray(pose_b, np.float32))


# ------------------------------------------------------------ SE(3) levels

@pytest.fixture(scope="module")
def se3_levels(scene):
    """JAX `_track_level` for levels 4..1, each started from the previous
    level's JAX output (pose and affine), with its trial and accept
    counts; returns [(level, inputs, outputs)]."""
    cam, cfg = scene["cam"], scene["cfg"]
    pose = np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)
    aff = (np.float32(1.0), np.float32(0.0))
    out = []
    for lvl in range(cfg.max_level, cfg.min_level - 1, -1):
        def run(pose, a, b, pts, quad, lvl=lvl):
            with loop_states() as seen:
                res = jse3._track_level(pose, a, b, pts, quad, cam.level(lvl),
                                        cfg, cfg.max_iterations[lvl], SIGMA2,
                                        True)
            return res, seen[0]["trials"], seen[0]["iter"]

        (p, a, b, err, div), trials, its = jax.jit(run)(
            jnp.asarray(pose), jnp.float32(aff[0]), jnp.float32(aff[1]),
            scene["ref"].pts[lvl], scene["frame"].quad[lvl])
        got = dict(pose=np.asarray(p), a=float(a), b=float(b),
                   err=float(err), div=bool(div), trials=int(trials),
                   its=int(its))
        out.append((lvl, (pose, aff), got))
        pose, aff = got["pose"], (np.float32(got["a"]), np.float32(got["b"]))
    return out


@pytest.mark.parametrize("which", range(4))
def test_se3_level_matches_jax(scene, se3_levels, which):
    lvl, (pose, aff), want = se3_levels[which]
    tcfg = scene["tcfg"]
    got = lm.level(torch.from_numpy(pose), torch.tensor(aff[0]),
                   torch.tensor(aff[1]), scene["tref"].pts[lvl],
                   scene["tframe"].quad[lvl], scene["tcam"].level(lvl), tcfg,
                   SIGMA2, lm.se3_schedule(tcfg, tcfg.max_iterations[lvl],
                                           True))
    assert want["trials"] > 1 and not want["div"], want
    np.testing.assert_allclose(got.pose.numpy(), want["pose"], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(float(got.last_err), want["err"], rtol=1e-4)
    np.testing.assert_allclose([float(got.aff_a), float(got.aff_b)],
                               [want["a"], want["b"]], rtol=0, atol=1e-3)
    assert bool(got.diverged) == want["div"]
    assert int(got.trials) == want["trials"]
    assert int(got.its) == want["its"]
    # one host check per trial and one that finds no lane active (or the
    # budget ends the loop)
    budget = lm.se3_schedule(tcfg, tcfg.max_iterations[lvl], True).max_trials
    assert got.n_syncs == min(want["trials"] + 1, budget)


# ------------------------------------------------------------ quick batch

def _moved(tangent, truth):
    return np.asarray(jlie.se3_mul(jlie.se3_exp(jnp.asarray(
        tangent, jnp.float32)), jnp.asarray(truth)), np.float32)


def quick_inits(truth):
    """Lane 0 a disturbed truth (a good track), lane 1 the truth itself
    (stops on a small step), lane 2 shifted 100 units sideways (every point
    leaves the image: diverged at once), lane 3 disturbed the other way.
    No lane starts at the identity: there every reference point warps onto
    its own pixel, so the points of rows and columns 1 and W-2 sit exactly
    on the in-image bounds and enter or leave with one ulp of rounding (a
    border point's weight of 1/16 flips between JAX and the port, and three
    trials later the poses lie 2.2e-4 apart)."""
    return np.stack([
        _moved([0.01, -0.01, 0.005, 0.004, -0.003, 0.002], truth), truth,
        _moved([100.0, 0, 0, 0, 0, 0], truth),
        _moved([-0.02, 0.015, -0.01, -0.006, 0.005, -0.003], truth)])


@pytest.fixture(scope="module")
def quick_batch(scene):
    cam, cfg = scene["cam"], scene["cfg"]
    level = QuickTracker(scene["tcam"], scene["tcfg"], SIGMA2).level
    inits = quick_inits(scene["truth"])
    pts = jax.tree_util.tree_map(lambda x: jnp.stack([x] * 4),
                                 scene["ref"].pts[level])

    def run(pts, quad, init):
        with loop_states() as seen:
            res = jquick._quick_impl(cam, cfg, SIGMA2, level, pts, quad, init)
        return res, seen[0]["trials"], seen[0]["iter"]

    res, trials, its = jax.jit(jax.vmap(run, in_axes=(0, None, 0)))(
        pts, scene["frame"].quad[level], jnp.asarray(inits))
    tpts = stack_points([scene["tref"].pts[level]] * 4)
    return level, inits, tpts, dict(
        pose=np.asarray(res.ref_to_frame), div=np.asarray(res.diverged),
        trials=np.asarray(trials), its=np.asarray(its))


def test_quick_batch_matches_jax(scene, quick_batch):
    level, inits, tpts, want = quick_batch
    got = lm.level(torch.from_numpy(inits), 1.0, 0.0, tpts,
                   scene["tframe"].quad[level], scene["tcam"].level(level),
                   scene["tcfg"], SIGMA2, lm.quick_schedule(scene["tcfg"]))
    # the lanes do what their names say
    assert want["div"].tolist() == [False, False, True, False]
    assert want["trials"][2] == 0
    # lane 1 rejects its first step and stops on it (a small step)
    assert (want["trials"][1], want["its"][1]) == (1, 0)
    np.testing.assert_allclose(got.pose.numpy(), want["pose"], rtol=0,
                               atol=2e-5)
    assert got.diverged.tolist() == want["div"].tolist()
    assert got.trials.tolist() == want["trials"].tolist()
    assert got.its.tolist() == want["its"].tolist()
    assert got.aff_a == 1.0 and got.aff_b == 0.0
    assert got.n_syncs == min(int(want["trials"].max()) + 1,
                              lm.quick_schedule(scene["tcfg"]).max_trials)


def test_quick_tracker_runs_the_level_loop(scene, quick_batch, monkeypatch):
    """The quick tracker's batched entry goes through `lm.level` with the
    quick schedule, and its pose is that loop's."""
    level, inits, tpts, want = quick_batch
    calls = []
    real = lm.level

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(lm, "level", spy)
    tq = QuickTracker(scene["tcam"], scene["tcfg"], SIGMA2)
    res = tq.track_batch_pts(tpts, scene["tframe"].quad[level], inits)
    assert calls == [lm.quick_schedule(scene["tcfg"])]
    np.testing.assert_allclose(res.ref_to_frame.numpy(), want["pose"],
                               rtol=0, atol=2e-5)
    assert res.diverged.tolist() == want["div"].tolist()


# ---------------------------------------- freezing: lanes are independent

FIELDS = ("pose", "aff_a", "aff_b", "last_err", "diverged", "trials", "its")


def _same_bits(a: lm.LevelResult, b: lm.LevelResult):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x) and x.is_floating_point():
            # bit for bit: NaN (the diverged lane's affine) included
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f
        elif torch.is_tensor(x):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


def _lane(r: lm.LevelResult, i: int) -> lm.LevelResult:
    return lm.LevelResult(*(getattr(r, f)[i:i + 1]
                            if torch.is_tensor(getattr(r, f))
                            else getattr(r, f) for f in FIELDS))


@pytest.mark.parametrize("kind", ["se3", "quick"])
def test_each_lane_equals_the_lane_alone(scene, kind):
    """Freezing makes a lane independent of the others: each lane of a
    4-lane batch, which keeps its frozen state while the batch runs on to
    the last lane's exit, gives the bits of the same lane run alone, that
    is in a batch of four copies of it, which leaves at the lane's own
    exit (copies keep the batch's shapes, so torch reduces every lane in
    the same order as in the mixed batch). So a lane run on for the whole
    trial budget equals its early exit, which the kernel relies on (its
    lanes never wait on one another)."""
    tcfg, truth = scene["tcfg"], scene["truth"]
    inits = torch.from_numpy(quick_inits(truth))
    lanes = len(inits)
    if kind == "se3":
        lvl = 3
        sched = lm.se3_schedule(tcfg, tcfg.max_iterations[lvl], True)
        aff = (torch.ones(lanes), torch.zeros(lanes))
        pts = stack_points([scene["tref"].pts[lvl]] * lanes)
    else:
        lvl = QuickTracker(scene["tcam"], tcfg, SIGMA2).level
        sched = lm.quick_schedule(tcfg)
        aff = (1.0, 0.0)
        pts = scene["tref"].pts[lvl]
    rest = (pts, scene["tframe"].quad[lvl], scene["tcam"].level(lvl), tcfg,
            SIGMA2, sched)
    batch = lm.level_plain(inits, *aff, *rest)
    assert batch.trials.max() < sched.max_trials    # the early exit ran
    assert len(set(batch.trials.tolist())) > 1      # lanes stop apart
    for i in range(lanes):
        alone = lm.level_plain(inits[i:i + 1].repeat(lanes, 1), *aff, *rest)
        if batch.trials[i] < batch.trials.max():
            assert alone.n_syncs < batch.n_syncs    # it left earlier
        _same_bits(_lane(batch, i), _lane(alone, 0))


# ------------------------------------------------------------- routing

def test_cpu_tensors_take_the_plain_version(scene, monkeypatch):
    calls = []
    monkeypatch.setattr(lm, "level_plain",
                        lambda *a, **k: calls.append(a) or "plain")

    def no_kernel(*a, **k):
        raise AssertionError("kernel wrapper reached with CPU tensors")

    monkeypatch.setattr(lm_track, "lm_level", no_kernel)
    tcfg = scene["tcfg"]
    out = lm.level(torch.zeros(7), 1.0, 0.0, scene["tref"].pts[4],
                   scene["tframe"].quad[4], scene["tcam"].level(4), tcfg,
                   SIGMA2, lm.quick_schedule(tcfg))
    assert out == "plain" and len(calls) == 1


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refuses_other_devices(scene, device):
    """The wrapper launches the kernel or raises: no tensor off the card
    is computed on, whatever its device."""
    tcfg = scene["tcfg"]
    pose = torch.zeros(1, 7, device=device)
    pts = scene["tref"].pts[4]
    with pytest.raises(ValueError, match="unsupported device"):
        lm_track.lm_level(pose, 1.0, 0.0,
                          [getattr(pts, f) for f in lm_track.POINT_FIELDS],
                          scene["tframe"].quad[4], scene["tcam"].level(4),
                          tcfg, SIGMA2,
                          dataclasses.asdict(lm.quick_schedule(tcfg)))


def test_params_round_like_the_plain_version(scene):
    """Every float constant the kernel gets is the f32 that torch uses for
    the same Python constant in the plain version's ops."""
    tcfg = scene["tcfg"]
    caml = scene["tcam"].level(2)
    prm = lm_track.make_params(
        caml, tcfg, SIGMA2,
        dataclasses.asdict(lm.se3_schedule(tcfg, 50, True)), 100, 1280, 0, 0)
    assert prm.u_hi == float(torch.tensor(caml.width - 1.001))
    assert prm.cx == float(torch.tensor(caml.cx))
    assert prm.min_points == float(torch.tensor(
        tcfg.min_goodperall_pixel_absmin * caml.width * caml.height))
    assert prm.conv_eps == float(torch.tensor(tcfg.convergence_eps))
    assert (prm.max_its, prm.max_trials, prm.quick, prm.use_affine) == (
        50, 50 + 4 * tcfg.max_lm_rejects, 0, 1)
