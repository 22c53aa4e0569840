"""Parity of the port's Sim(3) pieces with the JAX package on the CPU.

Inputs come from the JAX package (the keyframe pair of
tests/test_sim3_tracker.py: PlaneScene(seed=11), 160x128, ground-truth
depth) and are carried across by `lsd_slam_tpu_torch.interop`, so both
packages see the same arrays. Tolerances:
  * Lie ops: 2e-6 absolute (f32 rounding of the same formulas);
  * `quad_nearest` and `add_sim3_quads`: exact (pure data movement);
  * quick tracker: poses 1e-4, good/bad counts within 2 of ~1000 points
    and usage within 2.5e-3 (two points: a point on the image border
    flips when XLA folds the division by fx into a reciprocal multiply),
    the good flag equal;
  * Sim3 tracker: poses 2e-4, residuals and usage 1e-3 relative, the
    Hessian 1e-3 of its largest entry, the diverged flag equal.
The LM loops run the same accept/reject lattice in f32; the packages
differ only in reduction order (XLA's fused dots against torch matmuls),
which the loops damp rather than amplify. A lane of a batched run is
held against the same lane run alone at the same bounds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.frames import build_frame as jbuild_frame
from lsd_slam_tpu.frames import build_depth_pyramid as jbuild_depth
from lsd_slam_tpu.ops import interp as jinterp
from lsd_slam_tpu.tracking import make_tracking_ref as jmake_ref
from lsd_slam_tpu.tracking.reference import add_sim3_quads as jadd_quads
from lsd_slam_tpu.tracking.quick_tracker import QuickTracker as JQuick
from lsd_slam_tpu.tracking.sim3_tracker import (
    Sim3Tracker as JSim3, SIM3_PACK as SP)
from lsd_slam_tpu.config import TrackerConfig as JTrackerConfig
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch import interop, lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.ops import interp
from lsd_slam_tpu_torch.tracking.reference import add_sim3_quads
from lsd_slam_tpu_torch.tracking.quick_tracker import QuickTracker
from lsd_slam_tpu_torch.tracking.sim3_tracker import Sim3Tracker, stack_refs

from _torch_parity import np_, to_dict

W, H = 160, 128
LIE_ATOL = 2e-6
LEVELS = ((4, 3), (2, 2), (1, 1))


def _stack(*trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _zeros(tree):
    return jax.tree_util.tree_map(jnp.zeros_like, tree)


@pytest.fixture(scope="module")
def pair():
    """Rendered keyframes as JAX values: A, B moved by a small SE3, B with
    its depth scaled by 1.3 (a scale mismatch), and C half-way with its
    depth scaled by 1.3."""
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=11)
    pose_a = jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32)
    tangent = np.array([0.04, -0.02, 0.03, 0.008, -0.012, 0.005], np.float32)
    pose_b = jlie.se3_mul(jlie.se3_exp(jnp.asarray(tangent)), pose_a)
    pose_c = jlie.se3_mul(jlie.se3_exp(jnp.asarray(0.5 * tangent)), pose_a)
    out = {}
    for name, pose, scale in (("a", pose_a, 1.0), ("b", pose_b, 1.0),
                              ("b13", pose_b, 1.3), ("c13", pose_c, 1.3)):
        img, dep = synth.render(scene, cam, pose)
        idepth = scale / np.maximum(np.asarray(dep), 1e-6)
        pyr = jbuild_frame(jnp.asarray(img), levels=5)
        dpyr = jbuild_depth(jnp.asarray(idepth.astype(np.float32)),
                            jnp.full(idepth.shape, 0.0005, jnp.float32),
                            levels=5)
        out[name] = (pyr, dpyr, jmake_ref(pyr, dpyr))
    tcam = Camera(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W,
                  height=H)
    return cam, tcam, out, tangent


def port_ref(jref):
    return interop.tracking_ref_from_dict(to_dict(jref), device="cpu")


# ------------------------------------------------------------------ Lie ops

@pytest.fixture(scope="module")
def lie_inputs():
    rng = np.random.default_rng(5)
    tan = rng.normal(0, 0.4, (32, 7)).astype(np.float32)
    tan[:4] *= 1e-4                       # the Taylor branches
    tan2 = rng.normal(0, 0.4, (32, 7)).astype(np.float32)
    pts = rng.normal(0, 2.0, (32, 3)).astype(np.float32)
    return tan, tan2, pts


_LIE_CASES = {
    "sim3_exp": (lambda L, t, t2, p: L.sim3_exp(t)),
    "sim3_log": (lambda L, t, t2, p: L.sim3_log(L.sim3_exp(t))),
    "sim3_mul": (lambda L, t, t2, p: L.sim3_mul(L.sim3_exp(t),
                                                 L.sim3_exp(t2))),
    "sim3_inverse": (lambda L, t, t2, p: L.sim3_inverse(L.sim3_exp(t))),
    "sim3_apply": (lambda L, t, t2, p: L.sim3_apply(L.sim3_exp(t), p)),
    "sim3_adjoint": (lambda L, t, t2, p: L.sim3_adjoint(L.sim3_exp(t))),
    "se3_adjoint": (lambda L, t, t2, p: L.se3_adjoint(L.se3_exp(t[:, :6]))),
    "matrix_to_quat": (lambda L, t, t2, p: L.matrix_to_quat(
        L.quat_to_matrix(L.sim3_exp(t)[..., 0:4]))),
}


@pytest.mark.parametrize("op", sorted(_LIE_CASES))
def test_lie_op_matches_jax(lie_inputs, op):
    fn = _LIE_CASES[op]
    want = np.asarray(fn(jlie, *(jnp.asarray(a) for a in lie_inputs)))
    got = np_(fn(lie, *(torch.from_numpy(a) for a in lie_inputs)))
    if op == "matrix_to_quat":  # q and -q are one rotation
        got = got * np.sign(got[:, :1] * want[:, :1])
    np.testing.assert_allclose(got, want, atol=LIE_ATOL, rtol=0)


def test_sim3_identity_matches_jax():
    np.testing.assert_array_equal(np_(lie.sim3_identity((3,))),
                                  np.asarray(jlie.sim3_identity((3,))))


# ------------------------------------------------------- layouts and taps

def test_quad_nearest_matches_jax():
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(257, 20)).astype(np.float32)
    fu = rng.uniform(size=(257,)).astype(np.float32)
    fv = rng.uniform(size=(257,)).astype(np.float32)
    fu[:3] = 0.5   # the rounding tie stays left / up
    fv[3:6] = 0.5
    for k in (3, 4):
        want = np.asarray(jinterp.quad_nearest(jnp.asarray(raw), k, 5,
                                               jnp.asarray(fu),
                                               jnp.asarray(fv)))
        got = np_(interp.quad_nearest(torch.from_numpy(raw), k, 5,
                                      torch.from_numpy(fu),
                                      torch.from_numpy(fv)))
        np.testing.assert_array_equal(got, want)


def test_add_sim3_quads_matches_jax(pair):
    _, _, refs, _ = pair
    pyr, dpyr, _ = refs["b"]
    jbase = jmake_ref(pyr, dpyr, min_level=1, with_sim3=False)
    want = to_dict(jadd_quads(jbase, pyr, dpyr))["sim3_quad"]
    got = np_(add_sim3_quads(
        port_ref(jbase), interop.frame_pyramid_from_dict(to_dict(pyr),
                                                         device="cpu"),
        interop.depth_pyramid_from_dict(to_dict(dpyr), device="cpu")
    ).sim3_quad)
    assert want[0] is None and got[0] is None
    for lvl in range(1, 5):
        np.testing.assert_array_equal(got[lvl], want[lvl])


# ------------------------------------------------------------ quick track

def _quick_fields(res, i=None):
    """Both packages' QuickTrackResult (lane i of a batch) as host values."""
    d = np_(res)
    sel = (lambda x: x[i]) if i is not None else (lambda x: x)
    return dict(pose=sel(d["ref_to_frame"]),
                good=bool(sel(d["tracking_good"])),
                usage=float(sel(d["point_usage"])),
                gc=float(sel(d["good_count"])), bc=float(sel(d["bad_count"])))


def _assert_quick_close(got, want):
    np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-4)
    assert got["good"] == want["good"]
    assert abs(got["usage"] - want["usage"]) <= 2.5e-3
    assert abs(got["gc"] - want["gc"]) <= 2 and abs(got["bc"] - want["bc"]) \
        <= 2


@pytest.fixture(scope="module")
def quick(pair):
    cam, tcam, refs, tangent = pair
    jq = JQuick(cam, JTrackerConfig(), sigma2=16.0)
    tq = QuickTracker(tcam, TrackerConfig(), sigma2=16.0)
    assert tq.level == jq.level == 2
    lvl = jq.level
    ref_a, ref_b = refs["a"][2], refs["b"][2]
    quad_a, quad_b = refs["a"][0].quad[lvl], refs["b"][0].quad[lvl]
    # init: the true a->b motion, disturbed
    init = np.asarray(jlie.se3_exp(jnp.asarray(tangent * 0.7)), np.float32)
    ident = np.asarray(jlie.se3_identity(), np.float32)
    inits = np.stack([init, ident, ident, ident])
    return jq, tq, lvl, ref_a, ref_b, quad_a, quad_b, init, inits


def test_quick_track_single_matches_jax(quick):
    jq, tq, lvl, ref_a, _, _, quad_b, init, _ = quick
    want = jq.track_pts(ref_a.pts[lvl], quad_b, init)
    got = tq.track_pts(port_ref(ref_a).pts[lvl],
                       torch.from_numpy(np.asarray(quad_b)), init)
    assert bool(want.tracking_good)
    _assert_quick_close(_quick_fields(got), _quick_fields(want))
    np.testing.assert_allclose(
        tq.check_overlap_pts(port_ref(ref_a).pts[lvl],
                             torch.from_numpy(np.asarray(quad_b)), init),
        jq.check_overlap_pts(ref_a.pts[lvl], quad_b, init), atol=1e-5)


def test_quick_track_batch_refs_matches_jax(quick):
    """N refs against one frame, the last lane a zero (padding) point
    set: it diverges at once, and lane 0 equals its single run."""
    jq, tq, lvl, ref_a, ref_b, _, quad_b, init, inits = quick
    jpts = _stack(ref_a.pts[lvl], ref_b.pts[lvl], ref_a.pts[lvl],
                  _zeros(ref_a.pts[lvl]))
    want = jq.track_batch_pts(jpts, quad_b, inits)
    tquad = torch.from_numpy(np.asarray(quad_b))
    got = tq.track_batch_pts(
        interop.point_set_from_dict(to_dict(jpts), device="cpu"), tquad,
        inits)
    for i in range(4):
        _assert_quick_close(_quick_fields(got, i), _quick_fields(want, i))
    assert bool(np_(got.diverged)[3]) and not bool(np_(got.tracking_good)[3])
    single = tq.track_pts(port_ref(ref_a).pts[lvl], tquad, init)
    _assert_quick_close(_quick_fields(got, 0), _quick_fields(single))


def test_quick_track_batch_frames_matches_jax(quick):
    """One ref against N frame layouts, the last a zero (padding) layout."""
    jq, tq, lvl, ref_a, _, quad_a, quad_b, init, inits = quick
    jquads = jnp.stack([quad_b, quad_a, quad_b, jnp.zeros_like(quad_b)])
    want = jq.track_batch_frames(ref_a.pts[lvl], jquads, inits)
    got = tq.track_batch_frames(port_ref(ref_a).pts[lvl],
                                torch.from_numpy(np.asarray(jquads)), inits)
    for i in range(4):
        _assert_quick_close(_quick_fields(got, i), _quick_fields(want, i))
    assert not bool(np_(got.tracking_good)[3])


# ------------------------------------------------------------- Sim3 track

def _assert_pack_close(got, want):
    np.testing.assert_allclose(got[SP["ref_to_frame"]],
                               want[SP["ref_to_frame"]], atol=2e-4)
    np.testing.assert_allclose(got[SP["frame_to_ref"]],
                               want[SP["frame_to_ref"]], atol=2e-4)
    assert got[SP["diverged"]] == want[SP["diverged"]]
    for k in ("last_residual", "depth_residual", "photo_residual",
              "point_usage"):
        np.testing.assert_allclose(got[SP[k]], want[SP[k]], rtol=1e-3,
                                   atol=1e-7, err_msg=k)
    hw, hg = want[SP["hessian"]], got[SP["hessian"]]
    np.testing.assert_allclose(hg, hw, atol=1e-3 * np.abs(hw).max())


def _pack_single(r):
    """A single Sim3TrackResult of either package in the SIM3_PACK layout."""
    d = np_(r)
    return np.concatenate([np.atleast_1d(np.asarray(d[k], np.float64))
                           .reshape(-1) for k in (
        "ref_to_frame", "frame_to_ref", "diverged", "last_residual",
        "depth_residual", "photo_residual", "point_usage", "hessian")])


@pytest.fixture(scope="module")
def sim3(pair):
    cam, tcam, refs, _ = pair
    return (JSim3(cam, JTrackerConfig(), sigma2=16.0),
            Sim3Tracker(tcam, TrackerConfig(), sigma2=16.0), refs)


@pytest.mark.parametrize("levels", LEVELS)
def test_sim3_track_single_matches_jax(sim3, levels):
    js, ts, refs = sim3
    ref_a, ref_b = refs["a"][2], refs["b13"][2]
    init = np.asarray(jlie.sim3_identity(), np.float32)
    want = _pack_single(js.track(ref_a, ref_b, init, *levels))
    got = _pack_single(ts.track(port_ref(ref_a), port_ref(ref_b), init,
                                *levels))
    assert want[SP["diverged"]] == 0
    _assert_pack_close(got, want)


@pytest.fixture(scope="module")
def chain(sim3):
    """The constraint pipeline's coarse-to-fine chain on [a, c13, a, zero]
    in both directions, run by JAX: each level range starts from the
    previous range's result (identity at (4, 3)), as in
    `test_constraints_batch`. Returns {levels: (inits_refs, want_refs,
    inits_frames, want_frames)}. (A pair whose images are identical has a
    zero photometric residual at the solution and its LM stops on f32
    noise; no lane is such a pair.)"""
    js, _, refs = sim3
    jstack = _stack(refs["a"][2], refs["c13"][2], refs["a"][2],
                    _zeros(refs["a"][2]))
    ref_b = refs["b"][2]
    ident = np.asarray(jlie.sim3_identity(), np.float32)
    i_refs = i_frames = np.stack([ident] * 4)
    out = {}
    for levels in LEVELS:
        w_refs = np.asarray(js.track_batch_packed(jstack, ref_b, i_refs,
                                                  *levels))
        w_frames = np.asarray(js.track_batch_frames_packed(
            ref_b, jstack, i_frames, *levels))
        out[levels] = (i_refs, w_refs, i_frames, w_frames)
        i_refs = w_refs[:, SP["frame_to_ref"]].astype(np.float32)
        i_frames = w_frames[:, SP["frame_to_ref"]].astype(np.float32)
    return jstack, out


@pytest.mark.parametrize("levels", LEVELS)
def test_sim3_batch_packs_match_jax(sim3, chain, levels):
    """Both packed batch directions: every lane against JAX, lane 0
    against its single run, the zero lane diverged."""
    _, ts, refs = sim3
    jstack, runs = chain
    i_refs, w_refs, i_frames, w_frames = runs[levels]
    tstack = port_ref(jstack)
    tref_b = port_ref(refs["b"][2])
    got, _ = ts.track_batch_packed(tstack, tref_b, i_refs, *levels)
    got = np_(got).astype(np.float64)
    assert got.shape == (4, 70)
    for i in range(4):
        _assert_pack_close(got[i], w_refs[i])
    assert got[3, SP["diverged"]] == 1
    single = _pack_single(ts.track(port_ref(refs["a"][2]), tref_b,
                                   i_refs[0], *levels))
    _assert_pack_close(got[0], single)
    got, _ = ts.track_batch_frames_packed(tref_b, tstack, i_frames, *levels)
    got = np_(got).astype(np.float64)
    for i in range(3):
        _assert_pack_close(got[i], w_frames[i])
    assert got[3, SP["diverged"]] == w_frames[3, SP["diverged"]]


def test_stack_refs_matches_jax_stack(pair):
    _, _, refs, _ = pair
    jstack = _stack(refs["a"][2], refs["b"][2])
    want = port_ref(jstack)
    got = stack_refs([port_ref(refs["a"][2]), port_ref(refs["b"][2])],
                     (2, 3))
    assert got.pts[1] is None and got.sim3_quad[4] is None
    for lvl in (2, 3):
        torch.testing.assert_close(got.sim3_quad[lvl], want.sim3_quad[lvl],
                                   rtol=0, atol=0)
        for f in ("idx", "idp", "valid", "n_valid"):
            torch.testing.assert_close(getattr(got.pts[lvl], f),
                                       getattr(want.pts[lvl], f),
                                       rtol=0, atol=0)
