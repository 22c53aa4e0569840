"""The port's regularize stencil and depth sweeps against the JAX package.

The plain torch stencil must equal the JAX XLA lattice and the Pallas
kernel (interpret mode) at the stencil's own bar, rtol = atol = 1e-6 with
exact counts (tests/test_pallas_stencil.py:36-38). regularize, fill_holes
and propagate run on one shared state in both packages.

The JAX side runs under jax.jit, as the JAX engine runs it: XLA then
rewrites `x * mask.astype(f32)` into `select(mask, x, 0)`, so a masked-out
term that is inf or NaN (var == 0 at invalid pixels) adds 0. Run op by op
the same JAX code would poison those sums with NaN.
"""

import dataclasses

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.depth import regularize as jreg
from lsd_slam_tpu.depth.state import DepthMapState as JaxState
from lsd_slam_tpu.ops.pallas_stencil import regularize_accumulators as pallas
from lsd_slam_tpu.utils import synth as jsynth

from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.depth import regularize as treg
from lsd_slam_tpu_torch.interop import depth_state_from_dict
from lsd_slam_tpu_torch.ops import regularize_stencil as stencil

from _torch_parity import to_dict, np_
from test_torch_fill_holes import PLANES as FILL_PLANES
from test_torch_fill_holes import assert_same_bits, fill_state, plane_args

NAMES = ("sum_id", "sum_ivar", "val_sum", "n_occ", "n_not_occ")


def _random_planes(rng, h, w):
    idepth = rng.uniform(0.2, 2.0, (h, w)).astype(np.float32)
    var = rng.uniform(0.001, 0.3, (h, w)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) < 0.6
    validity = rng.uniform(0, 50, (h, w)).astype(np.float32)
    idepth = np.where(valid, idepth, 0.0).astype(np.float32)
    return idepth, var, valid, validity


def _assert_accumulators(ref, out):
    for name, a, b in zip(NAMES, ref, out):
        a, b = np.asarray(a), np_(b)
        if name.startswith("n_"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("h,w,reg_dist_var,diff_fac", [
    pytest.param(48, 64, 0.075, 1.0, id="48-64-0.075"),
    pytest.param(40, 52, 0.01, 1.0, id="40-52-0.01"),
    pytest.param(40, 52, 0.005625, 2.0, id="40-52-0.005625-diff_fac2")])
def test_plain_stencil_matches_xla_and_pallas(h, w, reg_dist_var, diff_fac):
    rng = np.random.default_rng(h)
    idepth, var, valid, validity = _random_planes(rng, h, w)
    # real states carry var 0 at invalid pixels: the centre tap's ivar is
    # then inf and must be masked out, not turned into NaN
    var[~valid & (rng.uniform(size=(h, w)) < 0.5)] = 0.0
    xla = jax.jit(jreg._regularize_accumulators_xla,
                  static_argnums=(4, 5))(
        jnp.asarray(idepth), jnp.asarray(var), jnp.asarray(valid),
        jnp.asarray(validity), reg_dist_var, diff_fac)
    pal = pallas(jnp.asarray(idepth), jnp.asarray(var),
                 jnp.asarray(valid).astype(jnp.float32),
                 jnp.asarray(validity), reg_dist_var, diff_fac,
                 interpret=True)
    ins = [torch.from_numpy(a) for a in
           (idepth, var, valid.astype(np.float32), validity)]
    out = stencil.regularize_accumulators_plain(*ins, reg_dist_var, diff_fac)
    assert all(np.isfinite(np_(o)).all() for o in out)
    _assert_accumulators(xla, out)
    _assert_accumulators(pal, out)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    planes = _random_planes(rng, 37, 53)
    ins = [torch.from_numpy(np.asarray(a, np.float32)) for a in planes]
    before = stencil.LAUNCHES
    got = stencil.regularize_accumulators(*ins, 0.005625, 1.0)
    want = stencil.regularize_accumulators_plain(*ins, 0.005625, 1.0)
    assert stencil.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_distance_constants_round_like_jax():
    rdv = 0.075 * 0.075
    d = stencil.dist_constants(rdv)
    want = [np.asarray(jnp.float32(float(k) * rdv)) for k in (0, 1, 2, 4, 5, 8)]
    np.testing.assert_array_equal(d, np.asarray(want, np.float32))


# --------------------------------------------------------------- sweeps

H, W = 48, 64


@pytest.fixture(scope="module")
def shared_state():
    """A depth state, keyframe images and a small motion, as numpy."""
    rng = np.random.default_rng(11)
    cam = jsynth.default_camera(W, H)
    scene = jsynth.PlaneScene(seed=3)
    pose0 = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    pose1 = np.array([1, 0, 0, 0, 0.01, -0.004, 0.006], np.float32)
    img0, dep0 = (np.asarray(a) for a in jsynth.render(scene, cam,
                                                       jnp.asarray(pose0)))
    img1, _ = (np.asarray(a) for a in jsynth.render(scene, cam,
                                                    jnp.asarray(pose1)))
    valid = (rng.uniform(size=(H, W)) < 0.55) & (dep0 > 0)
    idepth = np.where(valid, 1.0 / np.maximum(dep0, 1e-6)
                      * rng.uniform(0.97, 1.03, (H, W)), 0.0)
    var = np.where(valid, rng.uniform(1e-4, 2e-2, (H, W)), 0.0)
    state = dict(
        valid=valid,
        idepth=idepth.astype(np.float32),
        var=var.astype(np.float32),
        idepth_smoothed=np.where(valid, idepth, -1.0).astype(np.float32),
        var_smoothed=np.where(valid, var, -1.0).astype(np.float32),
        validity=np.where(valid, rng.integers(0, 60, (H, W)),
                          0).astype(np.float32),
        blacklisted=rng.integers(-3, 1, (H, W)).astype(np.int32),
        next_min_id=np.zeros((H, W), np.float32))
    max_grad = rng.uniform(0.0, 20.0, (H, W)).astype(np.float32)
    good = rng.uniform(size=(H, W)) < 0.9
    # old keyframe -> new keyframe: the inverse of pose1 relative to pose0
    old_to_new = pose1
    return cam, state, img0, img1, max_grad, good, old_to_new


def _jax_state(d):
    return JaxState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_states(jstate, tstate, rtol=1e-6, atol=1e-6):
    a, b = to_dict(jstate), np_(tstate)
    for k in a:
        if a[k].dtype == bool or k == "blacklisted":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("remove_occlusions", [False, True])
def test_regularize_plain_matches_jax(shared_state, remove_occlusions):
    """The fused entry's plain version against the jitted JAX regularize on
    the shared state, which holds var = 0 at its invalid pixels. The
    validity threshold is raised so that the deletions, the keeps and the
    occlusion test all occur."""
    _, state, *_ = shared_state
    assert (state["var"][~state["valid"]] == 0).all()
    dcfg = JaxConfig().depth
    th = 10.0 * dcfg.val_sum_min_for_keep
    want = jax.jit(jreg.regularize, static_argnums=(1, 2, 3))(
        _jax_state(state), remove_occlusions, th, dcfg)
    t = depth_state_from_dict(state, device="cpu")
    tcfg = LSDConfig().depth
    got = stencil.regularize_plain(
        t.idepth, t.var, t.valid, t.validity, t.idepth_smoothed,
        t.var_smoothed, t.blacklisted, float(tcfg.reg_dist_var_base),
        float(tcfg.diff_fac_smoothing), th, remove_occlusions)
    names = ("valid", "blacklisted", "idepth_smoothed", "var_smoothed")
    want = to_dict(want)
    for name, b in zip(names, got):
        a, b = want[name], np_(b)
        if name in ("valid", "blacklisted"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    # hypotheses are both deleted and kept (smoothed)
    deleted = state["valid"] & ~np_(got[0])
    kept = np_(got[2]) != state["idepth_smoothed"]
    assert deleted.sum() > 10 and kept.sum() > 10, (deleted.sum(), kept.sum())


def test_fused_wrapper_takes_plain_version_on_cpu(shared_state):
    _, state, *_ = shared_state
    t = depth_state_from_dict(state, device="cpu")
    args = (t.idepth, t.var, t.valid, t.validity, t.idepth_smoothed,
            t.var_smoothed, t.blacklisted, 0.005625, 1.0, 24.0, True)
    before = stencil.FUSED_LAUNCHES
    got = stencil.regularize_fused(*args)
    want = stencil.regularize_plain(*args)
    assert stencil.FUSED_LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fused_wrapper_raises_off_cpu_and_cuda():
    f32 = [torch.empty(8, 8, device="meta") for _ in range(5)]
    valid = torch.empty(8, 8, dtype=torch.bool, device="meta")
    bl = torch.empty(8, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        stencil.regularize_fused(f32[0], f32[1], valid, f32[2], f32[3],
                                 f32[4], bl, 0.005625, 1.0, 24.0, False)


@pytest.mark.parametrize("remove_occlusions", [False, True])
def test_regularize_matches_jax(shared_state, remove_occlusions):
    cam, state, *_ = shared_state
    dcfg = JaxConfig().depth
    want = jax.jit(jreg.regularize, static_argnums=(1, 2, 3))(
        _jax_state(state), remove_occlusions, dcfg.val_sum_min_for_keep, dcfg)
    got = treg.regularize(depth_state_from_dict(state, device="cpu"),
                          remove_occlusions,
                          dcfg.val_sum_min_for_keep, LSDConfig().depth)
    _assert_states(want, got)


def test_fill_holes_matches_jax(shared_state):
    cam, state, _, _, max_grad, _, _ = shared_state
    dcfg = JaxConfig().depth
    want = jax.jit(jreg.fill_holes, static_argnums=(2, 3))(
        _jax_state(state), jnp.asarray(max_grad), dcfg, 5.0)
    got = treg.fill_holes(depth_state_from_dict(state, device="cpu"),
                          torch.from_numpy(max_grad), LSDConfig().depth, 5.0)
    assert int(np.asarray(want.valid).sum()) > int(state["valid"].sum())
    _assert_states(want, got)


FILL_CASES = [((48, 64), "shared"), ((37, 53), "rounded"),
              ((128, 160), "exact"), ((128, 160), "rounded")]


@pytest.mark.parametrize("shape,case", FILL_CASES,
                         ids=[f"{h}x{w}-{c}" for (h, w), c in FILL_CASES])
def test_fill_holes_wrapper_takes_plain_version_on_cpu(shared_state, shape,
                                                       case):
    """On CPU tensors the hole fill's wrapper is its plain version, bit for
    bit, and launches nothing; the state-level `fill_holes` (held to JAX
    by test_fill_holes_matches_jax) goes through it."""
    if case == "shared":
        _, state, _, _, max_grad, _, _ = shared_state
        t = depth_state_from_dict(state, device="cpu")
        max_grad = torch.from_numpy(max_grad)
    else:
        t, max_grad = fill_state(*shape, case, seed=shape[0])
    args = plane_args(t, max_grad)
    before = stencil.FILL_HOLES_LAUNCHES
    got = stencil.fill_holes(*args)
    want = stencil.fill_holes_plain(*args)
    assert stencil.FILL_HOLES_LAUNCHES == before
    assert_same_bits(got, want)
    out = treg.fill_holes(t, max_grad, LSDConfig().depth, plane_args(
        t, max_grad)[8])
    assert_same_bits([getattr(out, k) for k in FILL_PLANES], want)
    assert out.blacklisted is t.blacklisted
    assert int((got[0] & ~t.valid).sum()) > 0


@pytest.mark.parametrize("meta_planes", ["all", "idepth"])
def test_fill_holes_wrapper_raises_off_cpu_and_cuda(meta_planes):
    """Tensors on another device than the CPU or a card raise instead of
    computing anything or launching."""
    t, max_grad = fill_state(8, 8)
    args = list(plane_args(t, max_grad))
    for i, a in enumerate(args):
        if torch.is_tensor(a) and (meta_planes == "all" or i == 1):
            args[i] = torch.empty_like(a, device="meta")
    before = stencil.FILL_HOLES_LAUNCHES
    with pytest.raises(ValueError):
        stencil.fill_holes(*args)
    assert stencil.FILL_HOLES_LAUNCHES == before


@pytest.mark.parametrize("have_good_mask", [True, False])
def test_propagate_matches_jax(shared_state, have_good_mask):
    """Pass 2 of propagate is a float scatter-add. On the CPU both packages
    add in index order, so the states agree to rtol = atol = 1e-6 here; the
    port's card route (ops/scatter.py) adds in the same order."""
    cam, state, img0, img1, max_grad, good, old_to_new = shared_state
    jcfg = JaxConfig()
    tcfg = LSDConfig()
    prop = jax.jit(functools.partial(
        jreg.propagate, have_good_mask=have_good_mask, cam=cam,
        dcfg=jcfg.depth, mcfg=jcfg.mapping))
    want = prop(_jax_state(state), jnp.asarray(old_to_new),
                jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(max_grad),
                jnp.asarray(good))
    got = treg.propagate(depth_state_from_dict(state, device="cpu"),
                         torch.from_numpy(old_to_new), torch.from_numpy(img0),
                         torch.from_numpy(img1), torch.from_numpy(max_grad),
                         torch.from_numpy(good), have_good_mask,
                         Camera(**dataclasses.asdict(cam)), tcfg.depth,
                         tcfg.mapping)
    assert int(np.asarray(want.valid).sum()) > 100
    _assert_states(want, got)
