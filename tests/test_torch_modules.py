"""Module-level parity of the port against the JAX package: config, camera,
Lie groups, interpolation (clamps included), pyramids, compaction and the
tracking reference. Inputs come from a numpy seed; both packages see the
same arrays. JAX functions run under jax.jit, as the JAX engine runs them.

Tolerances: elementwise f32 math is compared at rtol = 1e-6 (a few ulps:
the two compilers may order a product chain differently); image-valued
outputs in [0, 255] at atol = 1e-4 (~6 ulps at 255); compaction, masks and
slot orders exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.camera import Camera as JaxCamera
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.depth import observe as jobs
from lsd_slam_tpu.frames import build_frame as jbuild_frame
from lsd_slam_tpu.frames import build_depth_pyramid as jbuild_depth
from lsd_slam_tpu.lie import np_sim3 as jnps
from lsd_slam_tpu.ops import interp as jinterp
from lsd_slam_tpu.tracking import reference as jref
from lsd_slam_tpu.utils import synth as jsynth

from lsd_slam_tpu_torch import lie as tlie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.frames import build_frame, build_depth_pyramid
from lsd_slam_tpu_torch.interop import (
    config_from_dict, frame_pyramid_from_dict, depth_pyramid_from_dict)
from lsd_slam_tpu_torch.lie import np_sim3 as tnps
from lsd_slam_tpu_torch.ops import interp as tinterp
from lsd_slam_tpu_torch.tracking import reference as tref
from lsd_slam_tpu_torch.utils import synth as tsynth

from _torch_parity import to_dict, np_

H, W = 64, 80


def test_config_trees_are_equal():
    assert dataclasses.asdict(LSDConfig()) == dataclasses.asdict(JaxConfig())
    cfg = config_from_dict(dataclasses.asdict(JaxConfig(width=160,
                                                        height=128)))
    assert cfg == LSDConfig(width=160, height=128)


def test_camera_levels_match():
    jc = jsynth.default_camera(640, 480)
    tc = tsynth.default_camera(640, 480)
    for lvl in range(5):
        assert dataclasses.asdict(jc.level(lvl)) == \
            dataclasses.asdict(tc.level(lvl))
    assert np.array_equal(JaxCamera(**dataclasses.asdict(jc)).K(), tc.K())


@pytest.fixture(scope="module")
def tangents():
    rng = np.random.default_rng(0)
    t = rng.normal(scale=0.3, size=(64, 6)).astype(np.float32)
    t[:8, 3:] *= 1e-4  # small-angle Taylor branch
    return t


@pytest.mark.parametrize("fn", ["se3_exp", "quat_to_matrix", "se3_inverse",
                                "se3_mul", "se3_log"])
def test_lie_matches_jax(tangents, fn):
    """f32 group ops; 1e-6 absolute on unit-scale quantities."""
    g = np.array(jlie.se3_exp(jnp.asarray(tangents)))
    g2 = np.roll(g, 1, axis=0)
    tg = torch.from_numpy(g)
    if fn == "se3_exp":
        a = g
        b = tlie.se3_exp(torch.from_numpy(tangents))
    elif fn == "quat_to_matrix":
        a = jlie.quat_to_matrix(jnp.asarray(g[:, :4]))
        b = tlie.quat_to_matrix(tg[:, :4])
    elif fn == "se3_inverse":
        a = jlie.se3_inverse(jnp.asarray(g))
        b = tlie.se3_inverse(tg)
    elif fn == "se3_mul":
        a = jlie.se3_mul(jnp.asarray(g), jnp.asarray(g2))
        b = tlie.se3_mul(tg, torch.from_numpy(g2))
    else:
        a = jlie.se3_log(jnp.asarray(g))
        b = tlie.se3_log(tg)
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=0, atol=2e-6)


def test_np_sim3_copy_is_identical():
    rng = np.random.default_rng(1)
    t = rng.normal(scale=0.2, size=(5, 7))
    a = jnps.sim3_exp(t)
    assert np.array_equal(tnps.sim3_exp(t), a)
    assert np.array_equal(tnps.sim3_mul(a, a[::-1]),
                          jnps.sim3_mul(a, a[::-1]))
    assert np.array_equal(tnps.sim3_inverse(a), jnps.sim3_inverse(a))
    assert np.array_equal(tnps.se3_log(a[:, :7]), jnps.se3_log(a[:, :7]))


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(2)
    return (rng.uniform(0, 255, (H, W))).astype(np.float32)


def _coords(rng, n, h, w):
    u = rng.uniform(-3, w + 3, n).astype(np.float32)
    v = rng.uniform(-3, h + 3, n).astype(np.float32)
    u[:3] = [np.nan, 0.0, w - 1.0]   # NaN and the exact clamp edges
    v[:3] = [1.0, np.nan, h - 1.0]
    return u, v


def test_bilinear_and_quad_sample_match(image):
    rng = np.random.default_rng(3)
    u, v = _coords(rng, 500, H, W)
    a = np.asarray(jax.jit(jinterp.bilinear)(
        jnp.asarray(image), jnp.asarray(u), jnp.asarray(v)))
    b = np_(tinterp.bilinear(torch.from_numpy(image), torch.from_numpy(u),
                             torch.from_numpy(v)))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    chans = [image, 0.5 * image, image[::-1].copy()]
    jq = jinterp.quad_pack([jnp.asarray(c) for c in chans])
    tq = tinterp.quad_pack([torch.from_numpy(c) for c in chans])
    np.testing.assert_array_equal(np_(tq), np.asarray(jq))
    ja = jax.jit(lambda q, u, v: jinterp.quad_sample(q, H, W, u, v)[0])(
        jq, jnp.asarray(u), jnp.asarray(v))
    ta, _, _ = tinterp.quad_sample(tq, H, W, torch.from_numpy(u),
                                   torch.from_numpy(v))
    for x, y in zip(ja, ta):
        np.testing.assert_allclose(np_(y), np.asarray(x), rtol=0, atol=1e-4)


def test_patch16_sample_matches(image):
    rng = np.random.default_rng(4)
    n = 300
    base_u, base_v = _coords(rng, n, H, W)
    step = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    us = base_u[:, None] + step[:, :1] * np.arange(3, dtype=np.float32)
    vs = base_v[:, None] + step[:, 1:] * np.arange(3, dtype=np.float32)
    jp = jinterp.patch16_pack(jnp.asarray(image))
    tp = tinterp.patch16_pack(torch.from_numpy(image))
    np.testing.assert_array_equal(np_(tp), np.asarray(jp))
    a = np.asarray(jax.jit(
        lambda p, us, vs: jinterp.patch16_sample(p, H, W, us, vs))(
            jp, jnp.asarray(us), jnp.asarray(vs)))
    b = np_(tinterp.patch16_sample(tp, H, W, torch.from_numpy(us),
                                   torch.from_numpy(vs)))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def rendered():
    cam = jsynth.default_camera(160, 128)
    img, dep = jsynth.render(jsynth.PlaneScene(seed=5), cam,
                             jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32))
    return np.asarray(img), np.asarray(dep)


def test_synth_render_matches(rendered):
    """The port's renderer: f32 sin of phases up to ~100 rad, so a few
    1e-4 gray levels apart from XLA's sin; depths to 1e-5."""
    img, dep = rendered
    poses = tsynth.orbit_trajectory(6, radius=0.06, fwd=0.01)
    np.testing.assert_allclose(
        poses, jsynth.orbit_trajectory(6, radius=0.06, fwd=0.01), atol=1e-6)
    ti, td = tsynth.render(tsynth.PlaneScene(seed=5),
                           tsynth.default_camera(160, 128),
                           np.array([1, 0, 0, 0, 0, 0, 0], np.float32))
    np.testing.assert_allclose(np_(ti), img, rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_(td), dep, rtol=1e-5, atol=1e-5)


def test_frame_pyramid_matches(rendered):
    img, _ = rendered
    jp = to_dict(jbuild_frame(jnp.asarray(img), 5))
    tp = np_(build_frame(torch.from_numpy(img.copy()), 5))
    for key in ("images", "gx", "gy", "max_grad", "quad"):
        for lvl, (a, b) in enumerate(zip(jp[key], tp[key])):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4,
                                       err_msg=f"{key}[{lvl}]")
    assert float(tp["num_mappable"]) == float(jp["num_mappable"])
    # interop.py carries the JAX pyramid over unchanged
    cp = np_(frame_pyramid_from_dict(jp))
    np.testing.assert_array_equal(cp["quad"][2], jp["quad"][2])


def test_depth_pyramid_matches(rendered):
    _, dep = rendered
    rng = np.random.default_rng(6)
    keep = rng.uniform(size=dep.shape) < 0.5
    idepth = np.where(keep, 1.0 / np.maximum(dep, 1e-6), -1.0).astype(
        np.float32)
    ivar = np.where(keep, rng.uniform(1e-4, 1e-2, dep.shape), -1.0).astype(
        np.float32)
    jd = to_dict(jbuild_depth(jnp.asarray(idepth), jnp.asarray(ivar), 5))
    td = np_(build_depth_pyramid(torch.from_numpy(idepth),
                                 torch.from_numpy(ivar), 5))
    for key in ("idepth", "ivar"):
        for a, b in zip(jd[key], td[key]):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    cd = np_(depth_pyramid_from_dict(jd))
    np.testing.assert_array_equal(cd["ivar"][3], jd["ivar"][3])


@pytest.mark.parametrize("h,w,budget", [(48, 64, 768), (48, 64, 3072),
                                        (30, 40, 1200)])
def test_compact_points_slot_order(h, w, budget):
    rng = np.random.default_rng(h + budget)
    valid = rng.uniform(size=(h, w)) < 0.4
    fields = rng.normal(size=(h * w, 5)).astype(np.float32)
    a = [np.asarray(x) for x in jax.jit(
        jref.compact_points, static_argnums=2)(
            jnp.asarray(valid), jnp.asarray(fields), budget)]
    b = [np_(x) for x in tref.compact_points(
        torch.from_numpy(valid), torch.from_numpy(fields), budget)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    assert tref.level_budget(480, 640, 1) == jref.level_budget(480, 640, 1)
    assert np.array_equal(tref._golden_perm(1200), jref._golden_perm(1200))


@pytest.mark.parametrize("frame_id,budget", [(3.0, 512), (17.0, 4096),
                                             (123.0, 600)])
def test_observe_compaction_matches_nonzero(frame_id, budget):
    """The cumsum + scatter compaction replaces jnp.nonzero(size=budget) on
    a frame-rolled mask: same slots, same truncation."""
    rng = np.random.default_rng(int(frame_id))
    n_pix = 48 * 64
    process = rng.uniform(size=(48, 64)) < 0.3

    @jax.jit
    def jax_compact(process, ref_frame_id):
        shift = jnp.mod((ref_frame_id * 37831.0), n_pix).astype(jnp.int32)
        rolled = jnp.roll(process.reshape(-1), shift)
        idx_r = jnp.nonzero(rolled, size=budget, fill_value=-1)[0]
        valid_k = idx_r >= 0
        return (jnp.where(valid_k, jnp.mod(idx_r - shift, n_pix), 0),
                valid_k, shift)

    fi, vk, shift = (np.asarray(x) for x in jax_compact(
        jnp.asarray(process), jnp.float32(frame_id)))
    assert tobs.frame_shift(frame_id, n_pix) == int(shift)
    tfi, tvk = tobs.compact_active(torch.from_numpy(process),
                                   tobs.frame_shift(frame_id, n_pix), budget)
    np.testing.assert_array_equal(np_(tfi), fi)
    np.testing.assert_array_equal(np_(tvk), vk)


def test_make_tracking_ref_matches(rendered):
    img, dep = rendered
    rng = np.random.default_rng(7)
    keep = (rng.uniform(size=dep.shape) < 0.6) & (dep > 0)
    idepth = np.where(keep, 1.0 / np.maximum(dep, 1e-6), -1.0).astype(
        np.float32)
    ivar = np.where(keep, 1e-3, -1.0).astype(np.float32)
    jr = to_dict(jref.make_tracking_ref(
        jbuild_frame(jnp.asarray(img), 5),
        jbuild_depth(jnp.asarray(idepth), jnp.asarray(ivar), 5),
        min_level=1, with_sim3=False))
    tr = np_(tref.make_tracking_ref(
        build_frame(torch.from_numpy(img), 5),
        build_depth_pyramid(torch.from_numpy(idepth), torch.from_numpy(ivar),
                            5), min_level=1))
    assert jr["pts"][0] is None and tr["pts"][0] is None
    for lvl in range(1, 5):
        a, b = jr["pts"][lvl], tr["pts"][lvl]
        for key in ("idx", "valid", "n_valid"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        for key in ("ival", "gx", "gy", "idp", "ivr"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-6, atol=1e-4,
                                       err_msg=key)
