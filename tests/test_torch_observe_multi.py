"""The multi-reference observe sweep of the port against the JAX package.

A queue of tracked frames maps in one sweep over a (K, H, W) stack, each
pixel stereo-matching against the frame its nextStereoFrameMinID selects
(lsd_slam_tpu/depth/observe.py `observe_multi`, DepthMap.cpp:302-319).
Setup as tests/test_observe_multi.py: PlaneScene(seed=0) at 160x128, the
keyframe at the origin with its ground-truth depth (JAX `init_gt`, carried
across with lsd_slam_tpu_torch.interop), tracked frames rendered by the
JAX synth along a short push-in, and next_min_id drawn per pixel from a
seed so that pixels pick different frames.

Bound, against the JAX package and between the port's own sweeps: the
JAX package's multi-ref bound (tests/test_observe_multi.py:75-85): every
state field within 1e-5; the next_min_id field, whose parity dither
(mod(epl_len * 1e4, 2)) is last-ulp sensitive, differs on at most
max(16, 1%) of the pixels, each by at most a dither step (measured: 1 and
38 of 20,480 pixels, by 3; every other field within 9e-8). Stats counts
within 0.2% of the eligible pixels (tests/test_torch_observe.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.config import LSDConfig as JaxConfig
from lsd_slam_tpu.depth import observe as jobs
from lsd_slam_tpu.depth.depth_map import DepthMap as JaxDepthMap
from lsd_slam_tpu.frames import build_frame as jbuild_frame
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch import lie as tlie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.depth.depth_map import DepthMap, MULTI_REF_BUCKETS
from lsd_slam_tpu_torch.interop import (depth_state_from_dict,
                                        frame_pyramid_from_dict)

from _torch_parity import np_, to_dict

W, H = 160, 128
B = 4096
K_ALL = 10  # two chunks of the 8-frame bucket
FIELDS = ("valid", "idepth", "var", "validity", "blacklisted",
          "idepth_smoothed", "var_smoothed")


def _twist(k):
    return jnp.asarray([0.006, -0.003, 0.0045, 0.001, -0.0015, 0.0006],
                       jnp.float32) * k


@pytest.fixture(scope="module")
def setup():
    cam = synth.default_camera(W, H)
    jcfg = JaxConfig(width=W, height=H)
    scene = synth.PlaneScene(seed=0)
    img_a, dep_a = synth.render(scene, cam, jnp.asarray(
        [1, 0, 0, 0, 0, 0, 0], jnp.float32))
    pyr = jbuild_frame(img_a, 5)
    dm = JaxDepthMap(cam, jcfg)
    dm.initialize_from_gt(1.0 / jnp.maximum(dep_a, 1e-6), pyr.max_grad[0])
    rng = np.random.default_rng(0)
    # per-pixel frame gate: ids run 5..14, so pixels pick every frame and
    # some none (next_min_id above the newest id)
    nmi = rng.integers(0, 17, (H, W)).astype(np.float32)
    state = dm.state.replace(next_min_id=jnp.asarray(nmi))
    imgs, r2ks = [], []
    for k in range(1, K_ALL + 1):
        pose = jlie.se3_exp(_twist(k))
        img, _ = synth.render(scene, cam, pose)
        imgs.append(np.asarray(img))
        r2ks.append(np.asarray(jlie.se3_inverse(pose), np.float64))
    ids = [float(5 + k) for k in range(K_ALL)]
    gms = [rng.uniform(size=(H // 2, W // 2)) < 0.9 for _ in range(K_ALL)]
    residuals = [float(x) for x in rng.uniform(0.5, 2.0, K_ALL)]

    tcam = Camera(**dataclasses.asdict(cam))
    tcfg = LSDConfig(width=W, height=H)
    return dict(cam=cam, jcfg=jcfg, pyr=pyr, state=state, imgs=imgs,
                r2ks=r2ks, ids=ids, gms=gms, residuals=residuals, tcam=tcam,
                tcfg=tcfg,
                tpyr=frame_pyramid_from_dict(to_dict(pyr), device="cpu"),
                tstate=depth_state_from_dict(to_dict(state), device="cpu"))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _jax_multi(s, ks, point_budget=B):
    cfg = s["jcfg"]
    fn = jax.jit(lambda st, stack, r2k, ids, gm, tr: jobs.observe_multi(
        st, s["pyr"].images[0], s["pyr"].gx[0], s["pyr"].gy[0],
        s["pyr"].max_grad[0], stack, r2k, ids, gm, tr, jnp.float32(3.0),
        s["cam"], cfg.depth, cfg.mapping, point_budget=point_budget))
    full = [np.repeat(np.repeat(s["gms"][k], 2, 0), 2, 1) for k in ks]
    return fn(s["state"], jnp.stack([s["imgs"][k] for k in ks]),
              jnp.asarray(np.stack([s["r2ks"][k] for k in ks]), jnp.float32),
              jnp.asarray([s["ids"][k] for k in ks], jnp.float32),
              jnp.asarray(np.stack(full)),
              jnp.asarray([s["residuals"][k] for k in ks], jnp.float32))


def _port_multi(s, ks, state=None, ids=None):
    cfg = s["tcfg"]
    p = s["tpyr"]
    full = [np.repeat(np.repeat(s["gms"][k], 2, 0), 2, 1) for k in ks]
    return tobs.observe_multi(
        s["tstate"] if state is None else state, p.images[0], p.gx[0],
        p.gy[0], p.max_grad[0], _t(np.stack([s["imgs"][k] for k in ks])),
        _t(np.stack([s["r2ks"][k] for k in ks])),
        [s["ids"][k] for k in ks] if ids is None else ids,
        _t(np.stack(full), torch.bool),
        _t([s["residuals"][k] for k in ks]), 3.0, s["tcam"], cfg.depth,
        cfg.mapping, point_budget=B)


def _port_single(s, k, state=None, ref_id=None):
    cfg = s["tcfg"]
    p = s["tpyr"]
    return tobs.observe(
        s["tstate"] if state is None else state, p.images[0], p.gx[0],
        p.gy[0], p.max_grad[0], _t(s["imgs"][k]), _t(s["r2ks"][k]),
        s["ids"][k] if ref_id is None else ref_id,
        _t(np.repeat(np.repeat(s["gms"][k], 2, 0), 2, 1), torch.bool),
        _t(s["residuals"][k]), 3.0, s["tcam"], cfg.depth, cfg.mapping,
        point_budget=B)


def _assert_state_match(a, b):
    """The JAX package's multi-ref bound (tests/test_observe_multi.py)."""
    for f in FIELDS:
        assert np.max(np.abs(np.float64(a[f]) - np.float64(b[f]))) < 1e-5, f
    n_diff = int(np.sum(a["next_min_id"] != b["next_min_id"]))
    assert n_diff <= max(16, 0.01 * a["next_min_id"].size), n_diff
    assert np.max(np.abs(a["next_min_id"] - b["next_min_id"])) <= 10.0


def test_make_epl_multi_matches_jax(setup):
    s = setup
    t_stack = np.stack([r[4:7] for r in s["r2ks"][:4]]).astype(np.float32)
    (jx, jy), jok = jax.jit(lambda t, img: jobs.make_epl_multi(
        t, img, s["cam"], s["jcfg"].depth))(jnp.asarray(t_stack),
                                            s["pyr"].images[0])
    (tx, ty), tok = tobs.make_epl_multi(_t(t_stack), s["tpyr"].images[0],
                                        s["tcam"], s["tcfg"].depth)
    assert tuple(tok.shape) == (4, H, W)
    np.testing.assert_array_equal(np_(tok), np.asarray(jok))
    np.testing.assert_allclose(np_(tx), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_multi4(setup):
    """The JAX sweep over frames 0-3, shared by the tests against it."""
    return _jax_multi(setup, [0, 1, 2, 3])


def test_observe_multi_matches_jax(setup, jax_multi4):
    s = setup
    ks = [0, 1, 2, 3]
    j_state, j_stats = jax_multi4
    t_state, t_stats = _port_multi(s, ks)
    _assert_state_match(np_(t_state), to_dict(j_state))
    assert float(j_stats["updated"]) > 1000
    for key in tobs.OBSERVE_STAT_KEYS:
        a, b = float(j_stats[key]), float(t_stats[key])
        assert abs(a - b) <= 0.002 * max(float(j_stats["active"]), 1.0), key


def test_observe_multi_k1_equals_single(setup):
    s = setup
    st1, stats1 = _port_single(s, 0)
    st2, stats2 = _port_multi(s, [0])
    _assert_state_match(np_(st1), np_(st2))
    for key in tobs.OBSERVE_STAT_KEYS:
        assert abs(float(stats1[key]) - float(stats2[key])) <= max(
            2.0, 0.01 * float(stats1[key])), key


@pytest.mark.parametrize("ks,padded", [([0], [0, 0, 0]),
                                       ([0, 1], [0, 1, 1, 1])])
def test_padding_never_selected(setup, ks, padded):
    """Replicas of the newest frame (the JAX package's bucket padding) are
    never selected: the sweep is the same without them, which is why the
    port does not pad."""
    s = setup
    a = np_(_port_multi(s, ks)[0])
    b = np_(_port_multi(s, padded)[0])
    for f in FIELDS + ("next_min_id",):
        assert np.max(np.abs(np.float64(a[f]) - np.float64(b[f]))) < 1e-6, f


def test_next_min_id_selects_newer_frame(setup):
    """With every pixel gated past frame 0's id, a sweep over frames 0 and
    1 updates exactly as a single sweep against frame 1 (referenceFrameByID
    semantics); creation differs (the multi sweep creates from the oldest
    frame), so only previously valid pixels are compared."""
    s = setup
    ids = [5.0, 6.0]
    gated = s["tstate"].replace(next_min_id=torch.full((H, W), 6.0))
    st1, _ = _port_single(s, 1, state=gated, ref_id=6.0)
    st2, _ = _port_multi(s, [0, 1], state=gated, ids=ids)
    valid0 = np_(s["tstate"].valid)
    a, b = np_(st1), np_(st2)
    for f in ("idepth", "var", "validity"):
        assert np.max(np.abs(np.float64(a[f]) - np.float64(b[f]))[valid0]) \
            < 1e-5, f


def test_update_keyframe_multi_two_chunks_matches_jax(setup):
    """DepthMap.update_keyframe_multi with 10 frames: two chunks (8 + 2),
    the JAX package padding the second to 4, the port not padding; then
    fill holes, regularize and the export in each chunk."""
    s = setup
    assert MULTI_REF_BUCKETS[-1] == 8
    jdm = JaxDepthMap(s["cam"], s["jcfg"])
    jdm.state = s["state"]
    j_stats = jdm.update_keyframe_multi(
        s["pyr"], [jnp.asarray(i) for i in s["imgs"]], s["r2ks"], s["ids"],
        [jnp.asarray(g) for g in s["gms"]], s["residuals"])
    j_export = jdm.export_depth()
    tdm = DepthMap(s["tcam"], s["tcfg"], "cpu")
    tdm.state = s["tstate"]
    t_stats = tdm.update_keyframe_multi(
        s["tpyr"], [_t(i) for i in s["imgs"]], s["r2ks"], s["ids"],
        [_t(g, torch.bool) for g in s["gms"]], s["residuals"])
    t_export = tdm.export_depth()
    assert tdm.num_mapped_on_this == jdm.num_mapped_on_this == K_ALL
    _assert_state_match(np_(tdm.state), to_dict(jdm.state))
    for key in tobs.OBSERVE_STAT_KEYS:
        a, b = float(j_stats[key]), float(t_stats[key])
        assert abs(a - b) <= 0.002 * max(float(j_stats["active"]), 1.0), key
    assert float(t_stats["updated"]) > 1000
    np.testing.assert_allclose(t_export[2], j_export[2], rtol=1e-4)
    assert abs(t_export[3] - j_export[3]) <= 0.002 * W * H


# ------------------------------ the sweep's stages, the kernels' routing

def _stage_inputs(s, ks):
    """The multi sweep's inputs over frames `ks`, as observe_multi takes
    them (good masks at full resolution)."""
    p = s["tpyr"]
    return dict(
        state=s["tstate"], kf_img=p.images[0], kf_gx=p.gx[0], kf_gy=p.gy[0],
        kf_max_grad=p.max_grad[0],
        ref_stack=_t(np.stack([s["imgs"][k] for k in ks])),
        ref_to_kf=_t(np.stack([s["r2ks"][k] for k in ks])),
        ids=[s["ids"][k] for k in ks],
        good=_t(np.stack([np.repeat(np.repeat(s["gms"][k], 2, 0), 2, 1)
                          for k in ks]), torch.bool),
        residual=_t([s["residuals"][k] for k in ks]))


def _staged_multi(s, c):
    """observe_multi's stages called one by one."""
    cfg = s["tcfg"]
    dcfg, mcfg = cfg.depth, cfg.mapping
    setup = tobs.epl_setup(c["state"], c["kf_img"], c["kf_max_grad"],
                           c["ref_to_kf"][:, 4:7], c["ids"], c["good"],
                           s["tcam"], dcfg, mcfg)
    flat_idx, valid_k = tobs.compact_active(
        setup.process, tobs.frame_shift(c["ids"][-1], W * H), B)
    terms = tobs.frame_terms(tlie.se3_inverse(c["ref_to_kf"]),
                             0.25 * (1.0 + c["residual"]), s["tcam"])
    grids = tobs.epl_search(setup, flat_idx, valid_k, c["kf_img"],
                            c["kf_gx"], c["kf_gy"], c["ref_stack"], terms,
                            s["tcam"], dcfg, mcfg)
    state, stats = tobs.fuse(c["state"], setup, grids, valid_k,
                             c["kf_max_grad"], c["ids"], 3.0, dcfg)
    return setup, (flat_idx, valid_k), terms, grids, state, stats


@pytest.mark.parametrize("ks", [[0, 1, 2, 3], list(range(8))])
def test_setup_for_the_selected_frame_equals_the_gathered_stack(setup, ks):
    """The per-pixel set-up runs makeAndCheckEPL for each pixel's selected
    frame alone; that equals make_epl_multi's (K, H, W) stack gathered at
    k_sel bit for bit, and JAX's make_epl_multi gathered there within
    test_make_epl_multi_matches_jax's bound."""
    s = setup
    c = _stage_inputs(s, ks)
    st = tobs.epl_setup_plain(c["state"], c["kf_img"], c["kf_max_grad"],
                              c["ref_to_kf"][:, 4:7], c["ids"], c["good"],
                              s["tcam"], s["tcfg"].depth, s["tcfg"].mapping)
    k_sel = st.k_sel
    assert len(torch.unique(k_sel)) >= min(len(ks), 3)
    (tx, ty), tok = tobs.make_epl_multi(c["ref_to_kf"][:, 4:7], c["kf_img"],
                                        s["tcam"], s["tcfg"].depth)
    gathered = [torch.gather(a, 0, k_sel[None])[0] for a in (tx, ty, tok)]
    for got, want in zip((st.epx, st.epy, st.epl_ok), gathered):
        if got.dtype.is_floating_point:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got, want)
    t_stack = np.stack([s["r2ks"][k][4:7] for k in ks]).astype(np.float32)
    (jx, jy), jok = jax.jit(lambda t, img: jobs.make_epl_multi(
        t, img, s["cam"], s["jcfg"].depth))(jnp.asarray(t_stack),
                                            s["pyr"].images[0])
    kk = np_(k_sel)[None]
    pick = lambda a: np.take_along_axis(np.asarray(a), kk, 0)[0]  # noqa
    np.testing.assert_array_equal(np_(st.epl_ok), pick(jok))
    np.testing.assert_allclose(np_(st.epx), pick(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(st.epy), pick(jy), rtol=1e-5, atol=1e-6)


def test_staged_multi_sweep_meets_the_jax_bounds(setup, jax_multi4):
    """observe_multi's stages called one by one give observe_multi's state
    and stats bit for bit, and hold the JAX package's multi-ref bound."""
    s = setup
    ks = [0, 1, 2, 3]
    *_, state, stats = _staged_multi(s, _stage_inputs(s, ks))
    t_state, t_stats = _port_multi(s, ks)
    for f in FIELDS + ("next_min_id",):
        assert torch.equal(getattr(state, f), getattr(t_state, f)), f
    j_state, j_stats = jax_multi4
    _assert_state_match(np_(state), to_dict(j_state))
    for key in tobs.OBSERVE_STAT_KEYS:
        assert int(stats[key]) == int(t_stats[key]), key
        a, b = float(j_stats[key]), float(stats[key])
        assert abs(a - b) <= 0.002 * max(float(j_stats["active"]), 1.0), key
