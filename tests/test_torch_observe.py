"""One observe program (observe sweep + fill holes + regularize + export)
in both packages from the same depth state, keyframe and tracked frame.

The state comes from the JAX engine after three tracked frames at 160x128
and is carried across with lsd_slam_tpu_torch.interop; the tracked frame's
pose, good mask and residual are the JAX tracker's. Compared: the
line-stereo outcome codes of the compacted points, every state field, the
stats pack and the export.

XLA on the CPU contracts a*b+c into one FMA and folds constant divisions;
torch rounds each operation. So values agree to a few ulps, not bit for
bit. Tolerances: codes, validity masks and blacklist counts exactly on all
but 0.2% of the points (an EPL search picks its best step by an argmin
over 34 SSD values, and a last-bit difference can swap two near-equal
steps); validity counters and next-id fields to rtol 1e-6 on all but 0.2%
of the pixels; inverse depths and variances to rtol 1e-4 on the pixels
both packages keep; EPL lengths to rtol 1e-4 (differences of projected
endpoints); stats counts to 0.2%.
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
from lsd_slam_tpu.depth.depth_map import get_depth_programs
from lsd_slam_tpu.frames import build_frame
from lsd_slam_tpu.system import SlamSystem as JaxSystem
from lsd_slam_tpu.utils import synth

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch import lie as tlie
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.depth import regularize as treg
from lsd_slam_tpu_torch.depth.depth_map import export_arrays, observe_program
from lsd_slam_tpu_torch.ops import epl_stereo
from lsd_slam_tpu_torch.interop import (depth_state_from_dict,
                                        frame_pyramid_from_dict)

from _torch_parity import to_dict, np_

W, H = 160, 128
N_PRE = 4  # frames the JAX engine maps before the compared observe


@pytest.fixture(scope="module")
def observed():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=7)
    poses = synth.orbit_trajectory(18, radius=0.06, fwd=0.01)
    imgs, deps = [], []
    for i in range(N_PRE + 1):
        img, dep = synth.render(scene, cam, jnp.asarray(poses[i]))
        imgs.append(np.asarray(img))
        deps.append(np.asarray(dep))
    jcfg = JaxConfig(width=W, height=H)
    jsys = JaxSystem(cam, jcfg, enable_slam=False)
    jsys.gt_depth_init(imgs[0], deps[0], 0, 0.0)
    for i in range(1, N_PRE):
        jsys.track_frame(imgs[i], i, i / 30.0)
    kf = jsys.current_keyframe
    assert kf.id == 0
    pyr = build_frame(jnp.asarray(imgs[N_PRE]))
    res = jsys.tracker.track(kf.tracking_ref, pyr,
                             jnp.asarray([1, 0, 0, 0, 0, 0, 0], jnp.float32))
    state = jsys.map.state
    skip_inc, ref_id = 3.0, float(N_PRE)
    budget = 8192
    prog = get_depth_programs(cam, jcfg).observe
    j_state, j_stats, j_export = prog(
        state, kf.pyr.images[0], kf.pyr.gx[0], kf.pyr.gy[0],
        kf.pyr.max_grad[0], pyr.images[0], res.frame_to_ref,
        jnp.float32(ref_id), res.good_mask, res.initial_residual,
        jnp.float32(skip_inc), point_budget=budget)

    tcam = Camera(**dataclasses.asdict(cam))
    tcfg = LSDConfig(width=W, height=H)
    tkf = frame_pyramid_from_dict(to_dict(kf.pyr), device="cpu")
    inputs = dict(
        state=depth_state_from_dict(to_dict(state), device="cpu"),
        ref_img=torch.from_numpy(np.asarray(pyr.images[0])),
        ref_to_kf=torch.from_numpy(np.asarray(res.frame_to_ref)),
        good_mask=torch.from_numpy(np.asarray(res.good_mask)),
        residual=torch.tensor(float(res.initial_residual)))
    t_state, t_stats, t_export = observe_program(
        inputs["state"], tkf.images[0], tkf.gx[0], tkf.gy[0],
        tkf.max_grad[0], inputs["ref_img"], inputs["ref_to_kf"], ref_id,
        inputs["good_mask"], inputs["residual"], skip_inc, tcam, tcfg,
        point_budget=budget)
    return dict(cam=cam, tcam=tcam, jcfg=jcfg, tcfg=tcfg, kf=kf, tkf=tkf,
                state=state, inputs=inputs, res=res, pyr=pyr,
                budget=budget, ref_id=ref_id,
                j=(j_state, j_stats, j_export), t=(t_state, t_stats, t_export))


def test_line_stereo_codes_match(observed):
    o = observed
    cam, kf, inp = o["cam"], o["kf"], o["inputs"]
    dcfg, mcfg = o["jcfg"].depth, o["jcfg"].mapping
    state = o["state"]
    # the compacted active set of this sweep, shared by both packages
    (epx, epy), epl_ok = jobs.make_epl(o["res"].frame_to_ref[4:7],
                                       kf.pyr.images[0], cam, dcfg)
    (tepx, tepy), tepl_ok = tobs.make_epl(inp["ref_to_kf"][4:7],
                                          o["tkf"].images[0], o["tcam"],
                                          o["tcfg"].depth)
    np.testing.assert_array_equal(np_(tepl_ok), np.asarray(epl_ok))
    np.testing.assert_allclose(np_(tepx), np.asarray(epx), rtol=1e-5,
                               atol=1e-6)
    flat = np.flatnonzero(np.asarray(epl_ok & state.valid))[:3000]
    xs = (flat % W).astype(np.float32)
    ys = (flat // W).astype(np.float32)
    prior = np.asarray(state.idepth_smoothed).reshape(-1)[flat]
    sv = np.sqrt(np.maximum(np.asarray(state.var_smoothed).reshape(-1)[flat],
                            0))
    lo = np.clip(prior - 2 * sv, 0, None).astype(np.float32)
    hi = np.minimum(prior + 2 * sv, 20.0).astype(np.float32)
    take = lambda a: np.asarray(a).reshape(-1)[flat]  # noqa: E731
    kf_to_ref = jlie.se3_inverse(o["res"].frame_to_ref)
    tef = 0.25 * (1.0 + float(o["res"].initial_residual))
    ls = jax.jit(lambda *a: jobs.line_stereo(
        *a, jnp.float32(tef), cam, dcfg, mcfg, True))
    jcode, jid, jvar, jepl, _ = (np.asarray(x) for x in ls(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(prior),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(take(epx)),
        jnp.asarray(take(epy)), kf.pyr.images[0], jnp.asarray(take(
            kf.pyr.gx[0])), jnp.asarray(take(kf.pyr.gy[0])),
        o["pyr"].images[0], kf_to_ref, o["res"].frame_to_ref))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tcode, tid, tvar, tepl, _ = (np_(x) for x in tobs.line_stereo(
        t(xs), t(ys), t(prior), t(lo), t(hi), t(take(epx)), t(take(epy)),
        o["tkf"].images[0], t(take(kf.pyr.gx[0])), t(take(kf.pyr.gy[0])),
        inp["ref_img"], t(np.asarray(kf_to_ref)), inp["ref_to_kf"],
        torch.tensor(tef), o["tcam"], o["tcfg"].depth, o["tcfg"].mapping,
        True))
    assert (jcode == 0).sum() > 500
    assert (tcode != jcode).mean() <= 0.002
    both = (tcode == 0) & (jcode == 0)
    np.testing.assert_allclose(tid[both], jid[both], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tvar[both], jvar[both], rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(tepl, jepl, rtol=1e-4, atol=1e-5)


def _assert_state_bounds(j_state, t_state):
    """The module's bounds on a state against the JAX package's."""
    a, b = to_dict(j_state), np_(t_state)
    n = a["valid"].size
    for key in ("valid", "blacklisted"):
        assert (a[key] != b[key]).sum() <= 0.002 * n, key
    for key in ("next_min_id", "validity"):
        off = ~np.isclose(b[key], a[key], rtol=1e-6, atol=1e-6)
        assert off.sum() <= 0.002 * n, key
    keep = a["valid"] & b["valid"]
    for key in ("idepth", "var", "idepth_smoothed", "var_smoothed"):
        np.testing.assert_allclose(b[key][keep], a[key][keep], rtol=1e-4,
                                   atol=1e-7, err_msg=key)


def test_observe_state_matches(observed):
    j_state, _, _ = observed["j"]
    _assert_state_bounds(j_state, observed["t"][0])


def test_observe_stats_and_export_match(observed):
    _, j_stats, j_export = observed["j"]
    _, t_stats, t_export = observed["t"]
    assert set(j_stats) == set(tobs.OBSERVE_STAT_KEYS)
    assert float(j_stats["updated"]) > 500
    for key in tobs.OBSERVE_STAT_KEYS:
        a, b = float(j_stats[key]), float(t_stats[key])
        assert abs(a - b) <= 0.002 * max(float(j_stats["active"]), 1.0), key
    np.testing.assert_allclose(float(t_export[2]), float(j_export[2]),
                               rtol=1e-4)
    assert abs(int(t_export[3]) - int(j_export[3])) <= 0.002 * W * H


# ---------------------------------------------- the sweep's four stages

def _staged(o):
    """`observe`'s stages called one by one (set-up, compaction, search,
    fusion), then fill holes, regularize and the export, as
    observe_program runs them."""
    inp, tkf, tcfg = o["inputs"], o["tkf"], o["tcfg"]
    dcfg, mcfg = tcfg.depth, tcfg.mapping
    state, ref_to_kf = inp["state"], inp["ref_to_kf"]
    from lsd_slam_tpu_torch.depth.depth_map import upsample_mask
    good = upsample_mask(inp["good_mask"], tcfg)
    setup = tobs.epl_setup(state, tkf.images[0], tkf.max_grad[0],
                           ref_to_kf[None, 4:7], [o["ref_id"]], good[None],
                           o["tcam"], dcfg, mcfg)
    flat_idx, valid_k = tobs.compact_active(
        setup.process, tobs.frame_shift(o["ref_id"], W * H), o["budget"])
    terms = tobs.frame_terms(tlie.se3_inverse(ref_to_kf),
                             0.25 * (1.0 + inp["residual"]), o["tcam"])
    grids = tobs.epl_search(setup, flat_idx, valid_k, tkf.images[0],
                            tkf.gx[0], tkf.gy[0], inp["ref_img"][None],
                            terms, o["tcam"], dcfg, mcfg)
    swept, stats = tobs.fuse(state, setup, grids, valid_k, tkf.max_grad[0],
                             [o["ref_id"]], 3.0, dcfg)
    out = treg.fill_holes(swept, tkf.max_grad[0], dcfg, mcfg.min_use_grad)
    out = treg.regularize(out, False, dcfg.val_sum_min_for_keep, dcfg,
                          mcfg.depth_smoothing_factor)
    return swept, stats, out, export_arrays(out)


def test_staged_sweep_meets_the_jax_bounds(observed):
    """The sweep's stages, called one by one, give `observe_program`'s
    state, stats and export bit for bit and so hold the JAX bounds."""
    _, stats, state, export = _staged(observed)
    t_state, t_stats, t_export = observed["t"]
    for f in ("valid", "idepth", "var", "validity", "blacklisted",
              "next_min_id", "idepth_smoothed", "var_smoothed"):
        assert torch.equal(getattr(state, f), getattr(t_state, f)), f
    for key in tobs.OBSERVE_STAT_KEYS:
        assert int(stats[key]) == int(t_stats[key]), key
    assert float(export[2]) == float(t_export[2])
    j_state, j_stats, _ = observed["j"]
    _assert_state_bounds(j_state, state)
    for key in tobs.OBSERVE_STAT_KEYS:
        a, b = float(j_stats[key]), float(stats[key])
        assert abs(a - b) <= 0.002 * max(float(j_stats["active"]), 1.0), key


# ------------------------------------------------------------- routing

def _count(calls, name, fn):
    def call(*a, **k):
        calls.append(name)
        return fn(*a, **k)
    return call


def test_cpu_tensors_take_the_plain_versions(observed, monkeypatch):
    """CPU tensors reach the three plain versions, never a kernel
    wrapper."""
    calls = []
    for name in ("epl_setup_plain", "epl_search_plain", "fuse_plain"):
        monkeypatch.setattr(tobs, name, _count(calls, name,
                                               getattr(tobs, name)))

    def no_kernel(*a, **k):
        raise AssertionError("kernel wrapper reached with CPU tensors")
    for name in epl_stereo.KERNELS:
        monkeypatch.setattr(epl_stereo, name, no_kernel)
    _staged(observed)
    assert calls == ["epl_setup_plain", "epl_search_plain", "fuse_plain"]


def _meta_setup():
    f32, b8 = dict(dtype=torch.float32), dict(dtype=torch.bool)
    grid = lambda **k: torch.empty(8, 8, device="meta", **k)  # noqa: E731
    return tobs.EplSetup(
        epx=grid(**f32), epy=grid(**f32), epl_ok=grid(**b8),
        can_update=grid(**b8), can_create=grid(**b8), process=grid(**b8),
        prior=grid(**f32), min_id=grid(**f32), max_id=grid(**f32),
        k_sel=grid(dtype=torch.int64))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kernel", epl_stereo.KERNELS)
def test_kernel_wrappers_refuse_other_devices(observed, kernel, device):
    """Each wrapper launches its kernel or raises: no tensor off the card
    is computed on (a CPU tensor reaches a wrapper only when called
    directly; the routing sends it to the plain version)."""
    from lsd_slam_tpu_torch.depth.state import DepthMapState
    o = observed
    tcfg = o["tcfg"]
    dcfg, mcfg = tcfg.depth, tcfg.mapping
    grid = lambda dtype=torch.float32: torch.zeros(  # noqa: E731
        8, 8, dtype=dtype, device=device)
    state = DepthMapState.empty(8, 8, device=device)
    setup = _meta_setup() if device == "meta" else tobs.EplSetup(
        *(torch.zeros(8, 8, dtype=t.dtype) for t in _meta_setup()[:10]))
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "epl_prepare":
            epl_stereo.epl_prepare(
                state, grid(), grid(), torch.zeros(1, 3, device=device),
                [1.0], grid(torch.bool)[None], o["tcam"], dcfg, mcfg)
        elif kernel == "epl_stereo":
            terms = tobs.FrameTerms(*(torch.zeros(s, device=device) for s in (
                (1, 3, 3), (1, 3), (1, 3, 3), (1, 3), (1,))))
            epl_stereo.epl_stereo(
                setup, torch.zeros(4, dtype=torch.int64, device=device),
                torch.zeros(4, dtype=torch.bool, device=device), grid(),
                grid(), grid(), grid()[None], terms, o["tcam"], dcfg, mcfg)
        else:
            grids = tobs.StereoGrids(grid(torch.int32), grid(), grid(),
                                     grid())
            epl_stereo.observe_fuse(state, setup, grids, grid(), [1.0],
                                    3.0, dcfg)


def test_routing_sends_other_devices_to_the_kernels(observed):
    """The routing takes the plain version only on the CPU: a tensor on
    any other device goes to the kernel wrapper, which raises."""
    o = observed
    tcfg = o["tcfg"]
    state = tobs.DepthMapState.empty(8, 8, device="meta")
    grid = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tobs.epl_setup(state, grid, grid, torch.zeros(1, 3, device="meta"),
                       [1.0], torch.zeros(1, 8, 8, dtype=torch.bool,
                                          device="meta"), o["tcam"],
                       tcfg.depth, tcfg.mapping)


def test_params_round_like_the_plain_version(observed):
    """Every float constant the kernels get is the f32 torch uses for the
    same Python constant (or Python expression) in the plain version."""
    o = observed
    cam, dcfg, mcfg = o["tcam"], o["tcfg"].depth, o["tcfg"].mapping
    prm = epl_stereo.make_params(cam, dcfg, mcfg, H, W, [4.0, 5.0],
                                 budget=8192, skip_inc=3.0)
    f = np.float32
    b = float(dcfg.sample_point_to_border)
    want = dict(
        fx=f(cam.fx), cx_fx=f(cam.cx / cam.fx), cy_fy=f(cam.cy / cam.fy),
        neg_fy=f(-cam.fy), inv_min_depth=f(1.0 / dcfg.min_depth),
        half_min_crop=f(0.5 * dcfg.min_epl_length_crop),
        w_border=f(W - b), h_border=f(H - b), kf_u_hi=f(W - 1.001),
        ref_v_hi=f(2 * H - 1.001), ref_by_hi=f(2 * H - 4.0),
        err_big=f(4.0 * dcfg.max_error_stereo),
        photo_num=f(4.0 * mcfg.camera_pixel_noise2),
        succ_var_inc=f(dcfg.succ_var_inc_fac), skip_inc=f(3.0))
    for key, value in want.items():
        assert getattr(prm, key) == value, key
    assert (prm.multi, prm.n_ref, prm.n_pix, prm.budget) == (1, 2, W * H,
                                                             8192)
    assert list(prm.ids)[:3] == [4.0, 5.0, 0.0]
    assert prm.cap_fac == float(f(dcfg.validity_counter_max_variable)
                                * f(1.0 / 255.0))
    with pytest.raises(ValueError, match="reference frames"):
        epl_stereo.make_params(cam, dcfg, mcfg, H, W, [1.0] * 17)
