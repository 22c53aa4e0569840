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
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.depth.depth_map import observe_program
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
    tkf = frame_pyramid_from_dict(to_dict(kf.pyr))
    inputs = dict(
        state=depth_state_from_dict(to_dict(state)),
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


def test_observe_state_matches(observed):
    j_state, _, _ = observed["j"]
    t_state = observed["t"][0]
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
