"""The observe sweep's kernels (csrc/epl_stereo.cu) on the card against
their plain versions run on the CPU, from the same inputs.

JAX-free, so it runs on a GPU host (`pytest --noconftest -m cuda`): the
inputs are the port's own, [observe-multi]'s scene of chip_smoke.py at
160x128 (BenchScene(seed=0), the keyframe at its ground-truth depth, a
per-pixel next_min_id, good masks and residuals from a seed), with 30% of
the pixels invalidated so the create path runs too. Every test skips on a
host without a card: the kernels have no CPU mode (tests/test_torch_observe
and tests/test_torch_observe_multi hold the CPU plain versions to JAX).

Bounds (tests/test_torch_observe.py's): codes and masks off on at most
0.2% of the points, inverse depths, variances and EPL lengths to rtol
1e-4 where the codes agree; the fusion and the whole sweep: valid and the
blacklist off on at most 0.2% of the pixels, validity and next_min_id to
rtol 1e-6 on all but 0.2%, idepth and var to rtol 1e-4 where both are
valid, stats within 0.2% of the active points.
"""

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.depth.depth_map import DepthMap, upsample_mask
from lsd_slam_tpu_torch.frames import build_frame
from lsd_slam_tpu_torch.lie import np_sim3 as nps
from lsd_slam_tpu_torch.ops import epl_stereo
from lsd_slam_tpu_torch.utils import synth

W, H, B = 160, 128, 4096
pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def make_scene():
    """The inputs' scene on the CPU (also built by
    tests/test_torch_epl_host.py, which needs no card)."""
    cam = synth.default_camera(W, H)
    cfg = LSDConfig(width=W, height=H)
    poses = synth.bench_trajectory(130)
    bench = synth.BenchScene(seed=0)
    rng = np.random.default_rng(0)
    renders = [synth.render_realistic(bench, cam, poses[i], frame_index=i,
                                      noise_sigma=0.0, device="cpu")
               for i in range(9)]
    kf_img, kf_dep = renders[0]
    pyr = build_frame(kf_img, 5)
    dm = DepthMap(cam, cfg, "cpu")
    dm.initialize_from_gt(torch.where(kf_dep > 0, 1.0 / torch.clamp_min(
        kf_dep, 1e-6), torch.zeros_like(kf_dep)), pyr.max_grad[0])
    drop = torch.as_tensor(rng.uniform(size=(H, W)) < 0.3)
    st = dm.state
    state = st.replace(
        valid=st.valid & ~drop,
        next_min_id=torch.as_tensor(rng.integers(0, 17, (H, W)).astype(
            np.float32)),
        blacklisted=torch.as_tensor(rng.integers(-2, 1, (H, W)).astype(
            np.int32)))
    r2k = [nps.se3_mul(poses[0].astype(np.float64),
                       nps.se3_inverse(poses[k].astype(np.float64)))
           for k in range(9)]
    good = [torch.as_tensor(rng.uniform(size=(H // 2, W // 2)) < 0.9)
            for _ in range(9)]
    res = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    return dict(cam=cam, cfg=cfg, pyr=pyr, state=state, renders=renders,
                r2k=r2k, good=good, res=res)


@pytest.fixture(scope="module")
def scene():
    _need_card()
    return make_scene()


def _inputs(s, frames):
    """The sweep's inputs over `frames` on the CPU."""
    return dict(
        state=s["state"], kf_img=s["pyr"].images[0], kf_gx=s["pyr"].gx[0],
        kf_gy=s["pyr"].gy[0], kf_max_grad=s["pyr"].max_grad[0],
        ref_stack=torch.stack([s["renders"][i][0] for i in frames]),
        ref_to_kf=torch.as_tensor(np.stack([s["r2k"][i] for i in frames]),
                                  dtype=torch.float32),
        ids=[float(4 + i) for i in frames],
        good=upsample_mask(torch.stack([s["good"][i] for i in frames]),
                           s["cfg"]),
        residual=torch.as_tensor(s["res"][list(frames)]))


def _on(x, dev):
    """Tensors, states and named tuples of tensors on `dev`."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if hasattr(x, "replace") and hasattr(x, "next_min_id"):
        return x.replace(**{f: _on(getattr(x, f), dev) for f in (
            "valid", "idepth", "var", "idepth_smoothed", "var_smoothed",
            "validity", "blacklisted", "next_min_id")})
    return x


def _terms(s, c):
    if len(c["ids"]) == 1:
        return tobs.frame_terms(lie.se3_inverse(c["ref_to_kf"][0]),
                                0.25 * (1.0 + c["residual"][0]), s["cam"])
    return tobs.frame_terms(lie.se3_inverse(c["ref_to_kf"]),
                            0.25 * (1.0 + c["residual"]), s["cam"])


def _with_buffers(setup):
    """A set-up on the card with the buffers the search and fusion kernels
    take from it (what epl_prepare gives): result grids filled with the
    not-processed values and zeroed counts."""
    f32 = dict(dtype=torch.float32, device="cuda")
    return _on(setup, "cuda")._replace(
        out=tobs.StereoGrids(
            torch.full((H, W), tobs.SKIP, dtype=torch.int32, device="cuda"),
            torch.zeros((H, W), **f32), torch.zeros((H, W), **f32),
            torch.full((H, W), 1e9, **f32)),
        stats=torch.zeros(len(tobs.OBSERVE_STAT_KEYS), dtype=torch.int64,
                          device="cuda"))


def _plain_stages(s, c):
    """The sweep's stages on their plain versions (CPU)."""
    dcfg, mcfg = s["cfg"].depth, s["cfg"].mapping
    st = tobs.epl_setup_plain(c["state"], c["kf_img"], c["kf_max_grad"],
                              c["ref_to_kf"][:, 4:7], c["ids"], c["good"],
                              s["cam"], dcfg, mcfg)
    flat_idx, valid_k = tobs.compact_active(
        st.process, tobs.frame_shift(c["ids"][-1], W * H), B)
    terms = _terms(s, c)
    grids = tobs.epl_search_plain(st, flat_idx, valid_k, c["kf_img"],
                                  c["kf_gx"], c["kf_gy"], c["ref_stack"],
                                  terms, s["cam"], dcfg, mcfg)
    new, stats = tobs.fuse_plain(c["state"], st, grids, valid_k,
                                 c["kf_max_grad"], c["ids"], 3.0, dcfg)
    return st, flat_idx, valid_k, terms, grids, new, stats


def _assert_state(got, want, stats_got=None, stats_want=None):
    n = W * H
    a = {f: getattr(got, f).cpu().numpy() for f in (
        "valid", "blacklisted", "validity", "next_min_id", "idepth", "var")}
    b = {f: getattr(want, f).cpu().numpy() for f in a}
    for f in ("valid", "blacklisted"):
        assert (a[f] != b[f]).sum() <= 0.002 * n, f
    for f in ("validity", "next_min_id"):
        off = ~np.isclose(a[f], b[f], rtol=1e-6, atol=1e-6)
        assert off.sum() <= 0.002 * n, f
    keep = a["valid"] & b["valid"]
    for f in ("idepth", "var"):
        np.testing.assert_allclose(a[f][keep], b[f][keep], rtol=1e-4,
                                   atol=1e-7, err_msg=f)
    if stats_got is not None:
        active = max(float(stats_want["active"]), 1.0)
        for k in tobs.OBSERVE_STAT_KEYS:
            assert abs(float(stats_got[k]) - float(stats_want[k])) \
                <= 0.002 * active, k


FRAMES = {"single": [1], "multi": [1, 2, 3, 4]}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_epl_prepare_matches_its_plain_version(scene, case):
    _need_card()
    s, c = scene, _inputs(scene, FRAMES[case])
    want = _plain_stages(s, c)[0]
    got = epl_stereo.epl_prepare(
        _on(c["state"], "cuda"), *_on((c["kf_img"], c["kf_max_grad"],
                                       c["ref_to_kf"][:, 4:7].contiguous()),
                                      "cuda"),
        c["ids"], _on(c["good"], "cuda"), s["cam"], s["cfg"].depth,
        s["cfg"].mapping)
    for f in tobs.EplSetup._fields[:10]:
        a, b = getattr(got, f).cpu().numpy(), getattr(want, f).numpy()
        if a.dtype.kind in "bi":
            assert np.mean(a != b) <= 0.002, f
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=f)
    # the result grids come filled with the not-processed values
    for g, fill in zip(got.out, (tobs.SKIP, 0.0, 0.0, 1e9)):
        assert bool((g == fill).all())
    assert int(got.stats.abs().sum()) == 0


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_epl_stereo_matches_its_plain_version(scene, case):
    _need_card()
    s, c = scene, _inputs(scene, FRAMES[case])
    st, flat_idx, valid_k, terms, grids, _, _ = _plain_stages(s, c)
    cu = lambda x: _on(x, "cuda")  # noqa: E731
    got = epl_stereo.epl_stereo(
        _with_buffers(st), cu(flat_idx), cu(valid_k), cu(c["kf_img"]),
        cu(c["kf_gx"]), cu(c["kf_gy"]), cu(c["ref_stack"]), cu(terms),
        s["cam"], s["cfg"].depth, s["cfg"].mapping)
    slots = flat_idx[valid_k].numpy()
    assert slots.size > 500
    a = [g.cpu().numpy().reshape(-1)[slots] for g in got]
    b = [g.numpy().reshape(-1)[slots] for g in grids]
    assert np.mean(a[0] != b[0]) <= 0.002
    ok = (a[0] == 0) & (b[0] == 0)
    for x, y in zip(a[1:3], b[1:3]):
        np.testing.assert_allclose(x[ok], y[ok], rtol=1e-4, atol=1e-9)
    agree = a[0] == b[0]
    np.testing.assert_allclose(a[3][agree], b[3][agree], rtol=1e-4,
                               atol=1e-9, equal_nan=True)
    # the slots not searched keep the fill
    rest = np.ones(W * H, bool)
    rest[slots] = False
    assert (got.code.cpu().numpy().reshape(-1)[rest] == tobs.SKIP).all()


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_observe_fuse_matches_its_plain_version(scene, case):
    _need_card()
    s, c = scene, _inputs(scene, FRAMES[case])
    st, _, _, _, grids, want, want_stats = _plain_stages(s, c)
    got, stats = epl_stereo.observe_fuse(
        _on(c["state"], "cuda"), _with_buffers(st), _on(grids, "cuda"),
        _on(c["kf_max_grad"], "cuda"), c["ids"], 3.0, s["cfg"].depth)
    _assert_state(got, want)
    for k in tobs.OBSERVE_STAT_KEYS:
        assert int(stats[k]) == int(want_stats[k]), k
    assert int(want_stats["created"]) > 0 and int(want_stats["updated"]) > 0


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_sweep_on_the_card_launches_the_kernels_only(scene, case,
                                                     monkeypatch):
    """On the card `observe` / `observe_multi` launch the three kernels
    once each, call no plain version and give the CPU sweep's result
    within the bounds."""
    _need_card()
    s, c = scene, _inputs(scene, FRAMES[case])
    want, want_stats = _plain_stages(s, c)[5:]

    def plain(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")
    for name in ("epl_setup_plain", "epl_search_plain", "fuse_plain",
                 "make_epl", "make_epl_multi", "line_stereo_points",
                 "_fuse_results"):
        monkeypatch.setattr(tobs, name, plain)
    g = _on(c, "cuda")
    kf = (g["kf_img"], g["kf_gx"], g["kf_gy"], g["kf_max_grad"])
    dcfg, mcfg = s["cfg"].depth, s["cfg"].mapping
    before = epl_stereo.counts()
    if case == "single":
        got, stats = tobs.observe(
            g["state"], *kf, g["ref_stack"][0], g["ref_to_kf"][0],
            g["ids"][0], g["good"][0], g["residual"][0], 3.0, s["cam"], dcfg,
            mcfg, point_budget=B)
    else:
        got, stats = tobs.observe_multi(
            g["state"], *kf, g["ref_stack"], g["ref_to_kf"], g["ids"],
            g["good"], g["residual"], 3.0, s["cam"], dcfg, mcfg,
            point_budget=B)
    torch.cuda.synchronize()
    after = epl_stereo.counts()
    assert all(after[k] == before[k] + 1 for k in after), (before, after)
    _assert_state(got, want, stats, want_stats)


def test_epl_stereo_ties_and_nans(scene, monkeypatch):
    """The search on a reference image constant but for a block of NaN
    pixels (a slot's steps all tie, or NaN samples make steps NaN) and
    NaN far bounds at a tenth of the pixels (every lattice coordinate
    NaN): the plain version's codes, best and second best steps, so its
    bits (NaN for NaN), with a correctly rounded sqrt on the CPU (numpy's,
    as the kernel's sqrtf)."""
    _need_card()
    s, c = scene, _inputs(scene, FRAMES["single"])
    st, flat_idx, valid_k, terms, _, _, _ = _plain_stages(s, c)
    ref = torch.full_like(c["ref_stack"], 100.0)
    ref[:, 40:70, 20:140:5] = float("nan")
    rng = np.random.default_rng(3)
    nan_far = torch.as_tensor(rng.uniform(size=(H, W)) < 0.1)
    st = st._replace(max_id=torch.where(
        nan_far, torch.full_like(st.max_id, float("nan")), st.max_id))
    args = (flat_idx, valid_k, c["kf_img"], c["kf_gx"], c["kf_gy"], ref,
            terms, s["cam"], s["cfg"].depth, s["cfg"].mapping)
    real_sqrt = torch.sqrt

    def sqrt(x, *a, **k):
        if not a and not k and torch.is_tensor(x) and x.dtype == torch.float32:
            return torch.from_numpy(np.sqrt(x.numpy()))
        return real_sqrt(x, *a, **k)
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", sqrt)
        want = tobs.epl_search_plain(st, *args)
    got = epl_stereo.epl_stereo(_with_buffers(st), *_on(args[:7], "cuda"),
                                *args[7:])
    slots = flat_idx[valid_k].numpy()
    a = [g.cpu().numpy().reshape(-1)[slots] for g in got]
    b = [g.numpy().reshape(-1)[slots] for g in want]
    assert (a[0] == b[0]).all()
    for x, y in zip(a[1:], b[1:]):
        same = (x.view(np.int32) == y.view(np.int32)) | (
            np.isnan(x) & np.isnan(y))
        assert same.all(), int((~same).sum())
    assert int((b[0] == tobs.ERR_NAN).sum()) > 50
