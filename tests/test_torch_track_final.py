"""The SE(3) track's final pass inside its last `lm_level` launch
(csrc/lm_track.cu's epilogue, routed by tracking/se3_tracker.py `track`).

On the card (marked `cuda`, skipped here: the kernel has no CPU mode):
the fused track against the plain final pass (`final_pass_plain`, run on
the CPU at the kernel's loop pose and affine pair) on the 160x128 scene of
tests/test_torch_rules.py and on a 640x480 pair made as `chip_smoke.py`'s
[vo] makes its frames: the good mask bit for bit, the in-image, good and
bad counts exactly, the final error and the usage within 1e-6 relative,
the other pack entries as the torch tail derives them from those; the
diverged flag as the OR over the levels; at most 8 kernels a track by
torch.profiler; and a quick-tracker launch, which passes no final outputs,
with its bits as without the epilogue.

On the CPU: the C structs and the entry's arguments against their ctypes
mirrors, the pack's order against `HOST_PACK`, the point sets' contiguous
fields, the plain loop's start options, and a CPU track taking the plain
route. This file imports no JAX, so the card runs it with `--noconftest`.
"""

import ctypes
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.ops import lm_track
from lsd_slam_tpu_torch.tracking import SE3Tracker, lm
from lsd_slam_tpu_torch.tracking import se3_tracker as se3
from lsd_slam_tpu_torch.tracking.reference import (compact_points,
                                                   compact_slots)

from test_torch_rules import CAM, CFG, _lm_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lsd_slam_tpu_torch", "csrc", "lm_track.cu")
VO_REF = os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                      "vo_orbit_640x480.json")
IDENTITY = [1.0, 0, 0, 0, 0, 0, 0]
HP = se3.HOST_PACK


def _source():
    with open(SOURCE) as f:
        return f.read()


def _c_type(decl: str):
    """ctypes kind of a C declaration's type: a pointer, an int or a
    long long."""
    if "*" in decl:
        return ctypes.c_void_p
    kind = " ".join(decl.replace("const", "").split()[:-1])
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[kind]


def test_final_struct_matches_its_ctypes_mirror():
    """`struct LsdLmFinal` and `ops.lm_track.Final` list the same fields
    in the same order, pointers against pointers."""
    body = re.search(r"struct LsdLmFinal \{(.*?)\n\};", _source(),
                     re.S).group(1)
    want = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if line:
            want.append((re.split(r"[\s*]+", line)[-1], _c_type(line)))
    assert [(n, t) for n, t in lm_track.Final._fields_] == want


def test_entry_arguments_match_their_ctypes_mirror():
    """`lsd_lm_level`'s parameters, in order, against the wrapper's
    argtypes: a pointer where C takes a pointer, an int where an int."""
    params = re.search(r'extern "C" int lsd_lm_level\((.*?)\)\s*\{',
                       _source(), re.S).group(1)
    kinds = [_c_type(p.strip()) for p in params.split(",")]
    assert kinds == lm_track._ARGTYPES


def test_final_pack_is_the_host_pack():
    """The kernel's pack is the track's host pack: HOST_PACK tiles
    FINAL_PACK entries, as many as the kernel's kPack."""
    at = []
    for v in se3.HOST_PACK.values():
        at += list(range(v.start, v.stop)) if isinstance(v, slice) else [v]
    assert sorted(at) == list(range(lm_track.FINAL_PACK))
    assert re.search(r"constexpr int kPack = (\d+);",
                     _source()).group(1) == str(lm_track.FINAL_PACK)


@pytest.mark.parametrize("budget", [768, 3072])
def test_point_set_fields_are_contiguous(budget):
    """make_tracking_ref's point fields are contiguous (the kernel reads
    them with no copy); its planar gather (`compact_slots`, then
    index_select of each plane) holds `compact_points`' values."""
    ref, _, _ = _lm_scene("cpu")
    for lvl in range(CFG.tracker.min_level, len(ref.pts)):
        for f in lm_track.POINT_FIELDS + ("gx", "gy"):
            assert getattr(ref.pts[lvl], f).is_contiguous(), (lvl, f)
    rng = np.random.default_rng(budget)
    valid = torch.from_numpy(rng.uniform(size=(48, 64)) < 0.4)
    planes = torch.from_numpy(rng.normal(size=(5, 48 * 64)).astype(
        np.float32))
    idx, vals, slot_valid, n_valid = compact_points(valid, planes.t(),
                                                    budget)
    got = compact_slots(valid, budget)
    assert torch.equal(got[0], idx) and torch.equal(got[1], slot_valid)
    assert torch.equal(got[2], n_valid)
    assert torch.equal(torch.index_select(planes, 1, got[0]), vals.t())


def test_track_on_cpu_takes_the_plain_route(monkeypatch):
    """CPU tensors: `track_plain` (the plain loop, then
    `final_pass_plain` once), no kernel launch, `final_fused` False."""
    def launch(*a, **k):
        raise AssertionError("lm_level launched with CPU tensors")
    calls = []
    real = se3.final_pass_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(lm_track, "lm_level", launch)
    monkeypatch.setattr(se3, "track_fused", launch)
    monkeypatch.setattr(se3, "final_pass_plain", counted)
    ref, frame, _ = _lm_scene("cpu")
    res = SE3Tracker(CAM, CFG.tracker, 16.0, True).track(
        ref, frame, torch.tensor(IDENTITY))
    assert calls == [1] and res.final_fused is False
    assert res.n_syncs > 0 and bool(res.tracking_good)


@pytest.mark.parametrize("option", [
    dict(invert=True), dict(aff=None), dict(diverged=False),
    dict(final=True)])
def test_cpu_level_refuses_the_kernels_options(option):
    """`invert`, a None affine pair, `diverged` and `final` are what the
    kernel does around its loop; the CPU's plain loop takes none of them
    (track_plain does them in torch ops) and says so."""
    ref, frame, truth = _lm_scene("cpu")
    lvl = 3
    option = dict(option)
    aff = option.pop("aff", torch.tensor(1.0))
    if "diverged" in option:
        option["diverged"] = torch.tensor(option["diverged"])
    with pytest.raises(ValueError, match="kernel's"):
        lm.level(truth, aff, None if aff is None else torch.tensor(0.0),
                 ref.pts[lvl], frame.quad[lvl], CAM.level(lvl), CFG.tracker,
                 16.0, lm.se3_schedule(CFG.tracker, 20, True), **option)


# ---------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _vo_pair(device):
    """A 640x480 keyframe (its rendered depth) and the next frame of
    `chip_smoke.py` [vo]'s orbit (its camera, scene and trajectory from
    reference_data/vo_orbit_640x480.json)."""
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.frames import build_depth_pyramid, build_frame
    from lsd_slam_tpu_torch.tracking import make_tracking_ref
    from lsd_slam_tpu_torch.utils import synth

    with open(VO_REF) as f:
        vo = json.load(f)
    cam = synth.default_camera(vo["width"], vo["height"])
    scene = synth.PlaneScene(seed=vo["scene_seed"])
    poses = synth.orbit_trajectory(vo["n_frames"], radius=vo["radius"],
                                   fwd=vo["fwd"])
    img_a, dep_a = synth.render(scene, cam, poses[0], device=device)
    img_b, _ = synth.render(scene, cam, poses[1], device=device)
    ok = dep_a > 0
    idepth = torch.where(ok, 1.0 / torch.where(ok, dep_a, 1.0), 0.0)
    ivar = torch.where(ok, torch.full_like(dep_a, 1e-3), 0.0)
    ref = make_tracking_ref(build_frame(img_a),
                            build_depth_pyramid(idepth, ivar),
                            min_level=1, with_sim3=False)
    cfg = LSDConfig(width=vo["width"], height=vo["height"])
    return cam, cfg, ref, build_frame(img_b)


def _scene(name):
    if name == "160x128":
        ref, frame, _ = _lm_scene("cuda")
        return CAM, CFG, ref, frame
    return _vo_pair("cuda")


def _on_cpu(pts):
    return dataclasses.replace(pts, **{
        f.name: getattr(pts, f.name).cpu() for f in dataclasses.fields(pts)})


def _np_inverse(g):
    """lie.se3_inverse in float32, one IEEE operation at a time (no
    contraction), as the kernel computes it."""
    f = np.float32
    g = np.asarray(g, np.float32)
    q = np.array([g[0], -g[1], -g[2], -g[3]], np.float32)
    t = g[4:7]

    def cross(a, b):
        return np.array([f(a[1] * b[2]) - f(a[2] * b[1]),
                         f(a[2] * b[0]) - f(a[0] * b[2]),
                         f(a[0] * b[1]) - f(a[1] * b[0])], np.float32)
    vxp = cross(q[1:], t)
    vvxp = cross(q[1:], vxp)
    rot = t + f(2.0) * (q[0] * vxp + vvxp)
    return np.concatenate([q, -rot]).astype(np.float32)


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _track_levels(monkeypatch):
    """Record what each `lm.level` call of a track returned."""
    outs = []
    real = lm.level

    def spy(*a, **k):
        out = real(*a, **k)
        outs.append((a, k, out))
        return out
    monkeypatch.setattr(lm, "level", spy)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["160x128", "640x480"])
def test_fused_final_pass_matches_the_plain_one(monkeypatch, scene):
    _card()
    cam, cfg, ref, frame = _scene(scene)
    outs = _track_levels(monkeypatch)
    tracker = SE3Tracker(cam, cfg.tracker, 16.0, True)
    res = tracker.track(ref, frame, torch.tensor(IDENTITY, device="cuda"))
    torch.cuda.synchronize()
    assert res.final_fused and res.n_syncs == 0
    assert len(outs) == cfg.tracker.max_level - cfg.tracker.min_level + 1
    assert [k["final"] for _, k, _ in outs] == [False] * (len(outs) - 1) + [
        True]
    last = outs[-1][2]
    fin = last.final
    assert not bool(res.diverged) and bool(res.tracking_good)

    lvl = cfg.tracker.min_level
    caml = cam.level(lvl)
    pts = _on_cpu(ref.pts[lvl])
    stats, err, grid = se3.final_pass_plain(
        last.pose.cpu(), last.aff_a.cpu(), last.aff_b.cpu(), pts,
        frame.quad[lvl].cpu(), caml, cfg.tracker, 16.0)
    # the good mask bit for bit, the counts exactly
    assert res.good_mask.shape == (caml.height, caml.width)
    assert torch.equal(res.good_mask.cpu(),
                       grid.reshape(caml.height, caml.width))
    counts = fin.counts.cpu().tolist()
    assert counts == [int(stats["in_count"]), int(stats["good_count"]),
                      int(stats["bad_count"])]
    assert int(res.good_count) == counts[1] and int(res.bad_count) == counts[2]
    # the final error and the usage within 1e-6 relative
    pk = {k: res.host_pack.cpu()[v] for k, v in HP.items()}
    usage = stats["usage"] / torch.clamp_min(pts.n_valid, 1.0)
    np.testing.assert_allclose(float(pk["last_residual"]), float(err),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pk["point_usage"]), float(usage),
                               rtol=1e-6)

    # the rest of the pack as the torch tail derives it from those
    good = torch.tensor(float(counts[1]))
    bad = torch.tensor(float(counts[2]))
    n_pix = caml.width * caml.height
    tracking_good = ((good / n_pix > cfg.tracker.min_goodperall_pixel)
                     & (good / torch.clamp_min(good + bad, 1.0)
                        > cfg.tracker.min_goodpergoodbad_pixel))
    initial = pk["last_residual"] / torch.clamp_min(pk["point_usage"], 1e-6)
    pose, inv = pk["ref_to_frame"], pk["frame_to_ref"]
    assert torch.equal(_bits(pose), _bits(last.pose))
    assert np.array_equal(inv.numpy().view(np.int32),
                          _np_inverse(pose.numpy()).view(np.int32))
    np.testing.assert_allclose(inv.numpy(), lie.se3_inverse(pose).numpy(),
                               rtol=0, atol=1e-6)
    assert float(pk["diverged"]) == 0.0
    assert float(pk["tracking_good"]) == float(tracking_good) == 1.0
    assert bool(res.tracking_good) == bool(tracking_good)
    assert float(pk["good_count"]) == float(good)
    assert float(pk["bad_count"]) == float(bad)
    assert torch.equal(_bits(pk["affine_a"]), _bits(last.aff_a))
    assert torch.equal(_bits(pk["affine_b"]), _bits(last.aff_b))
    assert torch.equal(_bits(pk["initial_residual"]), _bits(initial))
    # the views: frame_to_ref and the scalars read the pack
    assert torch.equal(_bits(res.frame_to_ref), _bits(inv))
    assert torch.equal(_bits(res.initial_residual),
                       _bits(pk["initial_residual"]))

    # every cluster size gives the final pass's bits
    a, k, _ = outs[-1]
    sched = dataclasses.asdict(a[8])
    fields = tuple(getattr(a[3], f) for f in lm_track.POINT_FIELDS)
    most = lm_track.max_cluster(torch.device("cuda"))
    runs = [lm_track.lm_level(a[0], a[1], a[2], fields, a[4], a[5], a[6],
                              a[7], sched, cluster=c,
                              diverged=k["diverged"],
                              final_n_valid=a[3].n_valid)
            for c in (1, most)]
    torch.cuda.synchronize()
    for run in runs:
        for x, y in zip(run[7], fin):
            assert torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
def test_diverged_is_the_or_of_the_levels():
    """A level's flag ORs the previous levels' in, a diverged level
    among them: a level that holds after one that diverged reports
    diverged, and its final pass writes the identity pose, diverged 1 and
    tracking_good 0; a whole track from a far pose diverges."""
    _card()
    ref, frame, truth = _lm_scene("cuda")
    lvl = 2
    pts = ref.pts[lvl]
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)
    sched = dataclasses.asdict(lm.se3_schedule(CFG.tracker, 20, True))
    far = truth.clone()
    far[4] += 100.0

    def launch(pose, diverged=None, final=False):
        return lm_track.lm_level(
            pose, None, None, fields, frame.quad[lvl], CAM.level(lvl),
            CFG.tracker, 16.0, sched, diverged=diverged,
            final_n_valid=pts.n_valid if final else None)
    lost = launch(far)
    held = launch(truth, diverged=torch.zeros((), dtype=torch.bool,
                                              device="cuda"))
    after = launch(truth, diverged=lost[4], final=True)
    alone = launch(truth, final=True)
    torch.cuda.synchronize()
    assert bool(lost[4]) and not bool(held[4])
    assert bool(after[4]) and not bool(alone[4])
    # the loop itself does not see the flag given: the same bits
    for x, y in zip(after[:4], alone[:4]):
        assert torch.equal(_bits(x), _bits(y))
    pack = after[7].pack.cpu()
    assert pack[HP["ref_to_frame"]].tolist() == IDENTITY
    assert float(pack[HP["diverged"]]) == 1.0
    assert float(pack[HP["tracking_good"]]) == 0.0
    assert not bool(after[7].tracking_good)
    assert float(alone[7].pack[HP["diverged"]]) == 0.0
    res = SE3Tracker(CAM, CFG.tracker, 16.0, True).track(
        ref, frame, lie.se3_inverse(far))
    assert bool(res.diverged) and not bool(res.tracking_good)
    assert res.host_pack[HP["ref_to_frame"]].tolist() == IDENTITY


@pytest.mark.cuda
def test_one_track_launches_at_most_eight_kernels():
    """torch.profiler on one track (after a first one): at most 8 kernels
    on the card, four of them `lm_level`; the plain route (the kernels
    and the torch tail) launches many more."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cam, cfg, ref, frame = _vo_pair("cuda")
    tracker = SE3Tracker(cam, cfg.tracker, 16.0, True)
    init = torch.tensor(IDENTITY, device="cuda")

    def kernels(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
    fused = kernels(lambda: tracker.track(ref, frame, init))
    plain = kernels(lambda: se3.track_plain(cam, cfg.tracker, 16.0, True,
                                            ref, frame, init))
    levels = cfg.tracker.max_level - cfg.tracker.min_level + 1
    assert sum("lm_level_kernel" in n for n in fused) == levels, fused
    assert len(fused) <= 8, fused
    assert len(plain) > 4 * len(fused), (len(plain), len(fused))


@pytest.mark.cuda
def test_quick_launch_writes_no_final_and_keeps_its_bits():
    """The quick tracker's launches pass no final outputs (the launch
    returns its seven tensors, no final launch is counted) and give the
    bits of the same launch with a final pass after its loop: the
    epilogue leaves the loop alone."""
    _card()
    from lsd_slam_tpu_torch.tracking.quick_tracker import (QuickTracker,
                                                           stack_points)

    ref, frame, truth = _lm_scene("cuda")
    quick = QuickTracker(CAM, CFG.tracker, 16.0)
    level = quick.level
    moves = torch.tensor([[0.01, -0.01, 0.005, 0.004, -0.003, 0.002],
                          [0, 0, 0, 0, 0, 0],
                          [-0.02, 0.015, -0.01, -0.006, 0.005, -0.003],
                          [0.004, 0.002, -0.001, 0.001, 0.0, -0.002]],
                         device="cuda")
    inits = lie.se3_mul(lie.se3_exp(moves), truth.expand(4, 7))
    pts = stack_points([ref.pts[level]] * 4)
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)
    sched = dataclasses.asdict(lm.quick_schedule(CFG.tracker))
    args = (inits, 1.0, 0.0, fields, frame.quad[level], CAM.level(level),
            CFG.tracker, 16.0, sched)
    before = lm_track.FINAL_LAUNCHES
    res = quick.track_batch_pts(pts, frame.quad[level], inits)
    plain = lm_track.lm_level(*args)
    with_final = lm_track.lm_level(*args, final_n_valid=pts.n_valid)
    torch.cuda.synchronize()
    assert lm_track.FINAL_LAUNCHES - before == 1  # with_final's alone
    assert len(plain) == 7 and len(with_final) == 8
    for x, y in zip(plain, with_final[:7]):
        assert torch.equal(_bits(x), _bits(y))
    assert torch.equal(_bits(res.ref_to_frame), _bits(plain[0]))
