"""The LM level kernel's launch shape (`lsd_slam_tpu_torch/ops/lm_track.py`,
`csrc/lm_track.cu`): one thread-block cluster of C blocks per lane.

On the CPU: the wrapper's choice of C and its sum-tree layout, pure
functions of the lane count, the point count and the card (stubbed here);
the C struct of the launch constants against its ctypes mirror; and a
specification of the kernel's fold order, written here in Python with the
kernel's constants, showing that the scheme sums the chunk totals along
one tree at every power-of-two C. That test checks the scheme, not the
kernel's code: what guards the kernel are the card's checks (marked
`cuda`, skipped here: two cluster sizes give the same bits on a 160x128
scene; and chip_smoke.py [lm], every C on the main path's inputs). This file
imports no JAX, so the card runs it with `--noconftest`."""

import ctypes
import functools
import operator
import os
import re

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.ops import lm_track

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lsd_slam_tpu_torch", "csrc", "lm_track.cu")
# the point counts of [vo]'s four levels at 640x480 (levels 4 to 1)
VO_LEVEL_POINTS = (1200, 4800, 12544, 38400)
H100_SMS = 132


def _is_pow2(x):
    return x >= 1 and x & (x - 1) == 0


@pytest.mark.parametrize("lanes", [1, 64])
@pytest.mark.parametrize("n_points", VO_LEVEL_POINTS)
@pytest.mark.parametrize("most", [16, 8, 2, 1])
def test_cluster_choice(lanes, n_points, most):
    """C is a power of two, never above the card's largest cluster or the
    chunk count, and every lane's cluster fits on the card at once."""
    c = lm_track.choose_cluster(lanes, n_points, H100_SMS, most)
    assert _is_pow2(c) and c <= most and lanes * c <= H100_SMS
    leaves, _ = lm_track.tree_layout(n_points)
    assert c <= leaves  # a chunk a block at least
    # the largest such C: doubling it breaks one of the limits
    assert 2 * c > most or lanes * 2 * c > H100_SMS or 2 * c > leaves


def test_cluster_choice_on_the_main_path():
    """One SE(3) lane spreads every [vo] level over 16 blocks on an H100;
    a 64-lane quick batch takes 2 blocks a lane (128 of 132 SMs)."""
    assert [lm_track.choose_cluster(1, n, H100_SMS, 16)
            for n in VO_LEVEL_POINTS] == [16, 16, 16, 16]
    assert [lm_track.choose_cluster(64, n, H100_SMS, 16)
            for n in VO_LEVEL_POINTS] == [2, 2, 2, 2]
    # a card that schedules clusters of 8 at most, and a small one
    assert lm_track.choose_cluster(1, 38400, H100_SMS, 8) == 8
    assert lm_track.choose_cluster(1, 38400, 4, 16) == 4
    assert lm_track.choose_cluster(4, 1200, 4, 16) == 1
    # a few points: no more blocks than chunks
    assert lm_track.choose_cluster(1, 64, H100_SMS, 16) == 2


@pytest.mark.parametrize("n_points", [0, 1, 31, 32, 33, 300, 1200, 4800,
                                      12544, 38400, 153600])
def test_tree_layout(n_points):
    """The chunks cover the points: a power of two of them, at most
    LEAF_CAP, of at most CHUNK_TARGET points until the cap binds."""
    leaves, chunk = lm_track.tree_layout(n_points)
    assert _is_pow2(leaves) and leaves <= lm_track.LEAF_CAP
    assert leaves * chunk >= n_points and chunk >= 1
    if leaves < lm_track.LEAF_CAP:
        assert chunk <= lm_track.CHUNK_TARGET
    for c in (1, 2, 4, 8, 16):
        chunk_c, leaves_c, staged, smem = lm_track.launch_layout(n_points, c)
        assert chunk_c == chunk and leaves_c == max(leaves, c)
        share = min(leaves_c // c * chunk, n_points)
        assert staged == min(share, lm_track.STAGE_CAP)
        # the warps' tiles and the staged fields, within the 227 KB a block
        # may have beside its ~11 KB of static shared memory
        assert lm_track.TILE_BYTES <= smem <= 216 * 1024 and smem % 16 == 0


def _c_struct_fields():
    src = open(SOURCE).read()
    body = re.search(r"struct LsdLmParams \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(long long|int|float) (.+);", line)
        assert m, line
        fields += [(m.group(1), name.strip()) for name in m.group(2).split(",")]
    return fields


def test_params_struct_matches_its_ctypes_mirror():
    """`struct LsdLmParams` in csrc/lm_track.cu and `ops.lm_track.Params`
    list the same fields with the same types in the same order (the kernel
    takes the struct by value from a pointer to the ctypes one)."""
    ctype = {"long long": torch.int64, "int": torch.int32,
             "float": torch.float32}
    mirror = {ctypes.c_longlong: torch.int64, ctypes.c_int: torch.int32,
              ctypes.c_float: torch.float32}
    got = [(name, mirror[t]) for name, t in lm_track.Params._fields_]
    want = [(name, ctype[t]) for t, name in _c_struct_fields()]
    assert got == want


def _kernel_constants():
    src = open(SOURCE).read()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", src)}


def test_tile_bytes_match_the_kernel():
    """The wrapper sizes each block's dynamic shared memory from
    TILE_BYTES: one tile of 32 rows of kSums f32 terms per warp."""
    const = _kernel_constants()
    warps = int(const["kThreads"]) // 32
    assert lm_track.TILE_BYTES == warps * 32 * int(const["kSums"]) * 4


def _balanced(xs):
    xs = list(xs)
    while len(xs) > 1:
        xs = [xs[i] + xs[i + 1] for i in range(0, len(xs), 2)]
    return xs[0]


def _kernel_fold(leaf_sums, c, warps, top):
    """A specification, in Python, of the order in which csrc/lm_track.cu
    folds a column's chunk totals at cluster size c (its header's "sums"
    note): leaves padded with zeros to max(T, c); block r folds its aligned
    range in groups of `warps` (a tree per group, the group roots merged as
    a binary counter merges); the leader folds the block roots along a
    `top`-leaf tree padded with zeros. It is not read from the kernel's
    code: a change there shows on the card, not here."""
    t = max(len(leaf_sums), c)
    leaves = list(leaf_sums) + [0.0] * (t - len(leaf_sums))
    per_block = t // c
    group = min(per_block, warps)
    roots = []
    for r in range(c):
        stack = []
        for gi in range(per_block // group):
            vals = leaves[r * per_block + gi * group:][:group]
            s = 1
            while s < group:
                for i in range(0, group, 2 * s):
                    vals[i] = vals[i] + vals[i + s]
                s *= 2
            root = vals[0]
            sp = bin(gi).count("1")
            merges = ((gi + 1) & -(gi + 1)).bit_length() - 1
            for m in range(1, merges + 1):
                root = stack[sp - m] + root
            stack = stack[:sp - merges] + [root]
        assert len(stack) == 1
        roots.append(stack[0])
    return _balanced(roots + [0.0] * (top - c))


@pytest.mark.parametrize("leaves", [1, 2, 8, 64, 256, 1024])
def test_every_cluster_size_folds_one_tree(leaves):
    """The specified fold order (`_kernel_fold`, with the kernel's warp
    count and largest cluster) at every power-of-two cluster size is the
    balanced tree over the chunk totals, bit for bit, so the scheme's sums
    do not depend on C (mixed signs and magnitudes, where order shows)."""
    const = _kernel_constants()
    warps = int(const["kThreads"]) // 32
    top = int(const["kMaxCluster"])
    rng = np.random.default_rng(leaves)
    sums = (rng.standard_normal(leaves)
            * 10.0 ** rng.integers(-8, 8, leaves)).tolist()
    want = _balanced(sums)
    c = 1
    while c <= top:
        assert _kernel_fold(sums, c, warps, top) == want, c
        c *= 2
    # a left-to-right sum lands elsewhere: these sums show the order
    if leaves >= 64:
        assert functools.reduce(operator.add, sums) != want


def test_stamp_slots():
    """3 stamps a pass for the first pass and every trial, and the end."""
    assert lm_track.stamp_slots({"max_trials": 10}) == 34


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_cluster_sizes_give_the_same_bits():
    """An SE(3) level of the 160x128 scene and a 4-lane quick batch on it,
    launched at C = 1 and at the card's largest C (and at the chosen one):
    the same bits in every output."""
    _card()
    from dataclasses import asdict

    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.tracking import lm
    from lsd_slam_tpu_torch.tracking.quick_tracker import stack_points

    from test_torch_rules import CAM, CFG, _lm_scene

    ref, frame, truth = _lm_scene("cuda")
    most = lm_track.max_cluster(truth.device)
    assert most >= 2
    level = 1
    pts = ref.pts[level]
    fields = tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS)
    moves = torch.tensor([[0.01, -0.01, 0.005, 0.004, -0.003, 0.002],
                          [0, 0, 0, 0, 0, 0],
                          [-0.02, 0.015, -0.01, -0.006, 0.005, -0.003],
                          [0.004, 0.002, -0.001, 0.001, 0.0, -0.002]],
                         device="cuda")
    inits = lie.se3_mul(lie.se3_exp(moves), truth.expand(4, 7))
    cases = [
        (lie.se3_identity().cuda(), torch.tensor(1.0, device="cuda"),
         torch.tensor(0.0, device="cuda"), fields, lm.se3_schedule(
             CFG.tracker, 20, True)),
        (inits, 1.0, 0.0, tuple(getattr(stack_points([pts] * 4), f)
                                for f in lm_track.POINT_FIELDS),
         lm.quick_schedule(CFG.tracker))]
    for pose, a, b, flds, sched in cases:
        outs = [lm_track.lm_level(pose, a, b, flds, frame.quad[level],
                                  CAM.level(level), CFG.tracker, 16.0,
                                  asdict(sched), cluster=c)
                for c in (1, most, None)]
        torch.cuda.synchronize()
        for out in outs[1:]:
            for x, y in zip(out, outs[0]):
                if x.is_floating_point():
                    x, y = x.view(torch.int32), y.view(torch.int32)
                assert torch.equal(x, y)
    with pytest.raises(ValueError, match="power of two"):
        lm_track.lm_level(*cases[0][:4], frame.quad[level], CAM.level(level),
                          CFG.tracker, 16.0, asdict(cases[0][4]), cluster=3)


@pytest.mark.cuda
def test_stamps_follow_the_passes():
    """The stamp buffer holds non-decreasing clocks over the passes a
    launch ran (3 a pass), and the end after the last."""
    _card()
    from dataclasses import asdict

    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.tracking import lm

    from test_torch_rules import CAM, CFG, _lm_scene

    ref, frame, _ = _lm_scene("cuda")
    pts = ref.pts[2]
    sched = asdict(lm.se3_schedule(CFG.tracker, 20, True))
    stamps = torch.zeros(lm_track.stamp_slots(sched), dtype=torch.int64,
                         device="cuda")
    out = lm_track.lm_level(
        lie.se3_identity().cuda(), 1.0, 0.0,
        tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS),
        frame.quad[2], CAM.level(2), CFG.tracker, 16.0, sched,
        stamps=stamps)
    passes = int(out[5]) + 1
    st = stamps.cpu().numpy()
    seq = np.concatenate([st[:3 * passes], st[-1:]])
    assert (seq > 0).all() and (np.diff(seq) >= 0).all()


def _sim3_scene(device):
    """`_lm_scene`'s keyframe with its Sim(3) layouts, as a reference and
    as a frame (a pair of keyframes, as the constraint search tracks)."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.frames import build_depth_pyramid, build_frame
    from lsd_slam_tpu_torch.tracking import make_tracking_ref
    from lsd_slam_tpu_torch.utils import synth

    from test_torch_rules import CAM

    scene = synth.PlaneScene(seed=5)
    refs = []
    for tan in ([0, 0, 0, 0, 0, 0], [0.02, -0.012, 0.015, 0.006, -0.01,
                                      0.004]):
        pose = lie.se3_exp(torch.tensor(tan, dtype=torch.float32))
        img, dep = synth.render(scene, CAM, pose, device=device)
        ok = dep > 0
        idepth = torch.where(ok, 1.0 / torch.where(ok, dep, 1.0), 0.0)
        ivar = torch.where(ok, torch.full_like(dep, 1e-3), 0.0)
        refs.append(make_tracking_ref(build_frame(img),
                                      build_depth_pyramid(idepth, ivar),
                                      min_level=1))
    return refs


@pytest.mark.cuda
def test_sim3_track_on_the_card_launches_its_kernel(monkeypatch):
    """A 4-lane Sim(3) batch on CUDA tensors (the pair, twice, and a zero
    padding set) launches `sim3_level` once per level, the final pass
    inside the last level's launch, never the plain loop, pulls nothing
    (n_syncs 0); both directions of a stage together launch once per
    level too, each with the bits of its own call; each level's launch at
    C = 1, at the card's largest C and at the chosen one gives the same
    bits, and its fused final pass the bits of the final pass launched on
    its own at the level's result."""
    _card()
    from lsd_slam_tpu_torch.config import TrackerConfig
    from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

    from test_torch_rules import CAM

    ref, frame = _sim3_scene("cuda")
    zero = st3.TrackingRef(
        pts=tuple(None if p is None else type(p)(**{
            f: torch.zeros_like(getattr(p, f))
            for f in st3._POINT_FIELDS + ("n_valid",)}) for p in ref.pts),
        sim3_quad=ref.sim3_quad)
    levels = (3, 2)
    stacked = st3.stack_refs([ref, ref, ref, zero], levels)
    calls = []
    real = st3.levels

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    def plain(*a, **k):
        raise AssertionError("plain Sim(3) loop reached with CUDA tensors")

    monkeypatch.setattr(st3, "levels", spy)
    monkeypatch.setattr(st3, "level_plain", plain)
    monkeypatch.setattr(st3, "final_pass_plain", plain)
    tracker = st3.Sim3Tracker(CAM, TrackerConfig(), sigma2=16.0)
    before = lm_track.SIM3_LAUNCHES
    inits = torch.tensor([[1, 0, 0, 0, 0, 0, 0, 1]] * 4, dtype=torch.float32)
    res = tracker.track_batch(stacked, frame, inits, *levels)
    torch.cuda.synchronize()
    assert lm_track.SIM3_LAUNCHES - before == 2 and res.n_syncs == 0
    assert res.diverged.tolist() == [False, False, False, True]
    one_ba, _ = tracker.track_batch_frames_packed(frame, stacked, inits,
                                                  *levels)
    one_ab, _ = tracker.track_batch_packed(stacked, frame, inits, *levels)
    before = lm_track.SIM3_LAUNCHES
    pk_ba, pk_ab, syncs = tracker.track_pair_packed(frame, stacked, inits,
                                                    inits, *levels)
    torch.cuda.synchronize()
    assert lm_track.SIM3_LAUNCHES - before == 2 and syncs == 0
    for x, y in ((pk_ba, one_ba), (pk_ab, one_ab)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    most = lm_track.max_cluster(torch.device("cuda"), sim3=True)
    for (tracks, cam, cfg, sigma2, min_pts, max_its), _ in calls:
        pose, aa, ab, sets = st3.lane_table(tracks)
        outs = [lm_track.sim3_level(pose, aa, ab, sets, cam, cfg, sigma2,
                                    min_pts, max_its,
                                    max_its + 4 * cfg.max_lm_rejects,
                                    final=True, cluster=c)
                for c in (1, most, None)]
        alone = lm_track.sim3_level(outs[0][0], outs[0][1], outs[0][2], sets,
                                    cam, cfg, sigma2, 0.0, 0, 0, final=True)
        torch.cuda.synchronize()
        for out in outs[1:]:
            for x, y in zip(out, outs[0]):
                if x.is_floating_point():
                    x, y = x.view(torch.int32), y.view(torch.int32)
                assert torch.equal(x, y)
        assert torch.equal(alone[7].view(torch.int32),
                           outs[0][7].view(torch.int32))