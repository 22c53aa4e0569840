"""The Sim(3) tracker's level loop (lsd_slam_tpu_torch/tracking/sim3_tracker.py
`levels`, `level`, `final_pass`) against the JAX `_sim3_impl` it ports,
on the keyframe pair of tests/test_torch_sim3.py (PlaneScene(seed=11),
160x128, ground-truth depth; its module-scoped fixtures), and the launch
shape of its kernel `sim3_level` (ops/lm_track.py, csrc/sim3_track.cu).

* `_sim3_impl` runs every level through `levels` and the final pass at
  the last level's result; for each constraint stage and both batch
  directions it meets JAX at tests/test_torch_sim3.py's bounds (poses
  2e-4, residuals and usage 1e-3 relative, the Hessian 1e-3 of its
  largest entry, the diverged flag equal);
* the pair call (`track_pair_packed`, both directions of a stage
  together, as the constraint search runs them) gives each direction's
  pack of its own call bit for bit; the final values a level returns are
  `final_pass_plain`'s at its result, bit for bit;
* each lane of a batched `level_plain` gives the bits of the same lane
  run alone; a zero (padding) point set diverges on its first pass;
* CPU tensors take the plain versions, the wrapper refuses any device but
  CUDA, and the kernel's constants are the f32 values torch uses;
* a Python specification of the kernel's summation order over its 45
  columns gives the same bits at every cluster size; the cluster choice
  keeps every cluster of a launch resident by the card's table of active
  clusters.

On the card `levels` launches `sim3_level`; that it meets the plain loop
there is `chip_smoke.py`'s `[lm]` (its Sim(3) cases) and the `cuda`-marked
test of tests/test_torch_lm_cluster.py.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from lsd_slam_tpu.tracking.sim3_tracker import SIM3_PACK as SP

from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.ops import lm_track
from lsd_slam_tpu_torch.tracking import sim3_tracker as st3

from test_torch_lm_cluster import _balanced, _kernel_fold
from test_torch_sim3 import (LEVELS, _assert_pack_close, chain, pair,  # noqa: F401
                             port_ref, sim3)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lsd_slam_tpu_torch", "csrc", "sim3_track.cu")
SIGMA2 = 16.0
FIELDS = ("pose", "aff_a", "aff_b", "last_err", "diverged", "trials", "its")


@pytest.fixture(scope="module")
def stacked(pair, chain):
    """The chain's four-lane stack ([a, c13, a, zero]) and reference b as
    port values, and the port's tracker constants."""
    _, tcam, refs, _ = pair
    jstack, runs = chain
    return tcam, port_ref(jstack), port_ref(refs["b"][2]), runs


def _level_args(tcam, ref, frame, pose, lvl, cfg=TrackerConfig()):
    """`level`'s arguments at `lvl` as `_sim3_impl` builds them."""
    caml = tcam.level(lvl)
    stride = 2 if lvl <= 2 else 1
    min_pts = max(0.5 * cfg.min_goodperall_pixel_absmin * caml.height
                  * caml.width / stride, 10.0)
    b = pose.shape[0]
    return (pose, torch.ones(b), torch.zeros(b),
            st3._strided(ref.pts[lvl], stride), frame.sim3_quad[lvl], caml,
            cfg, SIGMA2, min_pts, cfg.max_iterations[lvl])


@pytest.mark.parametrize("direction", ["refs", "frames"])
@pytest.mark.parametrize("levels", LEVELS)
def test_impl_runs_level_and_final_pass_as_jax(stacked, levels, direction,
                                                monkeypatch):
    """One constraint stage in one direction: `_sim3_impl` calls `levels`
    once per level, coarse to fine, the last one with the final pass,
    which on the CPU is `final_pass_plain` at the final level's result,
    and its pack meets JAX's `_sim3_impl` on every live lane."""
    tcam, tstack, tref_b, runs = stacked
    i_refs, w_refs, i_frames, w_frames = runs[levels]
    seen = []
    real_levels, real_final = st3.levels, st3.final_pass_plain

    def levels_seen(tracks, cam, *a, **k):
        seen.append(("level", cam.width))
        return real_levels(tracks, cam, *a, **k)

    def final(*a, **k):
        seen.append(("final", a[5].width))
        return real_final(*a, **k)

    monkeypatch.setattr(st3, "levels", levels_seen)
    monkeypatch.setattr(st3, "final_pass_plain", final)
    ts = st3.Sim3Tracker(tcam, TrackerConfig(), sigma2=SIGMA2)
    if direction == "refs":
        got, syncs = ts.track_batch_packed(tstack, tref_b, i_refs, *levels)
        want, live = w_refs, 4
    else:
        got, syncs = ts.track_batch_frames_packed(tref_b, tstack, i_frames,
                                                  *levels)
        want, live = w_frames, 3   # the zero layout's lane is not compared
    start, final_level = levels
    assert seen == [("level", tcam.width >> lvl)
                    for lvl in range(start, final_level - 1, -1)] + [
        ("final", tcam.width >> final_level)]
    assert syncs > 0                       # the plain loop's flag reads
    got = got.numpy().astype(np.float64)
    for i in range(live):
        _assert_pack_close(got[i], want[i])
    if direction == "refs":
        assert got[3, SP["diverged"]] == 1


def _same_bits(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f
        else:
            assert torch.equal(x, y), f


def _lane(r, i):
    return st3.LevelResult(*(getattr(r, f)[i:i + 1] for f in FIELDS))


@pytest.mark.parametrize("lvl", [4, 2])
def test_each_lane_equals_the_lane_alone(stacked, lvl):
    """A lane that is done keeps its state while the batch runs on, so
    each lane of the four-lane stack ([a, c13, a, zero] against b, from
    disturbed inits) gives the bits of the same lane run alone, that is in
    a batch of four copies of it (the batch's shapes, so torch reduces
    every lane in the same order). The kernel relies on this: its lanes
    never wait on one another."""
    tcam, tstack, tref_b, _ = stacked
    rng = np.random.default_rng(3)
    tan = rng.normal(0, [0.01] * 3 + [0.005] * 3 + [0.01], (4, 7))
    inits = st3.lie.sim3_exp(torch.tensor(tan, dtype=torch.float32))
    args = _level_args(tcam, tstack, tref_b, inits, lvl)
    batch = st3.level_plain(*args)
    assert len(set(batch.trials.tolist())) > 1       # lanes stop apart
    full = tstack.pts[lvl]
    for i in range(4):
        copies = type(full)(**{f: getattr(full, f)[i:i + 1].expand(
            (4,) + getattr(full, f).shape[1:]).contiguous()
            for f in st3._POINT_FIELDS + ("n_valid",)})
        alone = st3.level_plain(
            inits[i:i + 1].repeat(4, 1), args[1], args[2],
            st3._strided(copies, 2 if lvl <= 2 else 1), *args[4:])
        _same_bits(_lane(batch, i), _lane(alone, 0))


def test_zero_lane_diverges_on_its_first_pass(stacked):
    """A padding lane (zero point set) has no point in the image: its
    level diverges on the first pass, runs no trial and keeps its pose."""
    tcam, tstack, tref_b, _ = stacked
    pose = st3.lie.sim3_identity((4,))
    r = st3.level_plain(*_level_args(tcam, tstack, tref_b, pose, 3))
    assert r.diverged.tolist()[3] and int(r.trials[3]) == 0
    assert int(r.its[3]) == 0 and torch.equal(r.pose[3], pose[3])
    assert not r.diverged[0]


def test_cpu_tensors_take_the_plain_version(stacked, monkeypatch):
    """On CPU tensors `level` and `final_pass` run the plain versions and
    never reach the kernel's wrapper."""
    tcam, tstack, tref_b, _ = stacked

    def no_kernel(*a, **k):
        raise AssertionError("kernel wrapper reached with CPU tensors")

    monkeypatch.setattr(lm_track, "sim3_level", no_kernel)
    args = _level_args(tcam, tstack, tref_b, st3.lie.sim3_identity((4,)), 3)
    _same_bits(st3.level(*args), st3.level_plain(*args))
    got = st3.final_pass(*args[:8])
    want = st3.final_pass_plain(*args[:8])
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    pair = st3.levels([args[:5], args[:5]], *args[5:])
    for r in pair:
        _same_bits(r, st3.level_plain(*args))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refuses_other_devices(stacked, device):
    """The wrapper launches the kernel or raises: it computes on no tensor
    off the card, whatever its device; `level` sends every non-CPU tensor
    to it, so a meta tensor raises there too."""
    tcam, tstack, tref_b, _ = stacked
    args = _level_args(tcam, tstack, tref_b,
                       torch.zeros(4, 8, device=device), 3)
    pts = args[3]
    with pytest.raises(ValueError, match="unsupported device"):
        lm_track.sim3_level(
            args[0], args[1], args[2],
            [([getattr(pts, f) for f in lm_track.SIM3_POINT_FIELDS],
              args[4], 4)], args[5], args[6], SIGMA2, args[8], args[9],
            args[9] + 4)
    if device == "meta":
        with pytest.raises(ValueError, match="unsupported device"):
            st3.level(*args)


def test_params_round_like_the_plain_version(pair):
    """Every float constant the kernel gets is the f32 that torch uses for
    the same Python constant in the plain version's ops."""
    _, tcam, _, _ = pair
    cfg = TrackerConfig()
    caml = tcam.level(2)
    min_pts = 0.5 * cfg.min_goodperall_pixel_absmin * caml.height \
        * caml.width / 2
    prm = lm_track.make_sim3_params(
        caml, cfg, SIGMA2, min_pts, 50, 70, 100, 1280,
        [lm_track.Sim3Set(pts_stride=200, pts_step=2, quad_stride=0,
                          lanes=4),
         lm_track.Sim3Set(pts_stride=0, pts_step=2, quad_stride=25600,
                          lanes=4)])
    t = torch.tensor([3.0])
    for name, value in (("cx", caml.cx), ("fy", caml.fy),
                        ("u_hi", caml.width - 1.001),
                        ("fx_half", caml.fx * 0.5),
                        ("var_weight", cfg.var_weight),
                        ("huber_d", cfg.huber_d), ("min_points", min_pts),
                        ("conv_eps", cfg.convergence_eps),
                        ("step_min", cfg.step_size_min),
                        ("lam0", cfg.lambda_initial),
                        ("success_fac", cfg.lambda_success_fac),
                        ("fail_fac", cfg.lambda_fail_fac)):
        assert getattr(prm, name) == float(torch.tensor(value)), name
        # the rounding a torch op gives the Python scalar
        assert float(t * value) == float(t * getattr(prm, name)), name
    assert [(t.pts_stride, t.pts_step, t.quad_stride, t.lanes)
            for t in prm.sets] == [(200, 2, 0, 4), (0, 2, 25600, 4)]
    assert (prm.max_its, prm.max_trials, prm.use_esm) == (
        50, 70, int(cfg.use_esm_sim3))
    chunk, leaves, staged, _ = lm_track.launch_layout(100, 1, sim3=True)
    assert (prm.chunk, prm.leaves, prm.staged) == (chunk, leaves, staged)


def _c_struct_fields(name="LsdSim3Params"):
    """(type, name) of each field of `struct name` in the kernel's source;
    a pointer's type is "pointer", an array's "type[n]"."""
    src = open(SOURCE).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"const \w+\* (\w+);", line)
        if m:
            fields.append(("pointer", m.group(1)))
            continue
        m = re.fullmatch(r"(\w+) (\w+)\[(\d+)\];", line)
        if m:
            fields.append((f"{m.group(1)}[{m.group(3)}]", m.group(2)))
            continue
        m = re.fullmatch(r"(long long|int|float) (.+);", line)
        assert m, line
        fields += [(m.group(1), n.strip()) for n in m.group(2).split(",")]
    return fields


def _kernel_constants():
    src = open(SOURCE).read()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", src)}


def test_params_struct_and_sizes_match_the_kernel():
    """`struct LsdSim3Params` and its lane table `struct LsdSim3Set` in
    csrc/sim3_track.cu and `ops.lm_track.Sim3Params` / `Sim3Set` list the
    same fields with the same types in the same order; the wrapper's tile
    bytes, staged bytes a point and final-pass width are the kernel's."""
    ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float, "pointer": ctypes.c_void_p,
             f"LsdSim3Set[{lm_track.SIM3_SETS}]":
             lm_track.Sim3Set * lm_track.SIM3_SETS}
    for struct, cls in (("LsdSim3Set", lm_track.Sim3Set),
                        ("LsdSim3Params", lm_track.Sim3Params)):
        want = [(name, ctype[t]) for t, name in _c_struct_fields(struct)]
        got = [(n, t) for n, t in cls._fields_]
        assert [n for n, _ in got] == [n for n, _ in want], struct
        for (n, t), (_, w) in zip(got, want):
            assert t == w or (ctypes.sizeof(t) == ctypes.sizeof(w)
                              and t._type_ == w._type_
                              and t._length_ == w._length_), (struct, n)
    const = _kernel_constants()
    warps = int(const["kThreads"]) // 32
    assert lm_track.SIM3_TILE_BYTES == warps * 32 * int(const["kSums"]) * 4
    assert lm_track.SIM3_STAGE_POINT_BYTES == 4 * int(const["kStaged"]) + 1
    assert lm_track.SIM3_FINAL == 4 + 49 and const["kFinal"] == "4 + 49"


# tables of active clusters (C -> clusters the card holds at once): every
# SM free; seven GPCs that hold a cluster of 16
ACTIVE = {"all": {1: 132, 2: 66, 4: 33, 8: 16, 16: 8},
          "seven": {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}}


@pytest.mark.parametrize("active", sorted(ACTIVE))
@pytest.mark.parametrize("lanes", [1, 4, 8, 16])
@pytest.mark.parametrize("n_points", [300, 1200, 6272, 19200])
def test_cluster_choice_and_layout(lanes, n_points, active):
    """A launch's lanes (a stage's two directions, up to 32 padded) take
    the largest power-of-two C whose clusters the card holds all at once
    (its table of active clusters at the launch's shared memory; within
    the 132 SMs): 8 lanes take 16 where the card holds 8 clusters of 16
    and 8 where it holds 7; each block stages its share, within the shared
    memory a block has."""
    table = ACTIVE[active]
    c = lm_track.choose_cluster(lanes, n_points, 132, 16, table.get)
    leaves = lm_track.tree_layout(n_points)[0]
    assert lanes * c <= 132 and (table[c] >= lanes or c == 1)
    assert (2 * c > 16 or lanes * 2 * c > 132 or 2 * c > leaves
            or table[2 * c] < lanes)
    if lanes == 8 and n_points >= 6272:
        assert c == (16 if active == "all" else 8)
    chunk, leaves, staged, smem = lm_track.launch_layout(n_points, c,
                                                         sim3=True)
    assert staged == min(leaves // c * chunk, n_points,
                         lm_track.SIM3_STAGE_CAP)
    assert lm_track.SIM3_TILE_BYTES <= smem <= 216 * 1024
    assert smem % 16 == 0


def _chunk_sums(terms, chunk):
    """The spec of a warp's chunk sums: column k of every chunk summed in
    f64 in point order (each f32 term converted), as the lanes of a warp
    walk their tile columns."""
    n, cols = terms.shape
    out = []
    for b0 in range(0, n, chunk):
        acc = [0.0] * cols
        for row in terms[b0:b0 + chunk]:
            for k in range(cols):
                acc[k] = acc[k] + float(row[k])
        out.append(acc)
    return out


def test_summation_order_does_not_depend_on_the_cluster():
    """A specification of `sim3_level`'s sums over all 45 columns (43 f32
    terms and the two counts): the chunks of `tree_layout`, each summed in
    point order, then folded by `_kernel_fold` (tests/test_torch_lm_cluster.py)
    with this kernel's warp count, give the bits of the balanced tree over
    the chunks at every power-of-two C. It checks the scheme, not the
    kernel's code (the card checks that)."""
    const = _kernel_constants()
    warps = int(const["kThreads"]) // 32
    assert const["kCols"] == "kSums + 2"        # the two counts
    cols = int(const["kSums"]) + 2
    assert cols == 45
    rng = np.random.default_rng(11)
    n = 900
    leaves, chunk = lm_track.tree_layout(n)
    terms = (rng.standard_normal((n, cols))
             * 10.0 ** rng.integers(-6, 6, (n, cols))).astype(np.float32)
    terms[:, -2:] = rng.integers(0, 2, (n, 2))         # the counts
    sums = _chunk_sums(terms, chunk)
    sums += [[0.0] * cols] * (leaves - len(sums))
    for k in range(cols):
        col = [s[k] for s in sums]
        want = _balanced(col)
        c = 1
        while c <= int(const["kMaxCluster"]):
            assert _kernel_fold(col, c, warps, int(const["kMaxCluster"])) \
                == want, (k, c)
            c *= 2


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("levels", LEVELS)
def test_pair_call_gives_each_direction_its_own_bits(stacked, levels):
    """A constraint stage's two directions in one call, as the constraint
    search runs them (`track_pair_packed`: the candidates' stack with its
    zero padding lane against reference b and back, from the JAX chain's
    inits of this stage): each pack has the bits of its direction's own
    call, and meets JAX on the live lanes; the flag pulls add up."""
    tcam, tstack, tref_b, runs = stacked
    i_refs, w_refs, i_frames, w_frames = runs[levels]
    ts = st3.Sim3Tracker(tcam, TrackerConfig(), sigma2=SIGMA2)
    pk_ba, pk_ab, syncs = ts.track_pair_packed(tref_b, tstack, i_frames,
                                               i_refs, *levels)
    one_ba, s_ba = ts.track_batch_frames_packed(tref_b, tstack, i_frames,
                                                *levels)
    one_ab, s_ab = ts.track_batch_packed(tstack, tref_b, i_refs, *levels)
    assert _bits_equal(pk_ba, one_ba) and _bits_equal(pk_ab, one_ab)
    assert syncs == s_ba + s_ab > 0
    assert pk_ab[3, SP["diverged"]] == 1
    for i in range(3):
        _assert_pack_close(pk_ba.numpy().astype(np.float64)[i], w_frames[i])
    for i in range(4):
        _assert_pack_close(pk_ab.numpy().astype(np.float64)[i], w_refs[i])


@pytest.mark.parametrize("lvl", [3, 1])
def test_level_with_final_returns_the_final_pass_at_its_result(stacked,
                                                               lvl):
    """`levels(..., final=True)` on the plain path returns the level's
    result and `final_pass_plain` at that result, bit for bit (what the
    card's launch runs after its loop), and the same LevelResult as
    without the final pass."""
    tcam, tstack, tref_b, _ = stacked
    rng = np.random.default_rng(7)
    tan = rng.normal(0, [0.01] * 3 + [0.005] * 3 + [0.01], (4, 7))
    args = _level_args(tcam, tstack, tref_b, st3.lie.sim3_exp(
        torch.tensor(tan, dtype=torch.float32)), lvl)
    (r, fin), = st3.levels([args[:5]], *args[5:], final=True)
    _same_bits(r, st3.level(*args))
    want = st3.final_pass_plain(r.pose, r.aff_a, r.aff_b, *args[3:8])
    assert len(fin) == len(want) == 5
    for x, y in zip(fin, want):
        assert _bits_equal(x, y)
    assert fin[0].shape == (4, 7, 7) and torch.equal(fin[0],
                                                     fin[0].transpose(1, 2))


def test_kernel_params_take_at_most_two_lane_sets(pair):
    """The lane table has two sets (a stage's two directions); a third is
    refused before anything reaches the kernel."""
    _, tcam, _, _ = pair
    cfg = TrackerConfig()
    one = lm_track.Sim3Set(pts_step=1, lanes=2)
    prm = lm_track.make_sim3_params(tcam.level(3), cfg, SIGMA2, 10.0, 5, 25,
                                    300, 320, [one])
    assert (prm.sets[0].lanes, prm.sets[1].lanes) == (2, 0)
    with pytest.raises(ValueError, match="lane sets"):
        lm_track.make_sim3_params(tcam.level(3), cfg, SIGMA2, 10.0, 5, 25,
                                  300, 320, [one] * 3)
