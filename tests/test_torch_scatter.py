"""The port's order-fixed scatter-sum (`ops/scatter.py`): on the CPU it is
`index_add_`, and its sorted route (the card's route: the order step's
offsets and permutation, then a sequential sum per target) gives the same
bits, so it sums in source order. The call sites merge consecutive adds
into one call; the merged calls give the sequential calls' bits.

Bound: bit-equality throughout. The inputs mix magnitudes over six decades
and send many sources to each target, so any other summation order changes
bits (checked below on a shuffled order)."""

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.mapping import pose_graph, sparse_pgo
from lsd_slam_tpu_torch.ops import scatter
from lsd_slam_tpu_torch.ops.scatter import (ordered_index_add, sort_index,
                                            segment_order_plain, segment_sum,
                                            segment_sum_plain)


def _case(seed, n_src, n_tgt, tail=()):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, n_tgt, n_src))
    mag = 10.0 ** rng.uniform(-3, 3, (n_src, *tail))
    vals = torch.as_tensor((rng.standard_normal((n_src, *tail)) * mag)
                           .astype(np.float32))
    init = torch.as_tensor(rng.standard_normal((n_tgt, *tail))
                           .astype(np.float32))
    return idx, vals, init


SHAPES = [(10_000, 100, ()), (3_000, 40, (4,)), (500, 9, (7, 7))]


@pytest.mark.parametrize("n_src,n_tgt,tail", SHAPES)
def test_cpu_call_is_index_add_and_index_put(n_src, n_tgt, tail):
    idx, vals, init = _case(0, n_src, n_tgt, tail)
    got = ordered_index_add(init.clone(), idx, vals)
    want = init.clone().index_add_(0, idx, vals)
    put = init.clone().index_put_((idx,), vals, accumulate=True)
    assert torch.equal(got, want) and torch.equal(got, put)


@pytest.mark.parametrize("n_src,n_tgt,tail", SHAPES)
def test_sorted_route_sums_in_source_order(n_src, n_tgt, tail):
    idx, vals, init = _case(1, n_src, n_tgt, tail)
    want = init.clone().index_add_(0, idx, vals)
    got = ordered_index_add(init.clone(), idx, vals, sorted_route=True)
    assert torch.equal(got, want)
    # a precomputed sort gives the same, on both routes
    order = sort_index(idx)
    assert torch.equal(ordered_index_add(init.clone(), order, vals,
                                         sorted_route=True), want)
    assert torch.equal(ordered_index_add(init.clone(), order, vals), want)
    # the test has teeth: another order of the same sources changes bits
    perm = torch.as_tensor(np.random.default_rng(2).permutation(n_src))
    other = init.clone().index_add_(0, idx[perm], vals[perm])
    assert not torch.equal(other, want)


def test_two_index_put_equals_flattened_ordered_add():
    """The pose-graph assembly's four H blocks: `index_put_((a, b),
    accumulate=True)` on an (n, n, 7, 7) tensor and the ordered add on its
    (n*n, 7, 7) view at a*n + b give the same bits."""
    rng = np.random.default_rng(3)
    n, e = 12, 40
    a = torch.as_tensor(rng.integers(0, n, e))
    b = torch.as_tensor(rng.integers(0, n, e))
    blocks = torch.as_tensor(rng.standard_normal((e, 7, 7))
                             .astype(np.float32))
    want = torch.zeros((n, n, 7, 7))
    got = torch.zeros((n * n, 7, 7))
    for p, q, sgn in ((a, a, 1), (b, b, 1), (a, b, -1), (b, a, -1)):
        want.index_put_((p, q), sgn * blocks, accumulate=True)
        ordered_index_add(got, p * n + q, sgn * blocks)
        assert torch.equal(got.reshape(n, n, 7, 7), want)


def test_dropped_sources_at_their_own_pixel_change_no_bit():
    """Propagate's pass 2: a dropped source adds +0.0 at its own pixel
    instead of a dump slot; sums of non-negative terms from +0 keep their
    bits (propagate's four sums are all of that kind)."""
    rng = np.random.default_rng(4)
    hw = 2_000
    flat = torch.as_tensor(rng.integers(0, hw, hw))
    keep = torch.as_tensor(rng.random(hw) < 0.4)
    vals = torch.as_tensor((rng.random(hw) * 10.0 ** rng.uniform(-3, 3, hw))
                           .astype(np.float32))
    zero = torch.zeros_like(vals)
    dump = torch.zeros(hw + 1).index_add_(
        0, torch.where(keep, flat, hw), torch.where(keep, vals, zero))[:hw]
    own = torch.where(keep, flat, torch.arange(hw))
    for route in (False, True):
        got = ordered_index_add(torch.zeros(hw), own,
                                torch.where(keep, vals, zero),
                                sorted_route=route)
        assert torch.equal(got, dump)


def test_plain_segment_sum_on_an_empty_index():
    buf = torch.ones(5, 1)
    order = sort_index(torch.zeros(0, dtype=torch.int64), 5,
                       sorted_route=True)
    assert torch.equal(segment_sum_plain(buf, order, torch.zeros(0, 1)),
                       torch.ones(5, 1))


def test_wrong_inputs_raise():
    idx = torch.tensor([0, 1, 1])
    with pytest.raises(TypeError):
        ordered_index_add(torch.zeros(2, dtype=torch.float64), idx,
                          torch.ones(3, dtype=torch.float64),
                          sorted_route=True)
    with pytest.raises(ValueError):
        ordered_index_add(torch.zeros(2, 3), idx, torch.ones(3, 2),
                          sorted_route=True)
    with pytest.raises(ValueError):
        ordered_index_add(torch.empty(2, device="meta"), idx,
                          torch.empty(3, device="meta"))


def test_cpu_sorts_only_on_the_sorted_route():
    """On CPU tensors `index_add_` takes the index as it is: `sort_index`
    sorts only when the sorted route is asked for."""
    idx = torch.tensor([3, 0, 3, 1])
    lazy = sort_index(idx)
    assert torch.equal(lazy.idx, idx) and lazy.offsets is None
    assert lazy.perm is None
    full = sort_index(idx, 4, sorted_route=True)
    assert full.offsets.tolist() == [0, 1, 2, 2, 4]
    assert full.perm.tolist() == [1, 3, 0, 2]


@pytest.mark.parametrize("bad", [-1, 4])
@pytest.mark.parametrize("route", [False, True])
def test_target_out_of_range_raises(bad, route):
    """A target outside [0, len(buf)) raises on both CPU routes, as the
    kernel's device-side assert does on the card (chip_smoke.py's
    [scatter] phase checks that in a process of its own)."""
    idx = torch.tensor([0, bad, 2])
    with pytest.raises(IndexError):
        ordered_index_add(torch.zeros(4), idx, torch.ones(3),
                          sorted_route=route)


def _stable_sort_csr(idx, n_tgt):
    """torch.sort(stable=True)'s permutation and bincount + cumsum."""
    perm = torch.sort(idx, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(n_tgt + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.bincount(idx, minlength=n_tgt), 0)
    return offsets, perm


def _long_segments_among_many():
    """20,000 targets (the card's atomic path), two of them long: 6,000
    sources (sorted in device memory) and 100 (in shared memory)."""
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 20_000, 30_000)
    pick = rng.permutation(30_000)
    idx[pick[:6_000]], idx[pick[6_000:6_100]] = 7, 9
    return torch.as_tensor(idx)


# (name, index, targets): empty targets, an empty index, one target that
# takes every source, short and long segments; up to 4,096 targets the
# card takes its stable counting path, above it its atomic path
ORDER_CASES = [
    ("empty-targets", torch.tensor([5, 0, 5, 2, 9, 0, 5]), 12),
    ("empty-index", torch.zeros(0, dtype=torch.int64), 6),
    ("one-target-takes-all", torch.zeros(5_000, dtype=torch.int64), 1),
    ("one-of-many-takes-all", torch.full((300,), 3, dtype=torch.int64), 7),
    ("short", torch.as_tensor(np.random.default_rng(6).integers(0, 900, 800)),
     900),
    ("long", torch.as_tensor(np.random.default_rng(7).integers(0, 20, 9_000)),
     20),
    ("many-targets-empty-index", torch.zeros(0, dtype=torch.int64), 5_000),
    ("many-targets-short", torch.as_tensor(
        np.random.default_rng(16).integers(0, 9_000, 30_000)), 9_000),
    ("many-targets-long-segments", _long_segments_among_many(), 20_000),
]


@pytest.mark.parametrize("name,idx,n_tgt", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_plain_order_is_the_stable_sort(name, idx, n_tgt):
    """The order step's plain version: `perm` is torch.sort(stable=True)'s
    permutation, `offsets` are bincount + cumsum."""
    offsets, perm = _stable_sort_csr(idx, n_tgt)
    order = sort_index(idx, n_tgt, sorted_route=True)
    assert order.offsets.dtype == order.perm.dtype == torch.int32
    assert torch.equal(order.offsets, offsets)
    assert torch.equal(order.perm, perm)
    assert torch.equal(segment_order_plain(idx, n_tgt).perm, perm)


def test_sorted_route_needs_the_target_count():
    with pytest.raises(ValueError):
        sort_index(torch.tensor([0, 1]), sorted_route=True)


@pytest.mark.parametrize("n_src,n_tgt,tail", SHAPES + [(4_000, 3, (2,))])
def test_fold_regimes_give_identical_bits(n_src, n_tgt, tail):
    """Either regime named on CPU tensors gives `index_add_`'s bits on one
    order, short and long segments alike: the CPU has one plain fold for
    both, and an unknown regime raises. The kernels' two regimes are
    compared on the card (`test_card_equals_cpu_index_add_bit_for_bit`)."""
    idx, vals, init = _case(8, n_src, n_tgt, tail)
    want = init.clone().index_add_(0, idx, vals)
    order = sort_index(idx, n_tgt, sorted_route=True)
    got = {}
    for regime in ("short", "long"):
        buf = init.clone()
        segment_sum(buf.view(n_tgt, -1), order, vals.reshape(n_src, -1),
                    regime)
        got[regime] = buf
    assert torch.equal(got["short"], got["long"])
    assert torch.equal(got["short"], want)
    with pytest.raises(ValueError):
        segment_sum(init.clone().view(n_tgt, -1), order,
                    vals.reshape(n_src, -1), "tree")


def _merge_case(seed, n_tgt, n_src, tail, parts):
    rng = np.random.default_rng(seed)
    idx = [torch.as_tensor(rng.integers(0, n_tgt, n_src))
           for _ in range(parts)]
    vals = [torch.as_tensor((rng.standard_normal((n_src, *tail))
                             * 10.0 ** rng.uniform(-3, 3, (n_src, *tail)))
                            .astype(np.float32)) for _ in range(parts)]
    return idx, vals


# the merged call sites: the dense PGO's four H adds and two g adds, the
# sparse PGO's matvec, rhs and diagonal pairs, propagate's four 1-D sums as
# one (M, 4) call, the appearance tile sums as one (M, 2) call
MERGES = {"pgo-dense-H": (81, 30, (7, 7), 4),
          "pgo-dense-g": (9, 30, (7,), 2),
          "pgo-sparse-matvec": (40, 55, (7,), 2),
          "pgo-sparse-diag": (40, 55, (7, 7), 2)}


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("site", sorted(MERGES))
def test_merged_adds_equal_the_adds_in_turn(site, route):
    """A left fold over concatenated index lists equals the folds in turn,
    target by target, bit for bit."""
    n_tgt, n_src, tail, parts = MERGES[site]
    idx, vals = _merge_case(9, n_tgt, n_src, tail, parts)
    init = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (n_tgt, *tail)).astype(np.float32))
    want = init.clone()
    for i, v in zip(idx, vals):
        ordered_index_add(want, i, v, sorted_route=route)
    got = ordered_index_add(init.clone(), torch.cat(idx), torch.cat(vals),
                            sorted_route=route)
    assert torch.equal(got, want)
    assert torch.equal(got, init.clone().index_put_(
        (torch.cat(idx),), torch.cat(vals), accumulate=True))


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("cols", [2, 4])
def test_merged_columns_equal_the_1d_adds(cols, route):
    """Propagate's four sums (cols 4) and the appearance tile sums (cols 2)
    as one (M, cols) call: each column is its 1-D call's fold."""
    rng = np.random.default_rng(11)
    n = 3_000
    idx = torch.as_tensor(rng.integers(0, 400, n))
    keep = torch.as_tensor(rng.random(n) < 0.6)
    terms = torch.as_tensor((rng.random((n, cols))
                             * 10.0 ** rng.uniform(-3, 3, (n, cols)))
                            .astype(np.float32))
    terms = torch.where(keep[:, None], terms, torch.zeros(()))
    got = ordered_index_add(torch.zeros(400, cols), idx, terms,
                            sorted_route=route)
    for k in range(cols):
        one = ordered_index_add(torch.zeros(400), idx,
                                terms[:, k].contiguous(), sorted_route=route)
        assert torch.equal(got[:, k], one)


def test_pgo_merged_calls_give_the_sequential_bits():
    """The port's own merged sites: `pose_graph._assemble` and
    `sparse_pgo._matvec` against their six and two adds in turn."""
    rng = np.random.default_rng(12)
    n, e = 9, 20
    efrom = torch.as_tensor(rng.integers(0, n, e))
    eto = torch.as_tensor((efrom.numpy() + rng.integers(1, n, e)) % n)
    poses = torch.as_tensor(np.concatenate(
        [np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)),
         rng.standard_normal((n, 3)), np.ones((n, 1))], 1)
        .astype(np.float32))
    poses[:, 0:3] = torch.as_tensor(rng.normal(0, 0.1, (n, 3))
                                    .astype(np.float32))
    poses[:, 0:4] /= torch.linalg.norm(poses[:, 0:4], dim=1, keepdim=True)
    meas_inv = poses[torch.as_tensor(rng.integers(0, n, e))]
    info = torch.eye(7).expand(e, 7, 7) * 100.0
    Hd, g, _ = pose_graph._assemble(poses, efrom, eto, meas_inv, info,
                                    1.0, n)
    AtWA, AtWr, _ = sparse_pgo.edge_blocks(poses, efrom, eto, meas_inv, info,
                                           1.0)
    H = torch.zeros((n * n, 7, 7))
    for a, b, sgn in ((efrom, efrom, 1), (eto, eto, 1), (efrom, eto, -1),
                      (eto, efrom, -1)):
        H.index_add_(0, a * n + b, sgn * AtWA)
    want_g = torch.zeros((n, 7)).index_add_(0, efrom, -AtWr) \
        .index_add_(0, eto, AtWr)
    assert torch.equal(Hd, H.reshape(n, n, 7, 7).permute(0, 2, 1, 3)
                       .reshape(n * 7, n * 7))
    assert torch.equal(g, want_g.reshape(-1))
    v = torch.as_tensor(rng.standard_normal((n, 7)).astype(np.float32))
    t = (AtWA @ (v[efrom] - v[eto]).unsqueeze(-1)).squeeze(-1)
    want = torch.zeros_like(v).index_add_(0, efrom, t).index_add_(0, eto, -t)
    for route in (False, True):
        ends = sort_index(torch.cat([efrom, eto]), n, sorted_route=route)
        assert torch.equal(sparse_pgo._matvec(AtWA, efrom, eto, ends, v),
                           want)


@pytest.mark.cuda
def test_card_equals_cpu_index_add_bit_for_bit():
    """The card's sums equal the CPU `index_add_` in both regimes of the
    fold, and the auto route launches the order step's three kernels (few
    targets: count, scan, place) and the fold's one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = scatter.LAUNCHES, scatter.ORDER_LAUNCHES
    for n_src, n_tgt, tail in SHAPES:
        idx, vals, init = _case(5, n_src, n_tgt, tail)
        want = init.clone().index_add_(0, idx, vals)
        got = ordered_index_add(init.cuda(), idx.cuda(), vals.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert (scatter.LAUNCHES, scatter.ORDER_LAUNCHES) == (
        before[0] + len(SHAPES), before[1] + 3 * len(SHAPES))
    for n_src, n_tgt, tail in SHAPES + [(20_000, 2, ())]:
        idx, vals, init = _case(13, n_src, n_tgt, tail)
        want = init.clone().index_add_(0, idx, vals)
        order = sort_index(idx.cuda(), n_tgt)
        for regime in ("short", "long"):
            buf = init.cuda()
            segment_sum(buf.view(n_tgt, -1), order,
                        vals.cuda().reshape(n_src, -1), regime)
            torch.cuda.synchronize()
            assert torch.equal(buf.cpu(), want), regime


@pytest.mark.cuda
@pytest.mark.parametrize("name,idx,n_tgt", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_card_order_is_the_stable_sort(name, idx, n_tgt):
    """The order step's kernels give torch.sort(stable=True)'s permutation
    and bincount + cumsum exactly, twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    offsets, perm = _stable_sort_csr(idx, n_tgt)
    for _ in range(2):
        order = sort_index(idx.cuda(), n_tgt)
        torch.cuda.synchronize()
        assert torch.equal(order.offsets.cpu(), offsets)
        assert torch.equal(order.perm.cpu(), perm)


@pytest.mark.cuda
def test_card_route_sorts_nothing_and_pulls_nothing(monkeypatch):
    """On CUDA tensors `ordered_index_add` launches the order step and the
    fold: no torch.sort or argsort, no plain version, and no call that
    synchronises with the host (sync debug mode "error" raises on one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

    def forbidden(*a, **k):
        raise AssertionError("the card's route reached a sort or a plain "
                             "version")

    for mod, name in ((torch, "sort"), (torch, "argsort"),
                      (scatter, "segment_sum_plain"),
                      (scatter, "segment_order_plain")):
        monkeypatch.setattr(mod, name, forbidden)
    idx, vals, init = _case(14, 10_000, 100, (3,))
    bc, ic, vc = init.cuda(), idx.cuda(), vals.cuda()
    before = scatter.LAUNCHES, scatter.ORDER_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ordered_index_add(bc, ic, vc)
        ordered_index_add(bc, sort_index(ic, 100), vc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = init.clone().index_add_(0, idx, vals).index_add_(0, idx, vals)
    assert torch.equal(bc.cpu(), want)
    assert (scatter.LAUNCHES, scatter.ORDER_LAUNCHES) == (
        before[0] + 2, before[1] + 2 * 3)
