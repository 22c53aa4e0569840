"""The port's order-fixed scatter-sum (`ops/scatter.py`): on the CPU it is
`index_add_`, and its sorted route (the card's route: a stable sort, then a
sequential sum per target) gives the same bits, so it sums in source order.

Bound: bit-equality throughout. The inputs mix magnitudes over six decades
and send many sources to each target, so any other summation order changes
bits (checked below on a shuffled order)."""

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.ops import scatter
from lsd_slam_tpu_torch.ops.scatter import (ordered_index_add, sort_index,
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
    order = sort_index(torch.zeros(0, dtype=torch.int64), sorted_route=True)
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
    assert torch.equal(lazy.idx, idx) and lazy.keys is None
    assert lazy.perm is None
    full = sort_index(idx, sorted_route=True)
    assert full.keys.tolist() == [0, 1, 3, 3]
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


@pytest.mark.cuda
def test_card_equals_cpu_index_add_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    before = scatter.LAUNCHES
    for n_src, n_tgt, tail in SHAPES:
        idx, vals, init = _case(5, n_src, n_tgt, tail)
        want = init.clone().index_add_(0, idx, vals)
        got = ordered_index_add(init.cuda(), idx.cuda(), vals.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert scatter.LAUNCHES == before + len(SHAPES)
