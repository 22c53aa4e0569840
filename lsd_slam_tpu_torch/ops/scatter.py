"""Order-fixed scatter-sum: `buf[idx[i]] += vals[i]`, each target summing
its contributions in source order, on the CPU and on the card alike.

The JAX package sums floats into rows chosen by an index with XLA's
scatter-add (`x.at[idx].add(v)`): propagate's pass 2, the pose-graph
assembly, the sparse PGO and the appearance descriptor. PyTorch's
`index_add_` / `index_put_(accumulate=True)` add sequentially in source
order on the CPU but with atomics on the card, whose order changes from
run to run, so two runs of the same sequence on one card drifted apart.
`ordered_index_add` is the one call the port makes for all of them:

  * CPU tensors: `buf.index_add_(0, idx, vals)`, the existing call, so the
    CPU bits stay what they were;
  * CUDA tensors: two hand-written steps (`csrc/segment_sum.cu`). The
    order step (`sort_index`) gives the CSR form (`offsets`, `perm`) of
    `torch.sort(idx, stable=True)` on the device, with no host pull: up to
    4,096 targets a stable counting sort (per-chunk counts, a scan, a
    placement in source order), above it integer atomics, a scan, a
    placement and a sort of each target's group. The fold (`segment_sum`)
    walks each target's sources in that order: the CPU's bits on the
    card, every run. No fallback: a CUDA tensor launches the kernels or
    raises.

A left fold over the concatenation of two index lists equals the two folds
in turn, target by target, so callers merge consecutive adds into one
call (the PGO's blocks, propagate's four sums).

`sort_index(idx, n_targets)` returns the order once, for callers that
scatter into the same targets many times (the sparse PGO's matvec); on CPU
tensors it orders nothing, since `index_add_` takes the index as it is. A
target outside [0, n_targets) raises: `index_add_`'s IndexError on the
CPU, the plain order's own IndexError, and a device-side assert in the
order step's count kernel (which, as PyTorch's own kernels' asserts do,
fails the next call that synchronises).

The fold has two regimes, picked from the shapes alone (no sync): `short`
(one thread per target and column) below `LONG_SEGMENTS` sources per target
on average, `long` (one warp per target) above. Both add the same terms in
the same order, so one plain fold stands for both. `segment_order_plain`
and `segment_sum_plain` are the kernels' plain versions. `LAUNCHES` counts
the kernels the fold launches and `ORDER_LAUNCHES` those the order step
launches (up to five a step, as the C entries report them); the engine's
worker threads launch too, so both are bumped under a lock.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional

import torch

# kernels launched by the fold and by the order step (reset to count a run)
LAUNCHES = 0
ORDER_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

# mean sources per target from which the fold takes one warp per target
LONG_SEGMENTS = 16
_REGIMES = {"short": 0, "long": 1}
_INT32_LIMIT = 2 ** 31


class SortedIndex(NamedTuple):
    """The targets in source order (`idx`); the stable sort of `idx` in CSR
    form: `offsets` (T+1,) int32, target t's sources at positions
    [offsets[t], offsets[t+1]) of `perm` (M,) int32, ascending."""
    idx: torch.Tensor
    offsets: Optional[torch.Tensor]
    perm: Optional[torch.Tensor]


def regime_for(m: int, n_targets: int) -> str:
    """The fold's regime for M sources into T targets (shapes only)."""
    return "long" if m >= LONG_SEGMENTS * max(n_targets, 1) else "short"


def segment_order_plain(idx: torch.Tensor, n_targets: int) -> SortedIndex:
    """Plain version of the order step: `bincount`, `cumsum` and a stable
    argsort."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_targets):
        raise IndexError(f"ordered_index_add: target {int(idx.min())} or "
                         f"{int(idx.max())} outside [0, {n_targets})")
    counts = torch.bincount(idx, minlength=n_targets)
    offsets = torch.zeros(n_targets + 1, dtype=torch.int32,
                          device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0)
    perm = torch.argsort(idx, stable=True).to(torch.int32)
    return SortedIndex(idx, offsets, perm)


def _lib():
    from lsd_slam_tpu_torch.ops.build import load
    lib = load("segment_sum")
    if lib.lsd_segment_sum.argtypes is None:
        lib.lsd_segment_order_scratch.restype = None
        lib.lsd_segment_order_scratch.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.lsd_segment_order.restype = ctypes.c_int
        lib.lsd_segment_order.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [
            ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.lsd_segment_sum.restype = ctypes.c_int
        lib.lsd_segment_sum.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
    return lib


def _on_its_card(fn):
    """Run `fn(t, ...)` with `t`'s card as the current device."""
    def run(t, *args):
        if t.device.index is not None \
                and t.device.index != torch.cuda.current_device():
            with torch.cuda.device(t.device):
                return fn(t, *args)
        return fn(t, *args)
    return run


@_on_its_card
def _order_on_card(idx: torch.Tensor, n_targets: int) -> SortedIndex:
    global ORDER_LAUNCHES
    m = idx.numel()
    if m >= _INT32_LIMIT or n_targets >= _INT32_LIMIT:
        raise ValueError(f"ordered_index_add: {m} sources into {n_targets} "
                         "targets: both must be below 2**31 (int32 ids)")
    lib = _lib()
    zeroed, spare = ctypes.c_int64(), ctypes.c_int64()
    lib.lsd_segment_order_scratch(m, n_targets, ctypes.byref(zeroed),
                                  ctypes.byref(spare))
    dev = idx.device
    offsets = torch.empty(n_targets + 1, dtype=torch.int32, device=dev)
    perm = torch.empty(m, dtype=torch.int32, device=dev)
    scratch = torch.zeros(zeroed.value, dtype=torch.int32, device=dev)
    merge = torch.empty(spare.value, dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    rc = lib.lsd_segment_order(
        idx.data_ptr(), m, n_targets, offsets.data_ptr(), perm.data_ptr(),
        scratch.data_ptr(), merge.data_ptr() if spare.value else None,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    with _COUNT_LOCK:
        ORDER_LAUNCHES += launched.value
    if rc != 0:
        raise RuntimeError(f"segment_order kernel launch failed: cudaError "
                           f"{rc}")
    return SortedIndex(idx, offsets, perm)


def sort_index(idx: torch.Tensor, n_targets: Optional[int] = None,
               sorted_route: bool = False) -> SortedIndex:
    """The order of `idx` (targets in [0, n_targets)): on CUDA tensors the
    order step's kernels, on CPU tensors with `sorted_route` its plain
    version; on CPU tensors otherwise `offsets` and `perm` stay None
    (`index_add_` needs no order) and `n_targets` may be omitted."""
    idx = idx.reshape(-1).to(torch.int64).contiguous()
    if idx.device.type == "cpu" and not sorted_route:
        return SortedIndex(idx, None, None)
    if n_targets is None:
        raise ValueError("sort_index: n_targets is needed to order targets")
    if idx.device.type == "cuda":
        return _order_on_card(idx, int(n_targets))
    if idx.device.type != "cpu":
        raise ValueError(f"ordered_index_add: unsupported device "
                         f"{idx.device}")
    return segment_order_plain(idx, int(n_targets))


def segment_sum_plain(buf2: torch.Tensor, order: SortedIndex,
                      vals2: torch.Tensor) -> torch.Tensor:
    """Plain version of the fold on (T, C) `buf2` and (M, C) `vals2`, in
    place: every target adds its k-th source at step k, one step at a time
    over all targets."""
    offsets, perm = order.offsets.long(), order.perm.long()
    n_targets = buf2.shape[0]
    if offsets.numel() != n_targets + 1:
        raise ValueError(f"ordered_index_add: offsets of {offsets.numel()} "
                         f"for {n_targets} targets")
    if perm.numel() == 0:
        return buf2
    start, length = offsets[:-1], offsets[1:] - offsets[:-1]
    for r in range(int(length.max())):
        sel = torch.nonzero(length > r).squeeze(1)
        buf2[sel] = buf2[sel] + vals2[perm[start[sel] + r]]
    return buf2


@_on_its_card
def _fold_on_card(buf2, order: SortedIndex, vals2, regime: str):
    global LAUNCHES
    launched = ctypes.c_int(0)
    rc = _lib().lsd_segment_sum(
        order.offsets.data_ptr(), order.perm.data_ptr(), vals2.data_ptr(),
        buf2.data_ptr(), buf2.shape[0], buf2.shape[1], _REGIMES[regime],
        torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    with _COUNT_LOCK:
        LAUNCHES += launched.value
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")


def segment_sum(buf2: torch.Tensor, order: SortedIndex, vals2: torch.Tensor,
                regime: Optional[str] = None) -> torch.Tensor:
    """The fold on (T, C) float32 `buf2` (contiguous, updated in place) and
    (M, C) float32 `vals2` along `order` (of M sources into T targets): the
    kernel on CUDA tensors, the plain version on CPU tensors; `regime`
    (default: from the shapes) picks the kernel's walk and is checked, but
    changes nothing, on the CPU."""
    if buf2.dtype != torch.float32 or vals2.dtype != torch.float32:
        raise TypeError("ordered_index_add sums float32 only, got "
                        f"{buf2.dtype} and {vals2.dtype}")
    if buf2.dim() != 2 or not buf2.is_contiguous():
        raise ValueError("ordered_index_add: buf must be contiguous")
    n_targets, m = buf2.shape[0], order.perm.numel()
    if vals2.shape != (m, buf2.shape[1]):
        raise ValueError(f"ordered_index_add: vals {tuple(vals2.shape)} for "
                         f"{m} sources into {tuple(buf2.shape)}")
    if order.offsets.numel() != n_targets + 1:
        raise ValueError(f"ordered_index_add: offsets of "
                         f"{order.offsets.numel()} for {n_targets} targets")
    for name, t in (("offsets", order.offsets), ("perm", order.perm),
                    ("vals", vals2)):
        if t.device != buf2.device:
            raise ValueError(f"ordered_index_add: {name} on {t.device}, "
                             f"buf on {buf2.device}")
    regime = regime or regime_for(m, n_targets)
    if regime not in _REGIMES:
        raise ValueError(f"segment_sum: unknown regime {regime!r}")
    if buf2.device.type == "cpu":
        return segment_sum_plain(buf2, order, vals2)
    _fold_on_card(buf2, order, vals2.contiguous(), regime)
    return buf2


def ordered_index_add(buf: torch.Tensor, idx, vals: torch.Tensor,
                      sorted_route: bool = False) -> torch.Tensor:
    """`buf[idx[i]] += vals[i]` along dim 0, in place, each target in
    source order; returns `buf`. `idx` is an (M,) integer tensor with
    entries in [0, len(buf)), or its `sort_index`; `vals` is (M, *buf[0]
    shape). CPU tensors take `index_add_` unless `sorted_route` (for tests)
    asks for the plain versions of the order and the fold; CUDA tensors
    launch the kernels."""
    order: Optional[SortedIndex] = idx if isinstance(idx, SortedIndex) \
        else None
    dev = buf.device.type
    if dev == "cpu" and not sorted_route:
        return buf.index_add_(0, order.idx if order is not None else idx,
                              vals)
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"ordered_index_add: unsupported device {buf.device}")
    if order is None or order.offsets is None:
        order = sort_index(order.idx if order is not None else idx,
                           buf.shape[0], sorted_route=True)
    if vals.shape[1:] != buf.shape[1:]:
        raise ValueError(f"ordered_index_add: vals {tuple(vals.shape)} into "
                         f"{tuple(buf.shape)}")
    c = math.prod(buf.shape[1:])
    segment_sum(buf.view(buf.shape[0], c) if buf.is_contiguous() else buf,
                order, vals.reshape(vals.shape[0], c))
    return buf
