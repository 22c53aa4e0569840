"""Order-fixed scatter-sum: `buf[idx[i]] += vals[i]`, each target summing its
contributions in source order, on the CPU and on the card alike.

The JAX package sums floats into rows chosen by an index with XLA's
scatter-add (`x.at[idx].add(v)`): propagate's pass 2, the pose-graph
assembly, the sparse PGO and the appearance descriptor. PyTorch's
`index_add_` / `index_put_(accumulate=True)` add sequentially in source
order on the CPU but with atomics on the card, whose order changes from
run to run, so two runs of the same sequence on one card drifted apart.
`ordered_index_add` is the one call the port makes for all of them:

  * CPU tensors: `buf.index_add_(0, idx, vals)`, the existing call, so the
    CPU bits stay what they were;
  * CUDA tensors: a stable `torch.sort` of the targets, then the
    `lsd_segment_sum` kernel (`csrc/segment_sum.cu`), one thread per
    segment walking its sources in order: the CPU's bits on the card,
    every run. No fallback: a CUDA tensor launches the kernel or raises.

`sort_index(idx)` returns the sort once, for callers that scatter into the
same targets many times (the sparse PGO's matvec); on CPU tensors it sorts
nothing, since `index_add_` takes the index as it is. A target outside
[0, len(buf)) raises: `index_add_`'s IndexError on the CPU, the sorted
route's own IndexError, and a device-side assert in the kernel (which, as
PyTorch's own kernels' asserts do, fails the next call that synchronises).
`segment_sum_plain` is the kernel's plain version: the same sums over the
same sort, one rank within the segments at a time. `LAUNCHES` counts kernel launches; the
engine's worker threads launch too, so it is bumped under a lock.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

# number of times the CUDA kernel was launched (reset it to count a run)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


class SortedIndex(NamedTuple):
    """The targets in source order (`idx`), sorted stably (`keys`), and the
    source of each sorted position (`perm`)."""
    idx: torch.Tensor
    keys: torch.Tensor
    perm: torch.Tensor


def sort_index(idx: torch.Tensor, sorted_route: bool = False) -> SortedIndex:
    """The stable sort of `idx` on CUDA tensors, or with `sorted_route`;
    on CPU tensors `keys` and `perm` stay None (`index_add_` needs no
    sort)."""
    idx = idx.reshape(-1).to(torch.int64)
    if idx.device.type == "cpu" and not sorted_route:
        return SortedIndex(idx, None, None)
    keys, perm = torch.sort(idx, stable=True)
    return SortedIndex(idx, keys, perm)


def segment_sum_plain(buf2: torch.Tensor, order: SortedIndex,
                      vals2: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on (T, C) `buf2` and (M, C) `vals2`: the
    k-th source of every segment is added at step k, so each target sums in
    source order. One step per rank of the longest segment."""
    _, keys, perm = order
    m = keys.numel()
    if m == 0:
        return buf2
    if int(keys[0]) < 0 or int(keys[-1]) >= buf2.shape[0]:
        raise IndexError(f"ordered_index_add: target {int(keys[0])} or "
                         f"{int(keys[-1])} outside [0, {buf2.shape[0]})")
    pos = torch.arange(m, device=keys.device)
    head = torch.ones(m, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)),
                         0).values
    rank = pos - start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        k = keys[sel]            # unique within a step
        buf2[k] = buf2[k] + vals2[perm[sel]]
    return buf2


def _launch(buf2, order: SortedIndex, vals2):
    global LAUNCHES
    dev = buf2.device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(buf2, order, vals2)
    from lsd_slam_tpu_torch.ops.build import load
    fn = load("segment_sum").lsd_segment_sum
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    _, keys, perm = order
    rc = fn(keys.data_ptr(), perm.data_ptr(), vals2.data_ptr(),
            buf2.data_ptr(), keys.numel(), buf2.shape[1], buf2.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1


def ordered_index_add(buf: torch.Tensor, idx, vals: torch.Tensor,
                      sorted_route: bool = False) -> torch.Tensor:
    """`buf[idx[i]] += vals[i]` along dim 0, in place, each target in
    source order; returns `buf`. `idx` is an (M,) integer tensor with
    entries in [0, len(buf)), or its `sort_index`; `vals` is (M, *buf[0]
    shape). CPU tensors take `index_add_` unless `sorted_route` (for tests)
    asks for the sorted route's plain version; CUDA tensors launch the
    kernel."""
    order: Optional[SortedIndex] = idx if isinstance(idx, SortedIndex) \
        else None
    dev = buf.device.type
    if dev == "cpu" and not sorted_route:
        return buf.index_add_(0, order.idx if order is not None else idx,
                              vals)
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"ordered_index_add: unsupported device {buf.device}")
    if buf.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("ordered_index_add sums float32 only, got "
                        f"{buf.dtype} and {vals.dtype}")
    if not buf.is_contiguous():
        raise ValueError("ordered_index_add: buf must be contiguous")
    if order is None or order.keys is None:
        order = sort_index(order.idx if order is not None else idx,
                           sorted_route=True)
    m = order.keys.numel()
    if vals.shape[0] != m or vals.shape[1:] != buf.shape[1:]:
        raise ValueError(f"ordered_index_add: vals {tuple(vals.shape)} for "
                         f"{m} sources into {tuple(buf.shape)}")
    for name, t in (("keys", order.keys), ("perm", order.perm),
                    ("vals", vals)):
        if t.device != buf.device:
            raise ValueError(f"ordered_index_add: {name} on {t.device}, "
                             f"buf on {buf.device}")
    buf2 = buf.view(buf.shape[0], -1)
    vals2 = vals.reshape(m, -1).contiguous()
    if dev == "cpu":
        segment_sum_plain(buf2, order, vals2)
    else:
        _launch(buf2, order, vals2)
    return buf

