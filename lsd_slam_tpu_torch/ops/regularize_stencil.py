"""The 5x5 depth-regularization stencil: CUDA kernel wrapper + plain version.

Replaces the Pallas TPU kernel `regularize_accumulators` of
lsd_slam_tpu/ops/pallas_stencil.py (and its gate `pallas_regularize_enabled`).
The kernel is `csrc/regularize_stencil.cu` (see its header for the bound
and the design); `regularize_accumulators_plain` is the port of the XLA
lattice `_regularize_accumulators_xla` (lsd_slam_tpu/depth/regularize.py:41)
and computes the same five accumulators. A term `x * use` of the JAX
lattice is `select(use, x, 0)` after XLA's simplifier (a masked-out tap
whose ivar is inf adds 0, not NaN); both versions here add the selected
term.

`regularize_accumulators` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises — it never falls
back. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# number of times the CUDA kernel was launched (reset it to count a run)
LAUNCHES = 0

# dx^2+dy^2 of the 25 taps, in the kernel's constant-slot order
_DIST_SQ = (0, 1, 2, 4, 5, 8)


def dist_constants(reg_dist_var: float) -> np.ndarray:
    """float(dx^2+dy^2) * reg_dist_var in Python double, rounded to f32 —
    the rounding the JAX code applies to the same weak-typed constant."""
    return np.asarray([float(d2) * float(reg_dist_var) for d2 in _DIST_SQ],
                      np.float32)


def _taps(a: torch.Tensor, fill: float):
    """The 25 shifted views out[y, x] = a[y+dy, x+dx] (fill off-image), in
    lattice order dy outer, dx inner."""
    h, w = a.shape
    p = F.pad(a[None, None], (2, 2, 2, 2), value=fill)[0, 0]
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            yield dy, dx, p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]


def regularize_accumulators_plain(idepth, var, valid_f, validity,
                                  reg_dist_var: float, diff_fac: float):
    """25-tap lattice as shifted views (port of _regularize_accumulators_xla).

    valid_f is the validity mask as 1.0/0.0. Returns (sum_id, sum_ivar,
    val_sum, n_occluding, n_not_occluding)."""
    sum_id = torch.zeros_like(idepth)
    sum_ivar = torch.zeros_like(idepth)
    val_sum = torch.zeros_like(idepth)
    n_occ = torch.zeros_like(idepth)
    n_not = torch.zeros_like(idepth)
    zero = torch.zeros_like(idepth)
    taps = zip(_taps(idepth, 0.0), _taps(var, 1.0), _taps(valid_f, 0.0),
               _taps(validity, 0.0))
    for (dy, dx, s_id), (_, _, s_var), (_, _, s_val), (_, _, s_vdy) in taps:
        s_valid = s_val > 0
        diff = s_id - idepth
        compatible = diff_fac * diff * diff <= s_var + var
        use = s_valid & compatible
        n_occ = n_occ + (s_valid & ~compatible
                         & (s_id > idepth)).to(torch.float32)
        n_not = n_not + use.to(torch.float32)
        ivar = 1.0 / (s_var + float(dx * dx + dy * dy) * reg_dist_var)
        sum_id = sum_id + torch.where(use, s_id * ivar, zero)
        sum_ivar = sum_ivar + torch.where(use, ivar, zero)
        val_sum = val_sum + torch.where(use, s_vdy, zero)
    return sum_id, sum_ivar, val_sum, n_occ, n_not


def _check(name, t, ref):
    if t.device != ref.device:
        raise ValueError(f"{name} on {t.device}, expected {ref.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != 2 or t.shape != ref.shape:
        raise ValueError(f"{name} must be 2-D {tuple(ref.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    from lsd_slam_tpu_torch.ops.build import load
    lib = load("regularize_stencil")
    fn = lib.lsd_regularize_accumulators
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_float, ctypes.c_void_p])
    return fn


def regularize_accumulators(idepth, var, valid_f, validity,
                            reg_dist_var: float, diff_fac: float):
    """The five 25-tap accumulators of regularizeDepthMap
    (DepthMap.cpp:788-846). Inputs are (H, W) f32 planes (valid_f 1.0/0.0);
    returns (sum_id, sum_ivar, val_sum, n_occluding, n_not_occluding).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if idepth.device.type == "cpu":
        return regularize_accumulators_plain(idepth, var, valid_f, validity,
                                             reg_dist_var, diff_fac)
    if idepth.device.type != "cuda":
        raise ValueError(f"regularize_accumulators: unsupported device "
                         f"{idepth.device}")
    for name, t in (("idepth", idepth), ("var", var), ("valid_f", valid_f),
                    ("validity", validity)):
        _check(name, t, idepth)
    h, w = idepth.shape
    fn = _lib()
    outs = [torch.empty_like(idepth) for _ in range(5)]
    dist = dist_constants(reg_dist_var)
    with torch.cuda.device(idepth.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(idepth.data_ptr(), var.data_ptr(), valid_f.data_ptr(),
                validity.data_ptr(), *(o.data_ptr() for o in outs),
                h, w, dist.ctypes.data, float(np.float32(diff_fac)), stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"regularize_accumulators kernel launch failed: "
                           f"cudaError {rc}")
    return tuple(outs)
