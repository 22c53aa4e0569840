"""The 5x5 depth-regularization stencil: CUDA kernel wrappers + plain versions.

Replaces the Pallas TPU kernel `regularize_accumulators` of
lsd_slam_tpu/ops/pallas_stencil.py (and its gate `pallas_regularize_enabled`)
and the elementwise epilogue of lsd_slam_tpu/depth/regularize.py:99-118.
The kernel is `csrc/regularize_stencil.cu` (see its header for the bound
and the design); it has two entries:

  * `regularize_accumulators` — the five accumulators; its plain version
    `regularize_accumulators_plain` is the port of the XLA lattice
    `_regularize_accumulators_xla` (lsd_slam_tpu/depth/regularize.py:41);
  * `regularize_fused` — the whole regularize(): the same sweep with the
    deletion / keep epilogue, the accumulators never leaving registers; its
    plain version `regularize_plain` is the plain accumulators followed by
    `regularize_epilogue`.

A term `x * use` of the JAX lattice is `select(use, x, 0)` after XLA's
simplifier (a masked-out tap whose ivar is inf adds 0, not NaN); every
version here adds the selected term.

Beside the stencil, `fill_holes` (kernel `csrc/fill_holes.cu`, entry
`lsd_fill_holes`, two launches a call) fills the holes of a depth state;
it replaces no Pallas kernel but the XLA-fused `fill_holes` of
lsd_slam_tpu/depth/regularize.py:121, whose op-for-op port is its plain
version `fill_holes_plain`.

The wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise — they never fall back.
`LAUNCHES`, `FUSED_LAUNCHES` and `FILL_HOLES_LAUNCHES` count the calls of
each entry; the engine's worker threads launch too, so each count is
bumped under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

# number of times each CUDA entry was launched (reset them to count a run)
LAUNCHES = 0
FUSED_LAUNCHES = 0
FILL_HOLES_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_DIV_EPS = 1e-10

# dx^2+dy^2 of the 25 taps, in the kernel's constant-slot order
_DIST_SQ = (0, 1, 2, 4, 5, 8)


@functools.lru_cache(maxsize=16)
def dist_constants(reg_dist_var: float) -> np.ndarray:
    """float(dx^2+dy^2) * reg_dist_var in Python double, rounded to f32 —
    the rounding the JAX code applies to the same weak-typed constant.
    Cached per value (read-only), since every launch passes it."""
    d = np.asarray([float(d2) * float(reg_dist_var) for d2 in _DIST_SQ],
                   np.float32)
    d.setflags(write=False)
    return d


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


def _interior(h, w, border, device):
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[border:h - border, border:w - border] = True
    return m


def regularize_epilogue(sum_id, sum_ivar, val_sum, n_occluding,
                        n_not_occluding, valid, idepth_smoothed,
                        var_smoothed, blacklisted, validity_th: float,
                        remove_occlusions: bool):
    """Deletion / keep epilogue of regularize() (regularize.py:99-118) on
    the five accumulators. Returns (valid, blacklisted, idepth_smoothed,
    var_smoothed)."""
    h, w = valid.shape
    touched = valid & _interior(h, w, 2, valid.device)
    delete_validity = touched & (val_sum < validity_th)
    if remove_occlusions:
        delete_occ = touched & ~delete_validity & (n_occluding
                                                   > n_not_occluding)
    else:
        delete_occ = torch.zeros_like(delete_validity)

    keep = touched & ~delete_validity & ~delete_occ
    safe_ivar = torch.clamp_min(sum_ivar, _DIV_EPS)
    smoothed = torch.where(keep, sum_id / safe_ivar, idepth_smoothed)
    var_sm = torch.where(keep, 1.0 / safe_ivar, var_smoothed)
    return (valid & ~delete_validity & ~delete_occ,
            blacklisted - delete_validity.to(torch.int32), smoothed, var_sm)


def regularize_plain(idepth, var, valid, validity, idepth_smoothed,
                     var_smoothed, blacklisted, reg_dist_var: float,
                     diff_fac: float, validity_th: float,
                     remove_occlusions: bool):
    """The whole regularize() as plain torch: the plain accumulators, then
    the epilogue. Returns (valid, blacklisted, idepth_smoothed,
    var_smoothed)."""
    acc = regularize_accumulators_plain(idepth, var, valid.to(torch.float32),
                                        validity, reg_dist_var, diff_fac)
    return regularize_epilogue(*acc, valid, idepth_smoothed, var_smoothed,
                               blacklisted, validity_th, remove_occlusions)


def _prefix_seq(x):
    """Sequential f32 prefix sum along the last dim."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def _cumsum_last(x, base: int = 16):
    """f32 cumsum along the last dim in XLA's order: 16-wide blocks summed
    sequentially, block totals scanned recursively, then offset. This is
    bit-identical to the JAX package's `jnp.cumsum` on the CPU; torch.cumsum
    accumulates in double on the CPU and in yet another order on the card,
    and the integral image below subtracts large sums, so the order shows."""
    n = x.shape[-1]
    if n <= base:
        return _prefix_seq(x)
    nb = -(-n // base)
    xp = F.pad(x, (0, nb * base - n))
    inner = _prefix_seq(xp.reshape(x.shape[:-1] + (nb, base)))
    incl = _cumsum_last(inner[..., base - 1], base)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    return (inner + excl[..., None]).reshape(xp.shape)[..., :n]


def fill_holes_plain(valid, idepth, var, validity, blacklisted, max_grad,
                     idepth_smoothed, var_smoothed, min_abs_grad,
                     min_blacklist, val_sum_min_for_create,
                     val_sum_min_for_unblacklist, var_init):
    """fill_holes (DepthMap.cpp:656-754) as plain torch, the port of the
    XLA-fused lsd_slam_tpu/depth/regularize.py:121: the validity integral
    image via two cumsums, the 5x5 window sums, the 5x5 inverse-variance
    neighbour fusion. Returns (valid, idepth, var, validity,
    idepth_smoothed, var_smoothed)."""
    h, w = idepth.shape
    dev = idepth.device
    vc = torch.where(valid, validity, torch.zeros_like(validity))
    integral = _cumsum_last(_cumsum_last(vc).T).T

    # 5x5 inclusive window sum via the integral image
    pad = F.pad(integral[None, None], (3, 2, 3, 2))[0, 0]
    val5 = (pad[5:, 5:] - pad[:-5, 5:] - pad[5:, :-5] + pad[:-5, :-5])

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    region = (ys >= 3) & (ys < h - 2) & (xs >= 3) & (xs < w - 2)

    eligible = (~valid) & region & (max_grad >= min_abs_grad)
    create = eligible & (
        ((blacklisted >= min_blacklist)
         & (val5 > val_sum_min_for_create))
        | (val5 > val_sum_min_for_unblacklist))

    # 5x5 inverse-variance neighbour fusion from the pre-pass snapshot
    p_id = F.pad(idepth[None, None], (2, 2, 2, 2))[0, 0]
    p_var = F.pad(var[None, None], (2, 2, 2, 2), value=1.0)[0, 0]
    p_val = F.pad(valid.to(torch.float32)[None, None], (2, 2, 2, 2))[0, 0]
    sum_obs = torch.zeros_like(idepth)
    sum_ivar = torch.zeros_like(idepth)
    zero = torch.zeros_like(idepth)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            sl = (slice(2 + dy, 2 + dy + h), slice(2 + dx, 2 + dx + w))
            m = p_val[sl] > 0
            s_id, s_var = p_id[sl], p_var[sl]
            # x * mask is select(mask, x, 0) in the XLA program
            sum_obs = sum_obs + torch.where(m, s_id / s_var, zero)
            sum_ivar = sum_ivar + torch.where(m, 1.0 / s_var, zero)

    new_id = sum_obs / torch.clamp_min(sum_ivar, _DIV_EPS)
    new_id = torch.where(torch.abs(new_id) < _DIV_EPS,
                         torch.full_like(new_id, _DIV_EPS), new_id)
    create = create & (sum_ivar > 0)

    neg = torch.full_like(idepth, -1.0)
    return (valid | create,
            torch.where(create, new_id, idepth),
            torch.where(create, torch.full_like(var, var_init), var),
            torch.where(create, torch.zeros_like(validity), validity),
            torch.where(create, neg, idepth_smoothed),
            torch.where(create, neg, var_smoothed))


def _check(name, t, ref, dtype=torch.float32):
    if t.device != ref.device:
        raise ValueError(f"{name} on {t.device}, expected {ref.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape != ref.shape:
        raise ValueError(f"{name} must be 2-D {tuple(ref.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_ARGTYPES = {
    "lsd_regularize_accumulators": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_float, ctypes.c_void_p]),
    "lsd_regularize_fused": (
        [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]),
    "lsd_fill_holes": (
        [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p]),
}

# the built library (ops/build.py SOURCES) that holds each entry
_LIBRARY = {"lsd_regularize_accumulators": "regularize_stencil",
            "lsd_regularize_fused": "regularize_stencil",
            "lsd_fill_holes": "fill_holes"}


def bind(lib, symbol: str):
    """One C entry of a built library of this module's kernels, with its
    ctypes signature."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[symbol]
    return fn


def _launch(name: str, symbol: str, device, *args):
    """Call one C entry on `device`'s current stream (the device made
    current first if it is not); raises if the launch failed."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, symbol, device, *args)
    from lsd_slam_tpu_torch.ops.build import load
    fn = bind(load(_LIBRARY[symbol]), symbol)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _cuda_or_plain(name: str, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def regularize_accumulators(idepth, var, valid_f, validity,
                            reg_dist_var: float, diff_fac: float):
    """The five 25-tap accumulators of regularizeDepthMap
    (DepthMap.cpp:788-846). Inputs are (H, W) f32 planes (valid_f 1.0/0.0);
    returns (sum_id, sum_ivar, val_sum, n_occluding, n_not_occluding).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if not _cuda_or_plain("regularize_accumulators", idepth):
        return regularize_accumulators_plain(idepth, var, valid_f, validity,
                                             reg_dist_var, diff_fac)
    for name, t in (("idepth", idepth), ("var", var), ("valid_f", valid_f),
                    ("validity", validity)):
        _check(name, t, idepth)
    h, w = idepth.shape
    outs = [torch.empty_like(idepth) for _ in range(5)]
    _launch("regularize_accumulators", "lsd_regularize_accumulators",
            idepth.device, idepth.data_ptr(), var.data_ptr(),
            valid_f.data_ptr(), validity.data_ptr(),
            *(o.data_ptr() for o in outs), h, w,
            dist_constants(reg_dist_var).ctypes.data,
            float(np.float32(diff_fac)))
    with _COUNT_LOCK:
        LAUNCHES += 1
    return tuple(outs)


def regularize_fused(idepth, var, valid, validity, idepth_smoothed,
                     var_smoothed, blacklisted, reg_dist_var: float,
                     diff_fac: float, validity_th: float,
                     remove_occlusions: bool):
    """The whole regularize() in one sweep: (H, W) f32 idepth, var,
    validity, idepth_smoothed, var_smoothed, bool valid and int32
    blacklisted in; new (valid, blacklisted, idepth_smoothed, var_smoothed)
    tensors out (the inputs are left as they are).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global FUSED_LAUNCHES
    if not _cuda_or_plain("regularize_fused", idepth):
        return regularize_plain(idepth, var, valid, validity,
                                idepth_smoothed, var_smoothed, blacklisted,
                                reg_dist_var, diff_fac, validity_th,
                                remove_occlusions)
    for name, t in (("idepth", idepth), ("var", var), ("validity", validity),
                    ("idepth_smoothed", idepth_smoothed),
                    ("var_smoothed", var_smoothed)):
        _check(name, t, idepth)
    _check("valid", valid, idepth, torch.bool)
    _check("blacklisted", blacklisted, idepth, torch.int32)
    h, w = idepth.shape
    o_valid = torch.empty_like(valid)
    o_bl = torch.empty_like(blacklisted)
    o_id = torch.empty_like(idepth)
    o_var = torch.empty_like(idepth)
    _launch("regularize_fused", "lsd_regularize_fused", idepth.device,
            idepth.data_ptr(), var.data_ptr(), valid.data_ptr(),
            validity.data_ptr(), idepth_smoothed.data_ptr(),
            var_smoothed.data_ptr(), blacklisted.data_ptr(),
            o_valid.data_ptr(), o_bl.data_ptr(), o_id.data_ptr(),
            o_var.data_ptr(), h, w, dist_constants(reg_dist_var).ctypes.data,
            float(np.float32(diff_fac)), float(np.float32(validity_th)),
            int(bool(remove_occlusions)))
    with _COUNT_LOCK:
        FUSED_LAUNCHES += 1
    return o_valid, o_bl, o_id, o_var


def fill_holes(valid, idepth, var, validity, blacklisted, max_grad,
               idepth_smoothed, var_smoothed, min_abs_grad: float,
               min_blacklist: int, val_sum_min_for_create: float,
               val_sum_min_for_unblacklist: float, var_init: float):
    """fill_holes of a depth state's planes: (H, W) bool valid, int32
    blacklisted and f32 idepth, var, validity, max_grad (the keyframe's),
    idepth_smoothed, var_smoothed in; new (valid, idepth, var, validity,
    idepth_smoothed, var_smoothed) tensors out (the inputs are left as they
    are). The thresholds compare in f32, as torch compares an f32 tensor
    with a Python number; `min_blacklist` is an integer.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    two passes."""
    global FILL_HOLES_LAUNCHES
    if not _cuda_or_plain("fill_holes", idepth):
        return fill_holes_plain(valid, idepth, var, validity, blacklisted,
                                max_grad, idepth_smoothed, var_smoothed,
                                min_abs_grad, min_blacklist,
                                val_sum_min_for_create,
                                val_sum_min_for_unblacklist, var_init)
    if int(min_blacklist) != min_blacklist:
        raise ValueError(f"fill_holes: min_blacklist {min_blacklist} is not "
                         "an integer")
    for name, t in (("idepth", idepth), ("var", var), ("validity", validity),
                    ("max_grad", max_grad),
                    ("idepth_smoothed", idepth_smoothed),
                    ("var_smoothed", var_smoothed)):
        _check(name, t, idepth)
    _check("valid", valid, idepth, torch.bool)
    _check("blacklisted", blacklisted, idepth, torch.int32)
    h, w = idepth.shape
    # the integral image's column sums within bands of 16 rows, then each
    # band's column totals
    scratch = torch.empty((h + -(-h // 16)) * w, dtype=torch.float32,
                          device=idepth.device)
    outs = (torch.empty_like(valid), *(torch.empty_like(idepth)
                                       for _ in range(5)))
    _launch("fill_holes", "lsd_fill_holes", idepth.device,
            valid.data_ptr(), idepth.data_ptr(), var.data_ptr(),
            validity.data_ptr(), blacklisted.data_ptr(), max_grad.data_ptr(),
            idepth_smoothed.data_ptr(), var_smoothed.data_ptr(),
            scratch.data_ptr(), *(o.data_ptr() for o in outs), h, w,
            float(np.float32(min_abs_grad)), int(min_blacklist),
            float(np.float32(val_sum_min_for_create)),
            float(np.float32(val_sum_min_for_unblacklist)),
            float(np.float32(var_init)))
    with _COUNT_LOCK:
        FILL_HOLES_LAUNCHES += 1
    return outs
