"""The observe sweep on the card: the CUDA kernels' wrappers.

Three kernels of `csrc/epl_stereo.cu` (see its header for the design, the
parity notes and the bound) replace the jnp code of the JAX package's
jitted `observe` / `observe_multi` (lsd_slam_tpu/depth/observe.py):

  * `epl_prepare` — make_epl / make_epl_multi, the priors and masks and the
    per-pixel frame choice: one thread a pixel. Its plain version is
    `depth.observe.epl_setup_plain`.
  * `epl_stereo` — line_stereo for the compacted slots, its results written
    into the grids at flat_idx: a lane owns a slot's set-up and tail, a
    group of lanes searches it, on a grid sized to the card. Plain version
    `depth.observe.epl_search_plain`.
  * `observe_fuse` — _fuse_results with its nine counts: one thread a
    pixel. Plain version `depth.observe.fuse_plain`.

`depth.observe.epl_setup`, `epl_search` and `fuse` send CPU tensors to the
plain versions and CUDA tensors here; these wrappers launch their kernel or
raise: they never fall back. Between the set-up and the search the sweep
compacts its active set with torch ops (`depth.observe.compact_active`).

`PREPARE_LAUNCHES`, `STEREO_LAUNCHES` and `FUSE_LAUNCHES` count launches;
the engine's mapping thread launches too, so each is bumped under a lock.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence

import numpy as np
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import DepthFilterConfig, MappingConfig
from lsd_slam_tpu_torch.depth.observe import (OBSERVE_STAT_KEYS, EplSetup,
                                              FrameTerms, StereoGrids)
from lsd_slam_tpu_torch.depth.state import DepthMapState

# launches of each kernel (reset them to count a run)
PREPARE_LAUNCHES = 0
STEREO_LAUNCHES = 0
FUSE_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

KERNELS = ("epl_prepare", "epl_stereo", "observe_fuse")
# the most reference frames of one sweep (`LsdEplParams.ids`)
MAX_FRAMES = 16


def counts() -> dict:
    """The launch counts by kernel name."""
    return dict(epl_prepare=PREPARE_LAUNCHES, epl_stereo=STEREO_LAUNCHES,
                observe_fuse=FUSE_LAUNCHES)


def reset_counts():
    global PREPARE_LAUNCHES, STEREO_LAUNCHES, FUSE_LAUNCHES
    with _COUNT_LOCK:
        PREPARE_LAUNCHES = STEREO_LAUNCHES = FUSE_LAUNCHES = 0


_PTR_FIELDS = (
    "valid", "idepth", "var", "idepth_sm", "var_sm", "validity",
    "blacklisted", "next_min_id", "kf_img", "kf_gx", "kf_gy", "kf_max_grad",
    "t_r2k", "good", "ref", "KR", "Kt", "R", "t", "tef", "epx", "epy",
    "prior", "min_id", "max_id", "epl_ok", "can_update", "can_create",
    "process", "k_sel", "flat_idx", "valid_k", "code", "r_idepth", "r_var",
    "r_epl", "n_valid", "n_idepth", "n_var", "n_validity", "n_blacklisted",
    "n_next_min_id", "stats", "stamps")


class Ptrs(ctypes.Structure):
    """`LsdEplPtrs` of csrc/epl_stereo.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in _PTR_FIELDS]


_F = ctypes.c_float


class Params(ctypes.Structure):
    """`LsdEplParams` of csrc/epl_stereo.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "h", "w", "n_ref", "n_pix", "budget", "multi", "reactivated",
        "use_subpixel", "allow_negative", "min_blacklist")] + [
        (n, _F) for n in ("fx", "fy", "cx", "cy", "neg_fx", "neg_fy",
                          "cx_fx", "cy_fy")] + [
        ("ids", _F * MAX_FRAMES)] + [(n, _F) for n in (
            "min_epl_length_sq", "min_epl_grad_sq", "min_epl_angle_sq",
            "grad_dist", "min_use_grad", "var_fac", "inv_min_depth",
            "max_crop", "min_crop", "half_min_crop", "border", "w_border",
            "h_border", "kf_u_hi", "kf_v_hi", "kf_bx_hi", "kf_by_hi",
            "ref_v_hi", "ref_by_hi", "err_big", "max_error_stereo",
            "min_dist_error", "photo_num", "max_var", "diff_fac",
            "succ_var_inc", "fail_var_inc", "vc_initial", "vc_inc",
            "vc_dec", "skip_inc")] + [
        ("cap_fac", ctypes.c_double), ("vc_max", ctypes.c_double)]


def _f32(x) -> float:
    """A Python number rounded to f32 as torch rounds a scalar operand."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def _base_params(cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
                 h: int, w: int, n_ref: int, reactivated: bool) -> Params:
    """The constants of a launch that do not change from sweep to sweep,
    built once per camera, configuration, shape and frame count (a sweep
    copies them and sets its ids, budget and skip increment)."""
    b = float(dcfg.sample_point_to_border)
    cap_fac = float(np.float32(dcfg.validity_counter_max_variable)
                    * np.float32(1.0 / 255.0))
    prm = Params(
        h=h, w=w, n_ref=n_ref, n_pix=h * w, multi=int(n_ref > 1),
        reactivated=int(bool(reactivated)),
        min_blacklist=int(dcfg.min_blacklist),
        min_epl_length_sq=_f32(dcfg.min_epl_length_squared),
        min_epl_grad_sq=_f32(dcfg.min_epl_grad_squared),
        min_epl_angle_sq=_f32(dcfg.min_epl_angle_squared),
        grad_dist=_f32(dcfg.gradient_sample_dist),
        var_fac=_f32(dcfg.stereo_epl_var_fac),
        inv_min_depth=_f32(1.0 / dcfg.min_depth),
        max_crop=_f32(dcfg.max_epl_length_crop),
        min_crop=_f32(dcfg.min_epl_length_crop),
        half_min_crop=_f32(0.5 * dcfg.min_epl_length_crop),
        border=_f32(b), w_border=_f32(w - b), h_border=_f32(h - b),
        kf_u_hi=_f32(w - 1.001), kf_v_hi=_f32(h - 1.001),
        kf_bx_hi=_f32(w - 4.0), kf_by_hi=_f32(h - 4.0),
        ref_v_hi=_f32(n_ref * h - 1.001), ref_by_hi=_f32(n_ref * h - 4.0),
        err_big=_f32(4.0 * dcfg.max_error_stereo),
        max_error_stereo=_f32(dcfg.max_error_stereo),
        min_dist_error=_f32(dcfg.min_distance_error_stereo),
        max_var=_f32(dcfg.max_var), diff_fac=_f32(dcfg.diff_fac_observe),
        succ_var_inc=_f32(dcfg.succ_var_inc_fac),
        fail_var_inc=_f32(dcfg.fail_var_inc_fac),
        vc_initial=_f32(float(dcfg.validity_counter_initial_observe)),
        vc_inc=_f32(dcfg.validity_counter_inc),
        vc_dec=_f32(dcfg.validity_counter_dec),
        cap_fac=cap_fac, vc_max=float(dcfg.validity_counter_max))
    if cam is not None:
        prm.fx, prm.fy = _f32(cam.fx), _f32(cam.fy)
        prm.cx, prm.cy = _f32(cam.cx), _f32(cam.cy)
        prm.neg_fx, prm.neg_fy = _f32(-cam.fx), _f32(-cam.fy)
        prm.cx_fx, prm.cy_fy = _f32(cam.cx / cam.fx), _f32(cam.cy / cam.fy)
    if mcfg is not None:
        prm.use_subpixel = int(bool(mcfg.use_subpixel_stereo))
        prm.allow_negative = int(bool(mcfg.allow_negative_idepths))
        prm.min_use_grad = _f32(mcfg.min_use_grad)
        prm.photo_num = _f32(4.0 * mcfg.camera_pixel_noise2)
    return prm


def make_params(cam: Camera, dcfg: DepthFilterConfig, mcfg: MappingConfig,
                h: int, w: int, ref_ids: Sequence[float], budget: int = 0,
                reactivated: bool = False, skip_inc: float = 0.0) -> Params:
    """The constants of a launch; each float is the f32 the plain version's
    torch op uses for the same Python constant (a Python expression such
    as `w - b` or `4.0 * noise2` is evaluated in double first, as there).
    The fusion reads neither the camera nor the mapping constants: it may
    pass None for both."""
    n_ref = len(ref_ids)
    if not 1 <= n_ref <= MAX_FRAMES:
        raise ValueError(f"epl kernels: {n_ref} reference frames, 1 to "
                         f"{MAX_FRAMES} supported")
    prm = Params.from_buffer_copy(_base_params(cam, dcfg, mcfg, h, w, n_ref,
                                               bool(reactivated)))
    prm.ids = (_F * MAX_FRAMES)(*[_f32(i) for i in ref_ids])
    prm.budget = budget
    prm.skip_inc = _f32(skip_inc)
    return prm


def _library():
    from lsd_slam_tpu_torch.ops.build import load
    return load("epl_stereo")


def _entry(name: str):
    fn = getattr(_library(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _on_card(name: str, dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def _check(name: str, dev, **tensors):
    """Each tensor on `dev` with its dtype, contiguous; returns them in
    order (contiguous copies where needed)."""
    out = []
    for key, (t, dtype) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        out.append(t.contiguous())
    return out


def _launch(name: str, entry: str, ptrs: Ptrs, prm: Params, dev):
    with torch.cuda.device(dev):
        rc = _entry(entry)(ctypes.byref(ptrs), ctypes.byref(prm),
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def epl_prepare(state: DepthMapState, kf_img, kf_max_grad, t_r2k,
                ref_ids: Sequence[float], good_masks, cam: Camera,
                dcfg: DepthFilterConfig, mcfg: MappingConfig,
                reactivated: bool = False) -> EplSetup:
    """One launch of the per-pixel set-up (see `depth.observe.epl_setup`):
    t_r2k (K, 3) f32, ref_ids K host numbers, good_masks (K, H, W) bool,
    all on one CUDA device. Returns the EplSetup with its result grids
    filled and its counts zeroed."""
    global PREPARE_LAUNCHES
    dev = kf_img.device
    _on_card("epl_prepare", dev)
    h, w = kf_img.shape
    n_ref = len(ref_ids)
    if reactivated and n_ref != 1:
        raise ValueError("epl_prepare: `reactivated` takes one frame")
    if tuple(t_r2k.shape) != (n_ref, 3) or tuple(good_masks.shape) != (
            n_ref, h, w):
        raise ValueError(f"epl_prepare: t_r2k {tuple(t_r2k.shape)} and "
                         f"good_masks {tuple(good_masks.shape)} for "
                         f"{n_ref} frames of {h}x{w}")
    f32, b8 = torch.float32, torch.bool
    (valid, idsm, varsm, bl, nmi, img, mg, tr, good) = _check(
        "epl_prepare", dev, valid=(state.valid, b8),
        idepth_smoothed=(state.idepth_smoothed, f32),
        var_smoothed=(state.var_smoothed, f32),
        blacklisted=(state.blacklisted, torch.int32),
        next_min_id=(state.next_min_id, f32), kf_img=(kf_img, f32),
        kf_max_grad=(kf_max_grad, f32), t_r2k=(t_r2k, f32),
        good_masks=(good_masks, b8))
    grid = dict(device=dev)
    setup = EplSetup(
        epx=torch.empty(h, w, dtype=f32, **grid),
        epy=torch.empty(h, w, dtype=f32, **grid),
        epl_ok=torch.empty(h, w, dtype=b8, **grid),
        can_update=torch.empty(h, w, dtype=b8, **grid),
        can_create=torch.empty(h, w, dtype=b8, **grid),
        process=torch.empty(h, w, dtype=b8, **grid),
        prior=torch.empty(h, w, dtype=f32, **grid),
        min_id=torch.empty(h, w, dtype=f32, **grid),
        max_id=torch.empty(h, w, dtype=f32, **grid),
        k_sel=torch.empty(h, w, dtype=torch.int64, **grid),
        out=StereoGrids(torch.empty(h, w, dtype=torch.int32, **grid),
                        torch.empty(h, w, dtype=f32, **grid),
                        torch.empty(h, w, dtype=f32, **grid),
                        torch.empty(h, w, dtype=f32, **grid)),
        stats=torch.empty(len(OBSERVE_STAT_KEYS), dtype=torch.int64,
                          **grid))
    ptrs = Ptrs(
        valid=valid.data_ptr(), idepth_sm=idsm.data_ptr(),
        var_sm=varsm.data_ptr(), blacklisted=bl.data_ptr(),
        next_min_id=nmi.data_ptr(), kf_img=img.data_ptr(),
        kf_max_grad=mg.data_ptr(), t_r2k=tr.data_ptr(),
        good=good.data_ptr(), epx=setup.epx.data_ptr(),
        epy=setup.epy.data_ptr(), prior=setup.prior.data_ptr(),
        min_id=setup.min_id.data_ptr(), max_id=setup.max_id.data_ptr(),
        epl_ok=setup.epl_ok.data_ptr(),
        can_update=setup.can_update.data_ptr(),
        can_create=setup.can_create.data_ptr(),
        process=setup.process.data_ptr(), k_sel=setup.k_sel.data_ptr(),
        code=setup.out.code.data_ptr(), r_idepth=setup.out.idepth.data_ptr(),
        r_var=setup.out.var.data_ptr(), r_epl=setup.out.epl.data_ptr(),
        stats=setup.stats.data_ptr())
    prm = make_params(cam, dcfg, mcfg, h, w, ref_ids,
                      reactivated=reactivated)
    _launch("epl_prepare", "lsd_epl_prepare", ptrs, prm, dev)
    with _COUNT_LOCK:
        PREPARE_LAUNCHES += 1
    return setup


def epl_stereo(setup: EplSetup, flat_idx, valid_k, kf_img, kf_gx, kf_gy,
               ref_stack, terms: FrameTerms, cam: Camera,
               dcfg: DepthFilterConfig, mcfg: MappingConfig) -> StereoGrids:
    """One launch of the search (see `depth.observe.epl_search`) over the
    slots flat_idx (int64) / valid_k (bool) of `setup`, against ref_stack
    (K, H, W) with its FrameTerms. Writes into `setup.out` (the grids
    `epl_prepare` filled) and returns it."""
    global STEREO_LAUNCHES
    dev = kf_img.device
    _on_card("epl_stereo", dev)
    h, w = kf_img.shape
    n_ref = ref_stack.shape[0]
    if tuple(ref_stack.shape) != (n_ref, h, w) or not (
            1 <= n_ref <= MAX_FRAMES):
        raise ValueError(f"epl_stereo: ref_stack {tuple(ref_stack.shape)} "
                         f"for a {h}x{w} keyframe, 1 to {MAX_FRAMES} frames")
    if h * w * max(n_ref, 1) >= 2 ** 31:
        raise ValueError("epl_stereo: image too large for 32-bit indices")
    shapes = {"KR": (n_ref, 3, 3), "Kt": (n_ref, 3), "R": (n_ref, 3, 3),
              "t": (n_ref, 3), "tef": (n_ref,)}
    for key, want in shapes.items():
        got = tuple(getattr(terms, key).shape)
        if got != want:
            raise ValueError(f"epl_stereo: terms.{key} {got}, expected "
                             f"{want}")
    if flat_idx.shape != valid_k.shape or flat_idx.dim() != 1:
        raise ValueError("epl_stereo: flat_idx and valid_k must be one (B,) "
                         "shape")
    out = setup.out
    if out is None:
        raise ValueError("epl_stereo: the set-up carries no result grids "
                         "(setup.out, which epl_prepare fills)")
    f32, b8 = torch.float32, torch.bool
    tensors = _check(
        "epl_stereo", dev, flat_idx=(flat_idx, torch.int64),
        valid_k=(valid_k, b8), prior=(setup.prior, f32),
        min_id=(setup.min_id, f32), max_id=(setup.max_id, f32),
        epx=(setup.epx, f32), epy=(setup.epy, f32),
        k_sel=(setup.k_sel, torch.int64), kf_img=(kf_img, f32),
        kf_gx=(kf_gx, f32), kf_gy=(kf_gy, f32), ref=(ref_stack, f32),
        KR=(terms.KR, f32), Kt=(terms.Kt, f32), R=(terms.R, f32),
        t=(terms.t, f32), tef=(terms.tef, f32))
    for key, t, dtype in zip(StereoGrids._fields, out,
                             (torch.int32, f32, f32, f32)):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.shape != (h, w)):
            raise ValueError(f"epl_stereo: out.{key} must be a contiguous "
                             f"{dtype} ({h}, {w}) grid on {dev}")
    names = ("flat_idx", "valid_k", "prior", "min_id", "max_id", "epx",
             "epy", "k_sel", "kf_img", "kf_gx", "kf_gy", "ref", "KR", "Kt",
             "R", "t", "tef")
    ptrs = Ptrs(**{n: t.data_ptr() for n, t in zip(names, tensors)},
                code=out.code.data_ptr(), r_idepth=out.idepth.data_ptr(),
                r_var=out.var.data_ptr(), r_epl=out.epl.data_ptr())
    prm = make_params(cam, dcfg, mcfg, h, w, [0.0] * n_ref,
                      budget=flat_idx.shape[0])
    _launch("epl_stereo", "lsd_epl_stereo", ptrs, prm, dev)
    with _COUNT_LOCK:
        STEREO_LAUNCHES += 1
    return out


def observe_fuse(state: DepthMapState, setup: EplSetup, grids: StereoGrids,
                 kf_max_grad, ref_ids: Sequence[float], skip_inc: float,
                 dcfg: DepthFilterConfig):
    """One launch of the fusion (see `depth.observe.fuse`). The counts are
    added into `setup.stats` (the int64 (9,) buffer `epl_prepare`
    zeroed). Returns (new_state, stats dict of int64 device scalars in
    OBSERVE_STAT_KEYS)."""
    global FUSE_LAUNCHES
    dev = state.idepth.device
    _on_card("observe_fuse", dev)
    h, w = state.idepth.shape
    stats = setup.stats
    if stats is None or (stats.device != dev or stats.dtype != torch.int64
            or not stats.is_contiguous()
            or stats.numel() != len(OBSERVE_STAT_KEYS)):
        raise ValueError("observe_fuse: setup.stats must be a contiguous "
                         f"int64 ({len(OBSERVE_STAT_KEYS)},) tensor on {dev}")
    f32, b8 = torch.float32, torch.bool
    names_dtypes = dict(
        valid=(state.valid, b8), idepth=(state.idepth, f32),
        var=(state.var, f32), idepth_sm=(state.idepth_smoothed, f32),
        var_sm=(state.var_smoothed, f32), validity=(state.validity, f32),
        blacklisted=(state.blacklisted, torch.int32),
        next_min_id=(state.next_min_id, f32),
        kf_max_grad=(kf_max_grad, f32), epl_ok=(setup.epl_ok, b8),
        can_update=(setup.can_update, b8),
        can_create=(setup.can_create, b8), process=(setup.process, b8),
        k_sel=(setup.k_sel, torch.int64), code=(grids.code, torch.int32),
        r_idepth=(grids.idepth, f32), r_var=(grids.var, f32),
        r_epl=(grids.epl, f32))
    tensors = _check("observe_fuse", dev, **names_dtypes)
    new = dict(
        valid=torch.empty(h, w, dtype=b8, device=dev),
        idepth=torch.empty(h, w, dtype=f32, device=dev),
        var=torch.empty(h, w, dtype=f32, device=dev),
        validity=torch.empty(h, w, dtype=f32, device=dev),
        blacklisted=torch.empty(h, w, dtype=torch.int32, device=dev),
        next_min_id=torch.empty(h, w, dtype=f32, device=dev))
    ptrs = Ptrs(**{n: t.data_ptr() for n, t in zip(names_dtypes, tensors)},
                **{f"n_{k}": t.data_ptr() for k, t in new.items()},
                stats=stats.data_ptr())
    prm = make_params(None, dcfg, None, h, w, ref_ids, skip_inc=skip_inc)
    _launch("observe_fuse", "lsd_observe_fuse", ptrs, prm, dev)
    with _COUNT_LOCK:
        FUSE_LAUNCHES += 1
    return state.replace(**new), {k: stats[i] for i, k in
                                  enumerate(OBSERVE_STAT_KEYS)}
