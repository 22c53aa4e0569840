"""Engine warm-up: run every path of the engine once before the first real
frame.

Port of lsd_slam_tpu/system/warmup.py. `warmup(cam, cfg)` runs the same
short scripted synthetic episode at the real frame resolution through a
scratch SlamSystem: two plain frames and a standalone mapping iteration,
`n_switches` forced keyframe switches (finish, propagate, the constraint
search at every Sim(3) level range, PGO), every observe-budget bucket of
the frame step and of the standalone observe, both multi-reference
buckets, a keyframe re-activation and a relocalisation. The scratch
engine is discarded.

The JAX package needs this to trace and compile its programs. The port
compiles nothing at run time except its CUDA kernels, which `ops/build.py`
caches on disk by a hash of source and flags, so the JAX package's
`utils/aot_cache.py` (serialised XLA executables) has no counterpart. On
the card the episode moves out of the first real frame what a fresh
process pays there once: the CUDA context, the cuBLAS and cuSOLVER
handles and their library loads, the load of each kernel's `.so` (built
first if the disk cache lacks it), and the caching allocator's first
pools. It leaves nothing behind that a later engine reads: every engine
keeps its own state (its keyframe graph draws from its own
`random.Random(0)`), so a run after warm-up gives the same bits as
without it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig


def warmup(cam: Camera, cfg: LSDConfig, enable_slam: bool = True,
           n_switches: int = 5, verbose: bool = False, device=None) -> dict:
    """Run the engine's paths once for (cam, cfg) on `device` (the card
    unless the caller names another). Returns a dict of timings. Safe to
    call more than once (later calls find everything loaded)."""
    from lsd_slam_tpu_torch import lie
    from lsd_slam_tpu_torch.depth.depth_map import (
        MULTI_REF_BUCKETS, observe_budget_buckets, observe_budget_full,
        observe_multi_program, observe_program)
    from lsd_slam_tpu_torch.frames import build_frame
    from lsd_slam_tpu_torch.system.slam_system import SlamSystem, frame_step
    from lsd_slam_tpu_torch.utils import synth
    from lsd_slam_tpu_torch.utils.stats import device_sync

    dev = resolve_device(device)
    t0 = time.perf_counter()
    scene = synth.PlaneScene(seed=7)
    sys_ = SlamSystem(cam, cfg, enable_slam=enable_slam, seed=7, device=dev)

    def render(i):
        # small lateral arc: comfortably trackable at any resolution
        t = lie.se3_exp(torch.tensor([0, 0, 0, 0, 0.004 * i, 0],
                                     dtype=torch.float32)).numpy()
        c2w = np.concatenate([t[0:4], [0.01 * i, 0.0, 0.002 * i]])
        w2c = lie.se3_inverse(torch.as_tensor(c2w.astype(np.float32)))
        return synth.render(scene, cam, w2c, device=dev)

    img0, dep0 = render(0)
    sys_.gt_depth_init(img0, dep0, 0, 0.0)

    fid = 0
    # two plain frames: the frame step (pyramid, track, observe, export,
    # pack)
    for _ in range(2):
        fid += 1
        sys_.track_frame(render(fid)[0], fid, fid / 30.0)
    # standalone observe (the async / relocalisation mapping iteration)
    sys_.do_mapping_iteration()
    t_track = time.perf_counter()

    # forced keyframe switches: finish + propagate, constraint search
    # (Sim(3) at every level range, the quick-track buckets), PGO
    for _ in range(n_switches):
        fid += 1
        sys_.create_new_keyframe = True
        sys_.track_frame(render(fid)[0], fid, fid / 30.0)
        fid += 1
        sys_.track_frame(render(fid)[0], fid, fid / 30.0)
    t_switch = time.perf_counter()

    # every observe-budget bucket of the frame step and of the standalone
    # observe (the engine moves between buckets as the eligible set
    # shrinks), then both multi-reference buckets at the full budget
    if sys_.map.is_valid() and sys_.current_keyframe is not None:
        kf = sys_.current_keyframe
        st = sys_.map.state
        kp = kf.pyr
        img = render(fid)[0]
        init7 = torch.tensor([1, 0, 0, 0, 0, 0, 0], dtype=torch.float32,
                             device=dev)
        ones = torch.ones_like(kp.images[0], dtype=torch.bool)
        one = torch.ones((), device=dev)
        for b in observe_budget_buckets(cfg.height, cfg.width):
            frame_step(sys_.tracker, sys_.cam, sys_.cfg, st,
                       kf.tracking_ref, kp, img, init7, 0.0, 1.0,
                       point_budget=b)
            observe_program(st, kp.images[0], kp.gx[0], kp.gy[0],
                            kp.max_grad[0], kp.images[0], init7, 1.0, ones,
                            one, 3.0, sys_.cam, sys_.cfg, point_budget=b)
        gm_min = torch.ones((cfg.height >> cfg.tracker.min_level,
                             cfg.width >> cfg.tracker.min_level),
                            dtype=torch.bool, device=dev)
        for k in MULTI_REF_BUCKETS:
            observe_multi_program(
                st, kp.images[0], kp.gx[0], kp.gy[0], kp.max_grad[0],
                torch.stack([kp.images[0]] * k), torch.stack([init7] * k),
                [1.0] * k, torch.stack([gm_min] * k),
                torch.ones((k,), device=dev), 3.0, sys_.cam, sys_.cfg,
                point_budget=observe_budget_full(cfg.height, cfg.width))
        device_sync()
    t_buckets = time.perf_counter()

    reloc_ok = False
    if enable_slam and sys_.backend is not None and len(sys_.keyframes) >= 2:
        # re-activation (setFromExistingKF)
        kf = sys_.keyframes[0]
        if kf.reactivation is not None:
            state_snap = sys_.map.snapshot()
            current = sys_.current_keyframe
            sys_.load_existing_keyframe(kf)
            sys_.current_keyframe = current
            sys_.map.restore(state_snap)
        # the batched relocaliser
        pyr = build_frame(render(1)[0], cfg.system.pyramid_levels,
                          cfg.mapping.min_use_grad)
        try:
            sys_.backend.relocalize(pyr)
            reloc_ok = True
        except Exception:  # noqa: BLE001 - as JAX: warm-up never fails a run
            pass

    sys_.finalize()
    device_sync()
    out = {
        "total_s": round(time.perf_counter() - t0, 2),
        "frame_path_s": round(t_track - t0, 2),
        "switch_path_s": round(t_switch - t_track, 2),
        "bucket_path_s": round(t_buckets - t_switch, 2),
        "keyframes": len(sys_.keyframes),
        "reloc_warmed": reloc_ok,
    }
    if verbose:
        print(f"[warmup] {out}")
    return out
