#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lsd_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no ok line:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every CUDA kernel of the port, from the sources in the
               checkout (one nvcc per source, all started together);
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the main path's shape and at ragged ones, within the stated
               tolerance; then CUDA-event timings of kernel and plain;
  4. VO      — the sequential visual-odometry loop at 640x480 (default
               LSDConfig(), PlaneScene(seed=7), the orbit trajectory of the
               stored JAX reference), gt_depth_init, track_frame for N-1
               frames, finalize, on the card through SlamSystem's defaults;
               the kernel launch counters are zeroed just before and read
               just after. Checks: tracking good, >= 1 keyframe switch,
               >= N stencil launches, ATE < 0.01, and the trajectory within
               TRAJ_BOUND of the JAX reference frame by frame. A second,
               profiled pass (stage timers synchronised) gives the per-stage
               breakdown.
Then a `{"kernels": [...]}` line, the card line, and the ok line last.

Needs CUDA and the port's package beside it: without either it exits 2
before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Per-frame bound of the card's trajectory against the JAX reference, for
# the camera centre (scene units; depths are 1.5-4.5) and the rotation
# (rad). The port on the CPU stays within 4.7e-5 (centre) and 1.2e-5 rad of
# the reference (tests/make_torch_vo_reference.py --check-port); the bound
# adds a 20x margin for the card's other reduction and atomic-add orders.
TRAJ_BOUND = 1e-3

# H100 SXM: HBM3 rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

STENCIL_RTOL = STENCIL_ATOL = 1e-6  # tests/test_pallas_stencil.py:36-38


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def random_planes(rng, h, w):
    """The stencil test planes of tests/test_pallas_stencil.py:11-18."""
    idepth = rng.uniform(0.2, 2.0, (h, w)).astype(np.float32)
    var = rng.uniform(0.001, 0.3, (h, w)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) < 0.6
    validity = rng.uniform(0, 50, (h, w)).astype(np.float32)
    idepth = np.where(valid, idepth, 0.0).astype(np.float32)
    return idepth, var, valid.astype(np.float32), validity


def compare_stencil(torch, stencil, planes, reg_dist_var, diff_fac):
    """Kernel vs plain on the card; returns the max abs error."""
    ins = [torch.as_tensor(p, device="cuda").contiguous() for p in planes]
    got = stencil.regularize_accumulators(*ins, reg_dist_var, diff_fac)
    want = stencil.regularize_accumulators_plain(*ins, reg_dist_var,
                                                 diff_fac)
    torch.cuda.synchronize()
    err = 0.0
    names = ("sum_id", "sum_ivar", "val_sum", "n_occ", "n_not_occ")
    for name, a, b in zip(names, got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name.startswith("n_"):
            if not np.array_equal(a, b):
                raise AssertionError(f"stencil {name}: counts differ at "
                                     f"{int((a != b).sum())} pixels")
        np.testing.assert_allclose(a, b, rtol=STENCIL_RTOL,
                                   atol=STENCIL_ATOL, err_msg=name)
        both = np.isfinite(a) & np.isfinite(b)
        if both.any():
            err = max(err, float(np.abs(a[both] - b[both]).max()))
    return err


def time_gpu(torch, fn, per_batch: int, batches: int) -> float:
    """Median over `batches` of the device time of `per_batch` calls, in ms
    per call. A sleep kernel holds the stream while the host enqueues the
    batch, so the events time the device work, not the launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def rotation_angle(qa, qb):
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def run_vo(torch, ref, profile: bool):
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    n = ref["n_frames"]
    cam = synth.default_camera(ref["width"], ref["height"])
    scene = synth.PlaneScene(seed=ref["scene_seed"])
    poses = synth.orbit_trajectory(n, radius=ref["radius"], fwd=ref["fwd"])
    frames = [synth.render(scene, cam, poses[i], device="cuda")
              for i in range(n)]
    cfg = LSDConfig()
    if profile:
        cfg = cfg.replace(system=dataclasses.replace(cfg.system,
                                                     profile_sync=True))
    sys_ = SlamSystem(cam, cfg)  # device defaults to the card
    assert sys_.device.type == "cuda", sys_.device
    torch.cuda.synchronize()
    frame_ms = []
    t_all = time.perf_counter()
    sys_.gt_depth_init(frames[0][0], frames[0][1], 0, 0.0)
    for i in range(1, n):
        t0 = time.perf_counter()
        sys_.track_frame(frames[i][0], i, i / 30.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    sys_.finalize()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    return sys_, poses, frame_ms, total_s


def profile_vo(torch, ref):
    """One more VO pass under torch.profiler: device busy share of the loop
    and the kernels that take the device time. Informational: a profiler
    that cannot trace the card prints a note instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sys_, _, frame_ms, total_s = run_vo(torch, ref, profile=False)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001 - informational phase
        log(f"[vo-trace] profiler unavailable: {exc!r}")
        return
    dev_us = [(getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0), e) for e in rows]
    busy_ms = sum(t for t, _ in dev_us) / 1e3
    launches = sum(e.count for _, e in dev_us)
    n_tracked = ref["n_frames"] - 1
    if busy_ms == 0:
        log("[vo-trace] the profiler saw no device time")
        return
    log(f"[vo-trace] loop wall {total_s * 1e3:.1f} ms (profiled), device "
        f"busy {busy_ms:.1f} ms -> busy share {busy_ms / (total_s * 1e3):.3f};"
        f" {launches / n_tracked:.0f} device ops per tracked frame")
    for t, e in sorted(dev_us, key=lambda x: -x[0])[:10]:
        log(f"[vo-trace]   {t / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "lsd_slam_tpu_torch")):
        # never fall back to a copy of the port installed elsewhere
        print(f"chip_smoke: no lsd_slam_tpu_torch/ beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lsd_slam_tpu_torch.ops import build
    from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    # ---- 1. device ----
    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    secs = build.build(verbose=True)
    log(f"[build] {json.dumps(secs)} total {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel check ----
    from lsd_slam_tpu_torch.config import LSDConfig
    dcfg = LSDConfig().depth
    reg_dist_var = float(dcfg.reg_dist_var_base)
    diff_fac = float(dcfg.diff_fac_smoothing)
    rng = np.random.default_rng(0)
    max_err = 0.0
    for (h, w) in ((480, 640), (40, 52), (37, 53)):
        e = compare_stencil(torch, stencil, random_planes(rng, h, w),
                            reg_dist_var, diff_fac)
        max_err = max(max_err, e)
        log(f"[kernel] regularize_accumulators {h}x{w}: ok, max abs err {e:g}")
    planes = [torch.as_tensor(p, device="cuda")
              for p in random_planes(np.random.default_rng(1), 480, 640)]
    kernel_ms = time_gpu(torch, lambda: stencil.regularize_accumulators(
        *planes, reg_dist_var, diff_fac), per_batch=50, batches=60)
    plain_ms = time_gpu(torch, lambda: stencil.regularize_accumulators_plain(
        *planes, reg_dist_var, diff_fac), per_batch=5, batches=60)
    h, w = 480, 640
    bytes_moved = 9 * h * w * 4
    flops = 25 * 12 * h * w
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"[kernel] 480x640 kernel {kernel_ms:.5f} ms, plain {plain_ms:.5f} ms,"
        f" bound {bound_ms:.5f} ms")

    # ---- 4. VO at full width ----
    with open(os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                           "vo_orbit_640x480.json")) as f:
        ref = json.load(f)
    stencil.LAUNCHES = 0
    sys_, poses, frame_ms, total_s = run_vo(torch, ref, profile=False)
    launches = stencil.LAUNCHES
    st = sys_.stats.snapshot()
    n = ref["n_frames"]
    traj = sys_.trajectory_array()
    ate = float(ate_rmse(traj, poses))
    jref = np.asarray(ref["trajectory_c2w_sim3"])
    assert traj.shape == jref.shape, (traj.shape, jref.shape)
    dc = np.linalg.norm(traj[:, 4:7] - jref[:, 4:7], axis=1)
    da = np.asarray([rotation_angle(a[0:4], b[0:4])
                     for a, b in zip(traj, jref)])
    kfs = [kf.id for kf in sys_.keyframes]
    created = int(st.get("keyframes_created", 0))
    syncs = (st.get("host_syncs", 0) + st.get("lm_syncs", 0)
             + st.get("export_syncs", 0) + st.get("switch_syncs", 0))
    steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
    log(f"[vo] N={n} {ref['width']}x{ref['height']} keyframes={kfs} "
        f"(reference {ref['keyframe_ids']}) created={created} "
        f"ATE={ate:.6g} (reference {ref['ate']:.6g})")
    log(f"[vo] max |centre - ref| {dc.max():.3g}, max rot diff "
        f"{da.max():.3g} rad, bound {TRAJ_BOUND:g}")
    log(f"[vo] fps {len(steady) / (sum(steady) / 1e3):.3f} (frames 2..N-1), "
        f"p50 {np.percentile(frame_ms, 50):.3f} ms, p95 "
        f"{np.percentile(frame_ms, 95):.3f} ms, first "
        f"{frame_ms[0]:.1f} ms, total {total_s:.2f} s")
    log(f"[vo] host syncs per tracked frame {syncs / max(n - 1, 1):.2f} "
        f"(pack pulls {st.get('host_syncs', 0):.0f}, LM trial flags "
        f"{st.get('lm_syncs', 0):.0f}, exports "
        f"{st.get('export_syncs', 0):.0f}, switch rescales "
        f"{st.get('switch_syncs', 0):.0f})")
    log(f"[vo] stencil launches {launches} over {n - 1} tracked frames")
    log(f"[vo] stage ms (dispatch windows): {sys_.timers.summary()}")
    assert sys_.tracking_is_good, "tracking lost"
    assert created >= 1, "no keyframe switch"
    assert launches >= n, f"stencil launched {launches} < {n} frames"
    assert ate < 0.01, f"ATE {ate}"
    assert dc.max() <= TRAJ_BOUND and da.max() <= TRAJ_BOUND, (
        f"trajectory off the JAX reference: centre {dc.max()}, "
        f"rotation {da.max()}")

    # the stencil once more on the main path's own final state
    s = sys_.map.state
    max_err = max(max_err, compare_stencil(
        torch, stencil, [s.idepth, s.var, s.valid.float(), s.validity],
        reg_dist_var, diff_fac))

    # profiled pass: stage timers synchronise, so each stage is device time
    psys, _, pframe_ms, _ = run_vo(torch, ref, profile=True)
    log(f"[vo-profiled] p50 {np.percentile(pframe_ms, 50):.3f} ms; stages: "
        f"{psys.timers.summary()}")
    profile_vo(torch, ref)

    log(json.dumps({"kernels": [{
        "name": "regularize_accumulators",
        "route": "cuda",
        "source": "lsd_slam_tpu_torch/csrc/regularize_stencil.cu",
        "replaces": "lsd_slam_tpu/ops/pallas_stencil.py:94",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the five "
                        "accumulators",
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
