"""One pyramid level's LM accept/reject loop, lane-batched (torch).

Port of the `lax.while_loop` programs of the JAX package's trackers:
`_track_level` (lsd_slam_tpu/tracking/se3_tracker.py:184-253, the SE(3)
schedule) and the loop of `_quick_impl`
(lsd_slam_tpu/tracking/quick_tracker.py:66-104, the quick test-track
schedule), both of SE3Tracker.cpp:343-448. Each trial damps A
(`A + lam * diag(diag A) + 1e-12 * I`), solves for the increment, moves
the pose by `se3_mul(se3_exp(inc), pose)`, runs the residual, weights and
normal-equation passes there, and accepts when `err < last_err` and the
level did not diverge.

`level` is what the trackers call. On the card it launches the kernel
`lm_level` (ops/lm_track.py, csrc/lm_track.cu): the whole loop runs on the
device and pulls nothing to the host. On the CPU it runs `level_plain`,
the loop in torch ops: every lane's state is a tensor updated with
`torch.where`, as the vmapped `while_loop` selects, so a lane whose `cond`
is false keeps its state; the lambda schedule is f32 tensor arithmetic.
The loop leaves when no lane is active (one host check per trial, counted
in `LevelResult.n_syncs`). Freezing makes a lane's result independent of
the other lanes: a lane that stops early keeps its state while the batch
runs on, so each lane of a batch equals the lane run alone, bit for bit.
The kernel relies on this: its lanes never wait on one another.

The plain version takes any leading lane shape: a pose (7,) with 0-d
affine values is the single SE(3) track, (B, 7) a batch. The affine pair
may be Python floats (the quick tracker's fixed (1, 0)).

For the SE(3) track on the card, `level` also takes what the kernel does
around the loop (se3_tracker.track_fused): `invert` (start at the inverse
of the pose given, the track's frame_to_ref), a None affine pair (start
at (1, 0)), `diverged` (the previous levels' flags, OR-ed into the
result) and `final` (the track's final pass after the loop, in
`LevelResult.final`, an ops.lm_track `FinalPass`). The plain loop takes
none of them: on the CPU se3_tracker.track_plain does these in torch ops.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import TrackerConfig
from lsd_slam_tpu_torch.tracking.reference import PointSet
# the passes, read at call time: se3_tracker imports this module in turn
from lsd_slam_tpu_torch.tracking import se3_tracker as _se3


@dataclass(frozen=True)
class Schedule:
    """The loop's constants. `quick` picks the quick tracker's lambda
    schedule; otherwise the SE(3) one with `lam0`, `success_fac` and
    `fail_fac`."""

    quick: bool
    max_its: int
    max_trials: int
    conv_eps: float
    step_min: float
    use_affine: bool
    lam0: float = 0.0
    success_fac: float = 0.5
    fail_fac: float = 2.0


def se3_schedule(cfg: TrackerConfig, max_its: int,
                 use_affine: bool) -> Schedule:
    """`_track_level`'s loop (lsd_slam_tpu/tracking/se3_tracker.py:207-250)."""
    return Schedule(quick=False, max_its=int(max_its),
                    max_trials=int(max_its) + 4 * cfg.max_lm_rejects,
                    conv_eps=cfg.convergence_eps,
                    step_min=cfg.step_size_min, use_affine=bool(use_affine),
                    lam0=cfg.lambda_initial,
                    success_fac=cfg.lambda_success_fac,
                    fail_fac=cfg.lambda_fail_fac)


def quick_schedule(cfg: TrackerConfig) -> Schedule:
    """`_quick_impl`'s loop (lsd_slam_tpu/tracking/quick_tracker.py:66-104):
    lambda from 0, halved on accept, 0.2 or x4 on reject; affine fixed."""
    its = cfg.max_its_test_track
    return Schedule(quick=True, max_its=its, max_trials=its * 3,
                    conv_eps=cfg.convergence_eps_test_track,
                    step_min=cfg.step_size_min_test_track, use_affine=False)


@dataclass
class LevelResult:
    """One level's loop result; the Sim(3) tracker's `level` returns it
    too, with (B, 8) Sim3 poses and tensor affine pairs."""

    pose: torch.Tensor        # (..., 7) SE3 ref -> frame
    aff_a: object             # (...) tensor, or the float given
    aff_b: object
    last_err: torch.Tensor    # (...) error of the last accepted pose
    diverged: torch.Tensor    # (...) bool
    trials: torch.Tensor      # (...) int32 trials run
    its: torch.Tensor         # (...) int32 trials accepted
    n_syncs: int = 0          # host checks the loop made (0 on the card)
    final: object = None      # the launch's final pass (ops.lm_track)


def level_plain(pose, aff_a, aff_b, pts: PointSet, frame_quad,
                cam: Camera, cfg: TrackerConfig, sigma2: float,
                sched: Schedule) -> LevelResult:
    """The level loop in torch ops. `cam` is the level's camera."""
    h, w = cam.height, cam.width
    min_points = cfg.min_goodperall_pixel_absmin * h * w
    dev = pose.device
    lead = pose.shape[:-1]
    f32, i32 = torch.float32, torch.int32
    eye6 = 1e-12 * torch.eye(6, dtype=f32, device=dev)

    def res(p, a, b):
        return _se3._residual_pass(p, a, b, pts, frame_quad, cam, cfg)

    buffers, stats = res(pose, aff_a, aff_b)
    diverged = stats["in_count"] < min_points
    if sched.use_affine:
        aff_a, aff_b = stats["aff_a_new"], stats["aff_b_new"]
    weight, last_err = _se3._weights_pass(pose, buffers, cfg, sigma2)
    A, g = _se3._normal_equations(buffers, weight)

    lam = torch.full(lead, sched.lam0, dtype=f32, device=dev)
    it = torch.zeros(lead, dtype=i32, device=dev)
    inc_try = torch.zeros(lead, dtype=i32, device=dev)
    trials = torch.zeros(lead, dtype=i32, device=dev)
    done = diverged.clone()
    syncs = 0
    for _ in range(sched.max_trials):
        active = (it < sched.max_its) & ~done & (trials < sched.max_trials)
        syncs += 1
        if not bool(active.any()):
            break
        # LM damping: A_ii *= (1 + lambda), off-diagonals untouched
        Ad = A + lam[..., None, None] * torch.diag_embed(
            torch.diagonal(A, dim1=-2, dim2=-1))
        inc = torch.linalg.solve_ex(Ad + eye6, g.unsqueeze(-1),
                                    check_errors=False)[0].squeeze(-1)
        new_pose = lie.se3_mul(lie.se3_exp(inc), pose)

        buffers, stats = res(new_pose, aff_a, aff_b)
        div = stats["in_count"] < min_points
        weight, err = _se3._weights_pass(new_pose, buffers, cfg, sigma2)
        A_new, g_new = _se3._normal_equations(buffers, weight)

        accept = (err < last_err) & ~div
        converged = err / torch.clamp_min(last_err, 1e-12) > sched.conv_eps
        step_small = torch.sum(inc * inc, dim=-1) < sched.step_min
        # lambda schedule (SE3Tracker.cpp:418-447), f32 on the device
        if sched.quick:
            lam_acc = torch.clamp_min(lam * 0.5, 0.0)
            lam_rej = torch.where(lam == 0, torch.full_like(lam, 0.2),
                                  lam * 4.0)
        else:
            lam_acc = torch.where(lam <= 0.2, torch.zeros_like(lam),
                                  lam * sched.success_fac)
            lam_rej = torch.where(
                lam == 0, torch.full_like(lam, 0.2),
                lam * sched.fail_fac ** (inc_try + 1).to(f32))

        take = active & accept
        pose = torch.where(take[..., None], new_pose, pose)
        if sched.use_affine:
            aff_a = torch.where(take, stats["aff_a_new"], aff_a)
            aff_b = torch.where(take, stats["aff_b_new"], aff_b)
        A = torch.where(take[..., None, None], A_new, A)
        g = torch.where(take[..., None], g_new, g)
        last_err = torch.where(take, err, last_err)
        lam = torch.where(active, torch.where(accept, lam_acc, lam_rej), lam)
        it = it + take.to(i32)
        inc_try = torch.where(active, torch.where(
            accept, torch.zeros_like(inc_try), inc_try + 1), inc_try)
        trials = trials + active.to(i32)
        done = done | (active & (div | (accept & converged)
                                 | (~accept & step_small)))
        diverged = diverged | (active & div)
    return LevelResult(pose, aff_a, aff_b, last_err, diverged, trials, it,
                       syncs)


def level(pose, aff_a, aff_b, pts: PointSet, frame_quad, cam: Camera,
          cfg: TrackerConfig, sigma2: float, sched: Schedule,
          invert: bool = False, diverged=None,
          final: bool = False) -> LevelResult:
    """One level's LM loop: the kernel `lm_level` for CUDA tensors, the
    plain version for CPU ones (anything else raises). `invert`, a None
    affine pair, `diverged` and `final` are the kernel's (see above)."""
    if pose.device.type == "cpu":
        if invert or aff_a is None or diverged is not None or final:
            raise ValueError("lm.level: invert, a None affine pair, "
                             "diverged and final are the kernel's; on the "
                             "CPU se3_tracker.track_plain does them")
        return level_plain(pose, aff_a, aff_b, pts, frame_quad, cam, cfg,
                           sigma2, sched)
    from lsd_slam_tpu_torch.ops import lm_track
    out = lm_track.lm_level(
        pose, aff_a, aff_b,
        tuple(getattr(pts, f) for f in lm_track.POINT_FIELDS), frame_quad,
        cam, cfg, sigma2, asdict(sched), invert=invert, diverged=diverged,
        final_n_valid=pts.n_valid if final else None)
    pose, a, b, err, div, trials, its = out[:7]
    # a Python float given for the affine pair comes back as given
    given = aff_a is not None and not torch.is_tensor(aff_a)
    return LevelResult(pose, aff_a if given else a, aff_b if given else b,
                       err, div, trials, its, n_syncs=0,
                       final=out[7] if final else None)
