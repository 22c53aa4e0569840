"""Configuration tree for lsd_slam_tpu_torch.

A verbatim copy of lsd_slam_tpu/config.py: the port keeps its own copy so
it never imports the JAX package, and the parity tests assert that both
trees hold the same defaults field by field.

One frozen dataclass tree replaces the reference's three config tiers
(compile-time constants, runtime globals mutable via dynamic_reconfigure, and
hotkeys — lsd_slam_core/src/util/settings.{h,cpp}).  Every field keeps the
semantic meaning (and default value) of the corresponding reference constant
so behaviour parity is auditable field-by-field; see the per-field citations.

All configs are frozen & hashable so they can be closed over / passed as
static args to jitted functions; anything that must vary at runtime without
recompilation is an array argument instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DepthFilterConfig:
    """Semi-dense inverse-depth filter constants.

    Mirrors the stereo / variance / validity constant blocks of
    ``settings.h:50-140`` (validity handling, depth-variance handling,
    stereo & gradient calculation, smoothing/regularization).
    """

    # --- validity handling (settings.h:52-66) ---
    validity_counter_max: float = 5.0
    validity_counter_max_variable: float = 250.0
    validity_counter_inc: int = 5
    validity_counter_dec: int = 5
    validity_counter_initial_observe: int = 5
    val_sum_min_for_create: int = 30
    val_sum_min_for_keep: int = 24
    val_sum_min_for_unblacklist: int = 100
    min_blacklist: int = -1

    # --- depth variance handling (settings.h:71-79) ---
    succ_var_inc_fac: float = 1.01
    fail_var_inc_fac: float = 1.1
    max_var: float = 0.25  # 0.5^2
    var_gt_init_initial: float = 0.0001  # 0.01^2
    var_random_init_initial: float = 0.125  # 0.5 * max_var

    # --- stereo & gradient (settings.h:110-135) ---
    min_depth: float = 0.05
    max_epl_length_crop: float = 30.0
    min_epl_length_crop: float = 3.0
    gradient_sample_dist: float = 1.0
    sample_point_to_border: int = 7
    max_error_stereo: float = 1300.0
    min_distance_error_stereo: float = 1.5
    stereo_epl_var_fac: float = 2.0
    # fixed step budget for the masked EPL search (TPU-native: the reference's
    # variable-length walk, DepthMap.cpp:1442-1972, becomes a static lattice;
    # 32 covers max_epl_length_crop / gradient_sample_dist == 30 steps)
    epl_search_steps: int = 32

    # --- smoothing / regularization (settings.h:140-152) ---
    reg_dist_var_base: float = 0.075 * 0.075  # times depth_smoothing_factor^2
    diff_fac_smoothing: float = 1.0
    diff_fac_observe: float = 1.0
    diff_fac_prop_merge: float = 1.0
    diff_fac_inconsistent: float = 1.0

    # --- initial stereo pixel selection (settings.h:157-166) ---
    min_epl_grad_squared: float = 4.0
    min_epl_length_squared: float = 1.0
    min_epl_angle_squared: float = 0.09


@dataclass(frozen=True)
class TrackerConfig:
    """LM schedule + robust-weight constants for SE3/Sim3 direct alignment.

    Mirrors ``DenseDepthTrackerSettings`` (settings.h:355-402) plus the
    tracking-quality thresholds (settings.h:160-174).
    """

    lambda_success_fac: float = 0.5
    lambda_fail_fac: float = 2.0
    lambda_initial: float = 0.0
    # per-level LM iteration caps, index = pyramid level (settings.h:368)
    max_iterations: tuple = (5, 20, 50, 100, 100, 100)
    step_size_min: float = 1e-8
    convergence_eps: float = 0.999
    # number of consecutive LM rejections before giving up a level
    max_lm_rejects: int = 6
    huber_d: float = 3.0
    var_weight: float = 1.0

    # quick "test track" schedule (permaRef relocalization / KF search,
    # settings.h:379-382)
    max_its_test_track: int = 5
    convergence_eps_test_track: float = 0.98
    step_size_min_test_track: float = 1e-3

    # tracking pyramid range (settings.h:98-99); level 0 is full resolution
    min_level: int = 1
    max_level: int = 4  # inclusive; reference SE3TRACKING_MAX_LEVEL=5 exclusive
    quick_kf_check_level: int = 4

    # robust weighting constants (settings.h:168-174, SE3Tracker.cpp:475-477)
    max_diff_constant: float = 1600.0  # 40^2
    max_diff_grad_mult: float = 0.25  # 0.5^2
    min_goodpergoodbad_pixel: float = 0.5
    min_goodperall_pixel: float = 0.04
    min_goodperall_pixel_absmin: float = 0.01

    # divergence: tracked in-image point fraction below this => diverged
    # (SE3Tracker.cpp:324-329: 1% of pixels at that level)
    min_inimage_fraction: float = 0.01

    # affine lighting estimation a*I+b (settings.cpp:  useAffineLightningEstimation)
    use_affine_lighting: bool = True
    # ESM-style gradient averaging for Sim3 tracking (settings.h:85)
    use_esm_sim3: bool = True


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection / constraint search / relocalization knobs.

    Mirrors the runtime globals in ``settings.cpp:75-100`` and the
    selection score in ``SlamSystem.cpp:996-1020``.
    """

    kf_dist_weight: float = 4.0
    kf_usage_weight: float = 3.0
    max_loop_closure_candidates: int = 10
    max_far_candidates_factor: int = 2  # far cap = max_candidates/2+5 like ref
    loop_closure_strictness: float = 1.5
    relocalization_th: float = 0.7
    min_num_mapped: int = 5  # MIN_NUM_MAPPED, settings.h:174
    initialization_phase_count: int = 5  # settings.h:172
    do_kf_reactivation: bool = True
    # Sim3 coarse-to-fine acceptance thresholds x strictness
    # (SlamSystem.cpp:1140-1202: 3000/4000/6000)
    constraint_err_lvl3: float = 3000.0
    constraint_err_lvl2: float = 4000.0
    constraint_err_lvl1: float = 6000.0
    # reciprocal SE3 closeness pre-check (SlamSystem.cpp:1283-1310)
    close_consistency_th: float = 0.09
    # far candidates require graph distance >= this (SlamSystem.cpp:1314-1337)
    far_graph_dist_min: int = 4
    # batch size for vmapped candidate quick-checks (TPU-native; ref is serial)
    candidate_batch: int = 16
    # idle re-track fires only once this many keyframes exist
    # (SlamSystem.cpp:280: keyframesForRetrack.size() > 10)
    retrack_min_keyframes: int = 10


@dataclass(frozen=True)
class MappingConfig:
    """Depth-map update orchestration (doMapping path)."""

    min_use_grad: float = 5.0  # settings.cpp:84 minUseGrad
    camera_pixel_noise2: float = 16.0  # settings.cpp:85 (4*4)
    depth_smoothing_factor: float = 1.0
    allow_negative_idepths: bool = True
    use_subpixel_stereo: bool = True
    max_unmapped_queue: int = 50  # SlamSystem.cpp:1023-1027
    max_unmapped_queue_young_kf: int = 100


@dataclass(frozen=True)
class SystemConfig:
    """Top-level engine switches (doSlam etc., settings.cpp:92-99)."""

    do_slam: bool = True
    do_mapping: bool = True
    use_fabmap: bool = False
    # shard batched candidate checks / distributed PGO over the local device
    # mesh whenever more than one device is visible (pod slice, or the
    # virtual CPU mesh in tests); single-device runs are unaffected
    use_device_mesh: bool = True
    pyramid_levels: int = 5  # PYRAMID_LEVELS, settings.h:104
    # sequential-deterministic mode: tracking blocks until mapping drains the
    # queue (the reference's hz=0 semantics, SlamSystem.cpp:1030-1039); the
    # TPU build makes this path fully deterministic.
    sequential: bool = True
    # Pipelined frame retirement: keep up to this many fused frame-step
    # programs in flight, chaining each frame's tracking init from the
    # previous frame's DEVICE pose and pulling host scalars only once their
    # async device->host copy has landed. Host-side decisions (loss,
    # keyframe selection) lag by this many frames — exactly the lag the
    # reference's tracking thread has relative to its mapping thread
    # (SlamSystem.cpp:1023-1039) — but the math is bit-identical to lag 0
    # and the schedule is deterministic. 0 = block every frame (hz=0).
    # This is the TPU-native replacement for thread overlap: on
    # remote-attached chips a blocking per-frame sync costs ~25 ms of
    # round-trip latency; 3 deep in flight hides all of it.
    pipeline_lag: int = 0
    # pose-graph optimizer slice size (SlamSystem.cpp:377: 5-iteration slices)
    pgo_iterations_per_slice: int = 5
    # cap on synchronous PGO slices per new-keyframe update (the reference
    # runs slices on a dedicated thread; inline callers must bound the stall)
    pgo_max_slices_per_update: int = 3
    pgo_final_iterations: int = 50
    pgo_min_change: float = 0.02
    pgo_final_min_change: float = 0.001
    # re-run constraint search over every keyframe before the final
    # optimization (== doFullReConstraintTrack, SlamSystem.cpp:332-350)
    full_reconstraint_on_finalize: bool = False
    # Measurement mode: stage pose-graph results but do NOT merge them
    # into the live pose tree until finalize — the track-time trajectory
    # then shows raw accumulated drift, isolating how much the
    # optimization corrects (the reference merges continuously,
    # SlamSystem.cpp:176-202, which makes before/after comparisons
    # near-degenerate; this flag exists for honest benchmarking)
    defer_pgo_merge: bool = False
    # profiling mode: stage timers block until the device drains so the
    # numbers are true per-stage device cost, not dispatch windows
    profile_sync: bool = False


@dataclass(frozen=True)
class LSDConfig:
    """The full config tree. Frozen + hashable => usable as a static jit arg."""

    width: int = 640
    height: int = 480
    tracker: TrackerConfig = TrackerConfig()
    sim3_tracker: TrackerConfig = TrackerConfig()
    depth: DepthFilterConfig = DepthFilterConfig()
    mapping: MappingConfig = MappingConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    system: SystemConfig = SystemConfig()

    def __post_init__(self):
        if self.width % 16 != 0 or self.height % 16 != 0:
            # the reference hard-requires multiples of 16 (SlamSystem.cpp:55-58)
            raise ValueError(
                f"image dims must be multiples of 16, got {self.width}x{self.height}"
            )

    def replace(self, **kw) -> "LSDConfig":
        return dataclasses.replace(self, **kw)

    def program_key(self) -> "LSDConfig":
        """Canonical config for the module-level program caches.

        Jitted program CONTENT depends on the geometry/numerics fields
        (dims, tracker/depth/mapping configs, pyramid levels) — not on
        runtime orchestration switches like profile_sync, sequential mode
        or PGO slice scheduling. Keying the caches on this canonical form
        lets a profiling run, a sequential run and an async run of the
        same engine share one compiled program set instead of recompiling
        ~50 s of programs per toggle."""
        return dataclasses.replace(
            self,
            keyframe=KeyframeConfig(),
            system=SystemConfig(pyramid_levels=self.system.pyramid_levels))


DEFAULT_CONFIG = LSDConfig()
