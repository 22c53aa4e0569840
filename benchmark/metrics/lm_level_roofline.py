"""The frame step's `lm_level` launches' share of their roofline
(csrc/lm_track.cu, kernel `lm_level_kernel`; one launch a pyramid level
of each SE(3) track): the least time the card could take for them over
the device time of every `lm_level` launch in the window. The counts are
the program's counters `lm_points_l<k>` (valid points a level, summed
over the frame steps) and `lm_point_passes_l<k>` (points x passes: the
first pass and one a trial), which the engine keeps while it records
spans; the frame steps are its `frame_step` spans (harness/spans.py).

The time is that of every launch, not only of those launched inside a
frame step: the quick tracks of a switch frame add time and no count, so
the share can read low by their part, but it does not depend on where
the trace's launches land on the program's spans.

The bound is `chip_smoke.py`'s `lm_bound` (lines 2932-2958 at commit
e1b14f9, with `LM_OPS_PER_POINT` of line 478): every input read once (the
point fields, 21 B a point; the level's quad layout, 48 B a pixel; the
pose and affine pair) and every output written once, against
LM_OPS_PER_POINT operations a point for each pass. Valid points stand for
the slots the launch is given, which never counts too many bytes or
operations. Each level's bytes and operations are summed over the window
and the larger of the two bounds taken, which never exceeds the sum of
the launches' own bounds."""

from benchmark.harness import roofline
from benchmark.harness import spans as sp

LM_OPS_PER_POINT = 175 + 33
POINT_BYTES = 8 + 4 + 4 + 4 + 1       # idx int64; ival, idp, ivr f32; valid
QUAD_BYTES_PER_PX = 12 * 4
# pose (7) and affine pair in; pose, affine pair, last error, diverged (1
# B), trials and accepts out
LAUNCH_BYTES = (7 + 2) * 4 + (7 + 2 + 1) * 4 + 1 + 2 * 4
MAX_LEVELS = 8


def level_bytes(points: float, pixels: int, launches: float) -> float:
    return POINT_BYTES * points + launches * (QUAD_BYTES_PER_PX * pixels
                                              + LAUNCH_BYTES)


def level_ops(point_passes: float) -> float:
    return LM_OPS_PER_POINT * point_passes


def read(run):
    spans = sp.window_spans(run)
    if spans is None:
        return None
    steps = sum(s.name == "frame_step" for s in spans)
    n, seconds = run.kernel("lm_level_kernel")
    levels = [k for k in range(MAX_LEVELS)
              if run.counter(f"lm_point_passes_l{k}") > 0]
    if not steps or not n or seconds <= 0 or not levels:
        return None
    bound = sum(roofline.bound_s(
        level_bytes(run.counter(f"lm_points_l{k}"),
                    (run.width >> k) * (run.height >> k), steps),
        level_ops(run.counter(f"lm_point_passes_l{k}"))) for k in levels)
    return 100.0 * bound / seconds
