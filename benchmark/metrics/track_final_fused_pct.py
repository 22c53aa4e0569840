"""Tracks whose final pass ran inside the last `lm_level` launch, % (frame
step, tracking/se3_tracker.py): the program's counter `track_final_fused`
(bumped at each retired frame, by 1 where the track's final pass and tail
ran in the kernel's epilogue, by 0 where torch ops ran them) over
`frames_tracked`. A program without the counter (one that never bumps
it) reads nothing."""


def read(run):
    tracked = run.counter("frames_tracked")
    if tracked <= 0 or "track_final_fused" not in run.stream.stats_end:
        return None
    return 100.0 * run.counter("track_final_fused") / tracked
