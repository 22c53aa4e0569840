"""Eligible pixels a sweep's budget left unsearched, % (frame step,
depth/depth_map.py): the program's counter `observe_unsearched` (each
sweep's eligible count, the stats' `active`, less its budget where it
is more, summed) over `observe_active`. LSD-SLAM searches every eligible
pixel; the port's compaction keeps the first `budget` of them, rolled
by the frame id. A program without the counters (none counts
`observe_slots`) reads nothing."""


def read(run):
    active = run.counter("observe_active")
    if run.counter("observe_slots") <= 0 or active <= 0:
        return None
    return 100.0 * run.counter("observe_unsearched") / active
