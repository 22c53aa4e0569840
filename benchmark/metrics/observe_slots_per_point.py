"""Observe slots launched a searched point (frame step,
depth/depth_map.py): the program's counter `observe_slots` (the budget
`pick_budget` gave each observe sweep, summed) over `observe_processed`
(the points the sweeps searched). The budget ladder's waste: a sweep that
needs more than the third bucket launches the whole image's budget
(221,184 slots at 1280x1024). A program without the counter reads
nothing."""


def read(run):
    slots = run.counter("observe_slots")
    searched = run.counter("observe_processed")
    if slots <= 0 or searched <= 0:
        return None
    return slots / searched
