"""Constraint-search ms a new keyframe (back end,
mapping/keyframe_graph.py): the program's counters `sim3_stage{0,1,2}_ms`
over `sim3_stage0_n`, the window's share of them."""


def read(run):
    n = run.counter("sim3_stage0_n")
    if n <= 0:
        return None
    return sum(run.counter(f"sim3_stage{k}_ms") for k in range(3)) / n
