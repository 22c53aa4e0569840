"""PGO ms a solve (pose graph, mapping/pose_graph.py): the program's
counters `pgo_ms` over `pgo_calls`, the window's share.
`pgo_ms` is the host wall around a solve, its pull included."""


def read(run):
    n = run.counter("pgo_calls")
    return run.counter("pgo_ms") / n if n > 0 else None
