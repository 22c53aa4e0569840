"""Host syncs a frame (engine loop, system/slam_system.py): the program's
`RunningStats` counter `host_syncs` (one a pack pull) over the window's
calls."""


def read(run):
    n = run.frames_called()
    return run.counter("host_syncs") / n if n else None
