"""Device ms of one frame's undistortion (camera/undistort.py): the union
of the device intervals of the operations that the harness's call to the
program's undistorter launched (named by the trace's correlation of
launches and operations), mean over the window's frames."""


def read(run):
    frames = {f.t_start for f in run.window_frames()}
    spans = [(a, b) for a, b in run.stream.und_spans if a in frames]
    ms = run.launched_in(spans)
    if not ms:
        return None
    return 1e3 * sum(ms) / len(ms)
