"""Device operations a frame: every kernel, copy and fill the trace holds
inside the window, over the frames completed in it."""


def read(run):
    frames = len(run.window_frames())
    if not run.traced or not frames or not len(run.events):
        return None
    return len(run.events) / frames
