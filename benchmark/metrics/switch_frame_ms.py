"""Host ms of a frame on which the current keyframe changed (engine loop:
the call that re-activates a keyframe or creates one, with its
constraint search and PGO), mean over the window's switch frames, timed
by the harness around each call."""


def read(run):
    ms = [(f.t_end - f.t_start) / 1e6 for f in run.window_frames()
          if f.switched]
    return sum(ms) / len(ms) if ms else None
