"""Share of the window's frames on which the current keyframe
changed (engine loop: a new keyframe or a re-activated one), counted by
the harness around each call."""


def read(run):
    frames = run.window_frames()
    if not frames:
        return None
    return 100.0 * sum(f.switched for f in frames) / len(frames)
