"""Host ms of a frame step (`slam_system.frame_step`: pyramid, track,
observe): the program's `StageTimers` `frame_step` samples taken in the
window. They time the dispatch window on the host, not the
device's work."""


def read(run):
    samples = run.stream.timer_samples
    return sum(samples) / len(samples) if samples else None
