"""Host ms of the frame step's track (`slam_system.frame_step`'s `track`
stage: the SE(3) tracker's dispatch, one `lm_level` launch a level): the
mean of the program's `track` spans inside a `frame_step` span in the
window (harness/spans.py). A dispatch window on the host, not device
time."""

from benchmark.harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    return None if spans is None else sp.mean_ms(
        sp.under(spans, "track", "frame_step"))
