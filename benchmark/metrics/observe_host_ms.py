"""Host ms of the frame step's observe sweep (`slam_system.frame_step`'s
`observe` stage: the EPL set-up, compaction, search and fusion, then fill
holes, regularise and export): the mean of the program's `observe` spans
inside a `frame_step` span in the window (harness/spans.py). A dispatch
window on the host, not device time."""

from benchmark.harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    return None if spans is None else sp.mean_ms(
        sp.under(spans, "observe", "frame_step"))
