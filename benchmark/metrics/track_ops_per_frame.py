"""Kernels a frame launched by the frame step's track: the trace's
kernels whose launch (the host's runtime call, matched by correlation
id) lies inside a `track` span of a `frame_step` span
(harness/spans.py), over the frames completed in the window. The memory
copies and fills that `device_ops_per_frame` also counts are left out:
the trace keeps no host call for them (harness/trace.py)."""

from benchmark.harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    frames = len(run.window_frames())
    if spans is None or not frames:
        return None
    mask = sp.launched(run, sp.under(spans, "track", "frame_step"))
    return None if mask is None else float(mask.sum()) / frames
