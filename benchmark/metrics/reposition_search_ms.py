"""Host ms of a switch frame's search for a keyframe to re-activate
(`KeyFrameGraph.find_reposition_candidate`: the Euclidean overlap set,
one overlap pull and a quick track a candidate): the mean of the
program's `reposition_search` spans in the window, one a switch frame
(harness/spans.py)."""

from benchmark.harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    return None if spans is None else sp.mean_ms(
        [s for s in spans if s.name == "reposition_search"])
