"""How long the host waits for the card at an ordinary frame's one sync:
the mean of the program's `pull.pack` spans (the frame's pack pulled to
the host, `SlamSystem._retire`) inside a `retire` span, in the window's
frames that ran a `frame_step` (harness/spans.py)."""

from benchmark.harness import spans as sp


def read(run):
    spans = sp.window_spans(run)
    if spans is None:
        return None
    steps = {s.frame_id for s in spans if s.name == "frame_step"}
    return sp.mean_ms([s for s in sp.under(spans, "pull.pack", "retire")
                       if s.frame_id in steps])
