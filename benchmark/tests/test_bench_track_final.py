"""The reader of `track_final_fused_pct` on stand-in runs: the share of
tracked frames whose final pass ran in the kernel, 0 where none did, and
nothing where the program keeps no such counter or tracked no frame."""

from types import SimpleNamespace

import pytest

from benchmark.metrics import track_final_fused_pct as metric


def _run(start, end):
    stream = SimpleNamespace(stats_start=start, stats_end=end)
    return SimpleNamespace(
        stream=stream,
        counter=lambda k: float(end.get(k, 0.0) - start.get(k, 0.0)))


@pytest.mark.parametrize("fused,want", [(300.0, 100.0), (150.0, 50.0),
                                        (0.0, 0.0)])
def test_share_of_the_window_s_tracks(fused, want):
    run = _run({"frames_tracked": 10.0, "track_final_fused": 10.0},
               {"frames_tracked": 310.0, "track_final_fused": 10.0 + fused})
    assert metric.read(run) == pytest.approx(want)


@pytest.mark.parametrize("start,end", [
    ({"frames_tracked": 10.0}, {"frames_tracked": 310.0}),
    ({}, {}),
    ({"frames_tracked": 5.0, "track_final_fused": 5.0},
     {"frames_tracked": 5.0, "track_final_fused": 5.0})])
def test_reads_nothing_without_the_counter_or_frames(start, end):
    assert metric.read(_run(start, end)) is None
