"""The benchmark's arithmetic on the CPU: percentiles over every frame, a
rate over the window, the union of device intervals and its gaps, and the
kernels' bounds against the figures chip_smoke.py printed at 640x480."""

import numpy as np
import pytest

from benchmark.harness import roofline, stats


def test_percentile_is_over_every_frame():
    a = [10.0] * 95 + [100.0] * 5
    b = [20.0] * 100
    allf = a + b
    assert stats.percentile(allf, 95) == pytest.approx(
        float(np.percentile(np.asarray(allf), 95)))
    # not the mean of the percentiles of parts of the window
    assert stats.percentile(allf, 95) != pytest.approx(
        (stats.percentile(a, 95) + stats.percentile(b, 95)) / 2)
    assert stats.percentile(list(range(1, 101)), 50) == pytest.approx(50.5)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_over_the_window():
    assert stats.rate(600, 20.0) == pytest.approx(30.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_clips_merges_and_gaps():
    iv = [(5, 10), (8, 12), (20, 25), (-5, 2), (30, 40), (12, 13)]
    u = stats.union(iv, 0, 35)
    assert u == [(0, 2), (5, 13), (20, 25), (30, 35)]
    assert stats.covered(u) == 2 + 8 + 5 + 5
    assert stats.gaps(u, 0, 35) == [(2, 5), (13, 20), (25, 30)]
    assert stats.gaps([], 0, 10) == [(0, 10)]
    # overlapping device intervals count once
    assert stats.covered(stats.union([(0, 10), (0, 10), (5, 15)], 0, 20)) \
        == 15


def test_bounds_match_the_figures_chip_smoke_printed():
    # chip_smoke.py's kernels line at 480x640: the fused stencil's bound
    # 0.00348 ms (38 B a pixel), the set-up's and fusion's 0.00679 ms
    # (74 B a pixel each)
    assert roofline.regularize_fused_s(480, 640) * 1e3 == pytest.approx(
        0.00348, abs=5e-6)
    assert roofline.regularize_fused_s(480, 640) == pytest.approx(
        38 * 480 * 640 / 3.35e12)
    assert roofline.epl_prepare_s(480, 640) * 1e3 == pytest.approx(
        0.00679, abs=5e-6)
    assert roofline.observe_fuse_s(480, 640) * 1e3 == pytest.approx(
        0.00679, abs=5e-6)
    # several frames move more bytes, never fewer
    assert roofline.epl_prepare_s(480, 640, 3) > roofline.epl_prepare_s(
        480, 640)
    assert roofline.observe_fuse_s(480, 640, 3) > roofline.observe_fuse_s(
        480, 640)
    # all three are bound by bytes
    n = 480 * 640
    assert 38 * n / roofline.HBM_BYTES_PER_S > \
        roofline.REGULARIZE_OPS_PER_PX * n / roofline.F32_FLOP_PER_S


class _Stream:
    """A stream as the metrics read it: frames with host times, counters,
    timer samples, the undistorter's host spans."""

    def __init__(self, frames, counters=None, und_spans=()):
        self.frames = frames
        self.stats_start = {}
        self.stats_end = dict(counters or {})
        self.timer_samples = [20.0, 22.0]
        self.und_spans = list(und_spans)

    def in_window(self, t_end):
        return [f for f in self.frames if f.t_end <= t_end]

    def counter(self, key):
        return self.stats_end.get(key, 0.0) - self.stats_start.get(key, 0.0)


def _run(und_spans=(), launches=None):
    from benchmark.harness.stream import Frame
    from benchmark.harness.window import Run
    ms = 1_000_000
    # two frames: an ordinary one [0, 40) ms, a switch frame [40, 100) ms
    frames = [Frame(1, 0, 40 * ms, None, 0, 0),
              Frame(2, 40 * ms, 100 * ms, None, 0, 2)]
    names = ["void (anonymous namespace)::regularize_kernel<true>(Args)",
             "epl_prepare_kernel(LsdEplPtrs, LsdEplParams)", "other"]
    # device busy [10, 20) and [15, 30) ms (overlapping), [60, 61) ms; one
    # op before the window is clipped away; the last column is each op's
    # correlation id
    events = np.array([[0, 10 * ms, 20 * ms, 7], [2, 15 * ms, 30 * ms, 8],
                       [1, 60 * ms, 61 * ms, 9], [2, -5 * ms, -1 * ms, 3]])
    stream = _Stream(frames, {"host_syncs": 2, "pgo_ms": 90.0,
                              "pgo_calls": 2}, und_spans)
    return Run(None, stream, 0, 100 * ms, (640, 480), names, events,
               launches)


def test_window_reduction_from_events_and_frames():
    """The readers of every per-layer metric on a window of known frames,
    counters and device intervals."""
    from benchmark.harness.spec import metric_reader
    run = _run()
    assert run.seconds == pytest.approx(0.1)
    assert run.busy_s() == pytest.approx(0.021)
    assert metric_reader("device_idle_pct")(run) == pytest.approx(79.0)
    assert metric_reader("device_ops_per_frame")(run) == pytest.approx(1.5)
    assert metric_reader("switch_frame_pct")(run) == pytest.approx(50.0)
    assert metric_reader("switch_frame_ms")(run) == pytest.approx(60.0)
    assert metric_reader("host_syncs_per_frame")(run) == pytest.approx(1.0)
    assert metric_reader("pgo_ms_per_solve")(run) == pytest.approx(45.0)
    assert metric_reader("frame_step_host_ms")(run) == pytest.approx(21.0)
    assert metric_reader("constraint_ms_per_kf")(run) is None
    assert metric_reader("undistort_ms")(run) is None
    # one launch of each kernel: its bound over its 10 ms / 1 ms
    assert metric_reader("regularize_fused_roofline")(run) == pytest.approx(
        100 * roofline.regularize_fused_s(480, 640) / 0.010)
    assert metric_reader("epl_prepare_roofline")(run) == pytest.approx(
        100 * roofline.epl_prepare_s(480, 640) / 0.001)
    assert metric_reader("observe_fuse_roofline")(run) is None
    ops = run.device_ops()
    assert [n for n, _ in ops] == ["other", run.names[0], run.names[1]]
    assert ops[0][1] == pytest.approx(0.015)
    gaps = run.idle_gaps()
    # [61, 100) and [30, 60) fall in the switch frame's call, [0, 10) in
    # the ordinary one's
    assert gaps[0] == ["switch frame", pytest.approx(0.039)]
    assert gaps[1] == ["switch frame", pytest.approx(0.030)]
    assert gaps[2] == ["frame", pytest.approx(0.010)]


def test_undistort_ms_is_the_union_of_the_ops_its_call_launched():
    """The undistorter's device time in a frame: the ops whose launch lies
    in the harness's span around its call, by correlation id, their
    overlap counted once; ops launched outside it left out."""
    from benchmark.harness.spec import metric_reader
    ms = 1_000_000
    # launches at 1 ms (op 7: [10, 20) ms) and 2 ms (op 8: [15, 30) ms)
    # inside the first frame's span [0, 5) ms; op 9 launched at 41 ms,
    # outside the second frame's span [40, 40.5) ms
    launches = np.array([[1 * ms, 7], [2 * ms, 8], [41 * ms, 9]])
    run = _run(und_spans=[(0, 5 * ms), (40 * ms, 40 * ms + ms // 2)],
               launches=launches)
    assert run.launched_in([(0, 5 * ms)]) == [pytest.approx(0.020)]
    assert metric_reader("undistort_ms")(run) == pytest.approx(10.0)
    assert _run(und_spans=[(0, 5 * ms)]).launched_in([(0, 1)]) is None



def test_marker_offset_survives_a_missed_marker():
    """The trace's clock offset from the marker groups: every marker found,
    or some missed (the first after the profiler starts can go
    unrecorded), matched to their host times by the gaps between them."""
    from benchmark.harness.trace import marker_offset
    ms = 1_000_000
    host = [[1000 * ms, 1003 * ms + 100_000, 1010 * ms + 200_000],
            [5000 * ms, 5003 * ms + 50_000, 5010 * ms + 100_000]]
    off = 777_000
    every = [x + off for g in host for x in g]
    assert marker_offset(every, host) == off
    assert marker_offset(every[1:3] + every[5:], host) == off
    assert marker_offset([every[2], every[4]], host) == off
    with pytest.raises(RuntimeError):
        marker_offset(every[:3], host)
