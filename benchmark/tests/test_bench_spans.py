"""The readers of the program's spans and the rooflines computed from its
counts, on a synthetic run: made-up spans, device operations and host
launches on one clock. Each reader gives its value, and None where the
run holds nothing to read (a program without the span recorder, a run
without a trace). The copied `lm_level` and EPL-search bounds agree with
`chip_smoke.py`'s own functions."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.harness import roofline
from benchmark.harness import spans as sp
from benchmark.harness.window import Run
from benchmark.metrics import (epl_stereo_roofline, lm_level_roofline,
                               observe_host_ms, observe_ops_per_frame,
                               reposition_search_ms, retire_wait_ms,
                               track_host_ms, track_ops_per_frame)
from lsd_slam_tpu_torch.ops import lm_track
from lsd_slam_tpu_torch.utils.stats import Span

MS = 1_000_000
W, H = 640, 480
NAMES = ["(anonymous namespace)::lm_level_kernel(long const*)",
         "void at::native::vectorized_elementwise_kernel<4>",
         "(anonymous namespace)::epl_stereo_kernel(Args)"]
READERS = (track_host_ms, observe_host_ms, track_ops_per_frame,
           observe_ops_per_frame, retire_wait_ms, reposition_search_ms,
           lm_level_roofline, epl_stereo_roofline)


class Timers:
    def __init__(self, spans):
        self._spans = spans

    def spans(self, t0, t1):
        return [s for s in self._spans if s.start_ns >= t0 and s.end_ns <= t1]


def _spans():
    """Frame 1 (ordinary) from 0 to 20 ms, frame 2 (a switch frame) from
    20 to 60 ms, frame 3 (ordinary) from 60 to 80 ms, with a gc pause in
    frame 3's observe."""
    rows = []

    def add(name, a, b, frame, parent):
        rows.append(Span(len(rows) + 1, name, a * MS, b * MS, frame, parent,
                         1))
        return len(rows)

    for f, t in ((1, 0), (3, 60)):
        root = add("track_frame", t, t + 20, f, 0)
        step = add("frame_step", t, t + 12, f, root)
        add("pyramid", t, t + 1, f, step)
        add("track", t + 1, t + 5, f, step)
        obs = add("observe", t + 5, t + 12, f, step)
        if f == 3:
            add("gc", t + 8, t + 10, f, obs)
        ret = add("retire", t + 12, t + 20, f, root)
        add("pull.pack", t + 12, t + 18 + (f == 3) * 2, f, ret)
    root = add("track_frame", 20, 60, 2, 0)
    add("switch_track", 20, 24, 2, root)
    ret = add("retire", 24, 26, 2, root)
    add("pull.pack", 24, 25, 2, ret)
    sw = add("switch", 26, 60, 2, root)
    rs = add("reposition_search", 30, 56, 2, sw)
    add("pull.overlap", 31, 33, 2, rs)
    # a `track` outside any frame step is not the frame step's
    add("track", 56, 58, 2, sw)
    return rows


def _frames():
    return [SimpleNamespace(index=i, t_start=a * MS, t_end=b * MS,
                            pose=np.zeros(8), switched=i == 2)
            for i, (a, b) in ((1, (0, 20)), (2, (20, 60)), (3, (60, 80)))]


def _trace():
    """Device operations (name index, start, end, correlation) and the
    host's launches (start, correlation)."""
    launches = [(2 * MS, 10), (3 * MS, 11), (6 * MS, 12), (62 * MS, 20),
                (63 * MS, 21), (66 * MS, 22), (67 * MS, 23), (32 * MS, 30),
                (57 * MS, 31)]
    events = [(0, 2 * MS, 3 * MS, 10), (1, 3 * MS, 4 * MS, 11),
              (2, 7 * MS, 7 * MS + 40_000, 12),
              (0, 62 * MS, 63 * MS, 20), (1, 63 * MS, 64 * MS, 21),
              (2, 67 * MS, 67 * MS + 60_000, 22), (1, 71 * MS, 72 * MS, 23),
              (0, 33 * MS, 34 * MS, 30), (0, 57 * MS, 58 * MS, 31)]
    la = np.asarray(sorted(launches), np.int64)
    return list(NAMES), np.asarray(events, np.int64), la


COUNTERS = {"lm_points_l1": 30_000.0, "lm_point_passes_l1": 180_000.0,
            "lm_points_l2": 10_000.0, "lm_point_passes_l2": 80_000.0,
            "observe_processed": 9_000.0}


def _run(spans=True, trace=True, counters=COUNTERS, timers=None):
    frames = _frames()
    if timers is None:
        timers = Timers(_spans() if spans else [])
    stream = SimpleNamespace(
        frames=frames, sys=SimpleNamespace(timers=timers),
        in_window=lambda t: [f for f in frames if f.t_end <= t],
        counter=lambda k: counters.get(k, 0.0))
    names, events, launches = _trace() if trace else (None, None, None)
    return Run(None, stream, 0, 100 * MS, (W, H), names, events, launches)


def test_host_ms_of_the_frame_steps_stages():
    run = _run()
    assert track_host_ms.read(run) == pytest.approx(4.0)
    assert observe_host_ms.read(run) == pytest.approx(7.0)


def test_ops_launched_inside_the_stages_per_frame():
    run = _run()
    # track: correlations 10, 11, 20, 21 (the switch frame's stray `track`
    # is not a frame step's); observe: 12, 22, 23; over three frames
    assert track_ops_per_frame.read(run) == pytest.approx(4 / 3)
    assert observe_ops_per_frame.read(run) == pytest.approx(3 / 3)
    assert track_ops_per_frame.read(run) + observe_ops_per_frame.read(
        run) <= len(run.events) / 3


def test_retire_wait_reads_ordinary_frames_only():
    assert retire_wait_ms.read(_run()) == pytest.approx((6 + 8) / 2)


def test_reposition_search_mean():
    assert reposition_search_ms.read(_run()) == pytest.approx(26.0)


def test_lm_level_roofline_from_counts():
    run = _run()
    # every lm_level launch, 1 ms each: the frame steps' (correlations 10
    # and 20) and the switch frame's (30, 31); the bytes count one launch
    # a level of each of the two frame steps
    steps, seconds = 2, 4e-3
    want = 0.0
    for k in (1, 2):
        b = lm_level_roofline.level_bytes(
            COUNTERS[f"lm_points_l{k}"], (W >> k) * (H >> k), steps)
        o = lm_level_roofline.level_ops(COUNTERS[f"lm_point_passes_l{k}"])
        want += roofline.bound_s(b, o)
    got = lm_level_roofline.read(run)
    assert got == pytest.approx(100 * want / seconds)
    assert 0 < got <= 100


def test_epl_stereo_roofline_from_counts():
    run = _run()
    n, seconds = 2, 100e-6
    want = roofline.bound_s(
        epl_stereo_roofline.search_bytes(9000.0, W * H, n),
        epl_stereo_roofline.search_ops(9000.0))
    assert epl_stereo_roofline.read(run) == pytest.approx(
        100 * want / seconds)


SPAN_READERS = (track_host_ms, observe_host_ms, retire_wait_ms,
                reposition_search_ms)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_nothing_to_read_gives_none(reader):
    """No spans, no trace and no counters; a program without the span
    recorder (the parent commit's `StageTimers`)."""
    parent_timers = SimpleNamespace(ms={}, samples={})
    assert reader.read(_run(spans=False, trace=False, counters={})) is None
    assert reader.read(_run(timers=parent_timers, trace=False,
                            counters={})) is None
    parent = reader.read(_run(timers=parent_timers))
    if reader is epl_stereo_roofline:
        # the sweep counter is the program's own since before the spans
        assert parent is not None
    else:
        assert parent is None
    # the spans alone serve the host-time readers; the others need the
    # trace too
    untraced = reader.read(_run(trace=False))
    assert (untraced is not None) == (reader in SPAN_READERS)


def test_launches_missing_from_the_trace_give_none():
    run = _run()
    run.launches = np.zeros((0, 2), np.int64)
    for reader in (track_ops_per_frame, observe_ops_per_frame):
        assert reader.read(run) is None
    # the rooflines read the kernels' device time, not their launches
    assert lm_level_roofline.read(run) == lm_level_roofline.read(_run())


@pytest.mark.parametrize("shift_ms", [-7, -3, 3, 7])
def test_lm_level_roofline_does_not_follow_the_launch_times(shift_ms):
    # launches placed off the program's spans (a trace whose clock is
    # off by a few ms) move the per-stage ops but not the roofline
    run = _run()
    run.launches = run.launches.copy()
    run.launches[:, 0] += shift_ms * MS
    assert track_ops_per_frame.read(run) != track_ops_per_frame.read(
        _run())
    assert lm_level_roofline.read(run) == lm_level_roofline.read(_run())


@pytest.mark.parametrize("points,pixels,trials", [
    (4854, 160 * 120, 9), (16000, 320 * 240, 5), (300, 40 * 30, 16),
    (2200, 94 * 60, 0)])
def test_lm_bound_agrees_with_chip_smoke(points, pixels, trials):
    f32 = torch.float32
    pts = SimpleNamespace(**{
        f: torch.zeros(points, dtype=dt)
        for f, dt in zip(lm_track.POINT_FIELDS, lm_track._POINT_DTYPES)})
    args = (torch.zeros(7), torch.ones((), dtype=f32),
            torch.zeros((), dtype=f32), pts, torch.zeros((pixels, 12)))
    got = SimpleNamespace(
        pose=torch.zeros(7), aff_a=torch.ones(()), aff_b=torch.zeros(()),
        last_err=torch.zeros(()), diverged=torch.zeros((), dtype=torch.bool),
        trials=torch.tensor(trials, dtype=torch.int32),
        its=torch.tensor(trials, dtype=torch.int32))
    ms, _, passes = chip_smoke.lm_bound(args, got)
    assert passes == trials + 1
    mine = roofline.bound_s(
        lm_level_roofline.level_bytes(points, pixels, 1),
        lm_level_roofline.level_ops(points * (trials + 1)))
    assert mine * 1e3 == pytest.approx(ms, rel=1e-12)
    assert lm_level_roofline.LM_OPS_PER_POINT == chip_smoke.LM_OPS_PER_POINT
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S


@pytest.mark.parametrize("h,w,frames,budget,n_valid", [
    (480, 640, 1, 57344, 4854), (480, 752, 1, 65536, 21000),
    (128, 160, 3, 8192, 5000), (480, 640, 8, 57344, 33602)])
def test_epl_search_bound_agrees_with_chip_smoke(h, w, frames, budget,
                                                 n_valid):
    c = {"kf_img": np.zeros((h, w), np.float32), "ids": list(range(frames)),
         "budget": budget}
    nbytes, ops = chip_smoke.epl_bounds(c, n_valid)["epl_stereo"]
    assert epl_stereo_roofline.search_bytes(
        n_valid, h * w, 1, frames=frames, slots=budget) == nbytes
    assert epl_stereo_roofline.search_ops(n_valid) == ops
    # what the metric counts (one frame, no budget) is never more
    assert epl_stereo_roofline.search_bytes(n_valid, h * w, 1) <= nbytes
