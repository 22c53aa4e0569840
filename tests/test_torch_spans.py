"""The port's span recorder (utils/stats.StageTimers) and the engine's
spans (CPU, no JAX).

The recorder: spans on perf_counter_ns with frame ids and parents, a
bounded ring that counts what it drops, per-thread parent stacks, `gc`
spans from the collector's callbacks, a shared no-op context when
tracing is off, bounded stage samples.

The engine: the 160x128 loop scenario of tests/_torch_slam_scenario.py
(its keyframe settings, two keyframe switches in 15 frames) run
without and within a torch.profiler, whose state the engine's span
tracing follows: off keeps no span and the parent's 34-entry frame pack;
on gives one root span a call, children inside their parents, the switch
frame's work and pulls, a `gc` span, and the rooflines' counters equal
to their values recomputed from the tracker's and the sweep's own
results, with the frame step's ops unchanged; poses and depth are
bit-equal.
"""

import contextlib
import gc
import threading

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.system import slam_system as ss
from lsd_slam_tpu_torch.tracking import se3_tracker
from lsd_slam_tpu_torch.utils import stats, synth
from torch.utils._python_dispatch import TorchDispatchMode
from _torch_slam_scenario import H, KEYFRAME, N, W

FRAMES = 16          # frame 0 seeds the map; 1..15 are tracked
GC_FRAME = 3         # a frame whose frame step runs gc.collect()
PACK = 23 + len(tobs.OBSERVE_STAT_KEYS) + 2


@pytest.fixture(scope="module")
def sequence():
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=13)
    poses = synth.loop_trajectory(N)
    return cam, [synth.render(scene, cam, poses[i], device="cpu")
                 for i in range(FRAMES)]


class _OpLog(TorchDispatchMode):
    """The names of the torch ops dispatched inside, views left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func.name())
        return func(*args, **(kwargs or {}))


def _engine(cam):
    cfg = LSDConfig(width=W, height=H).replace(
        keyframe=KeyframeConfig(**KEYFRAME))
    return SlamSystem(cam, cfg, device="cpu")


def _traced():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _run(cam, frames, mode):
    """One run of the scenario, within a torch.profiler where `mode` is
    "on", recording what the frame steps produced: the pack lengths, each
    level's valid points and LM trials, each sweep's searched slots, and
    each step's ops."""
    torch.set_num_threads(2)
    rec = dict(step=False, packs=[], points=[], trials=[], searched=[],
               ops=[])
    real_step, real_level = ss.frame_step, se3_tracker._track_level
    real_compact = tobs.compact_active

    def step(*a, **k):
        ref = a[4]
        rec["points"].append([int(ref.pts[lv].valid.sum())
                              for lv in ss.lm_levels(a[2])])
        rec["step"] = True
        try:
            if k.get("frame_id", a[8]) == GC_FRAME:
                gc.collect()
            with _OpLog() as log:
                out = real_step(*a, **k)
        finally:
            rec["step"] = False
        rec["packs"].append(int(out[4].shape[0]))
        rec["ops"].append(log.ops)
        return out

    def level(*a, **k):
        out = real_level(*a, **k)
        if rec["step"]:
            rec["trials"].append(int(out[6]))
        return out

    def compact(*a, **k):
        out = real_compact(*a, **k)
        if rec["step"]:
            rec["searched"].append(int(out[1].sum()))
        return out

    traced = _traced() if mode == "on" else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as m, traced:
        m.setattr(ss, "frame_step", step)
        m.setattr(se3_tracker, "_track_level", level)
        m.setattr(tobs, "compact_active", compact)
        sys_ = _engine(cam)
        outs = []
        for i, (img, dep) in enumerate(frames):
            if i == 0:
                sys_.gt_depth_init(img, dep, 0, 0.0)
            else:
                outs.append(sys_.track_frame(img, i, i / 30.0))
        counters = sys_.stats.snapshot()
        spans = sys_.timers.spans(0, 1 << 62)
        hooked = sys_.timers._gc_hook is not None
        t = sys_.timers
        stages = {k: (t.first_ms[k], list(t.samples[k]), t.n[k])
                  for k in ("sim3_stage0", "pgo")}
        sys_.finalize()
    return dict(sys=sys_, outs=outs, counters=counters, spans=spans,
                hooked=hooked, stages=stages, **rec)


@pytest.fixture(scope="module")
def runs(sequence):
    cam, frames = sequence
    return {mode: _run(cam, frames, mode) for mode in ("off", "on")}


def _by_seq(spans):
    return {s.seq: s for s in spans}


def _ancestors(s, by_seq):
    out = []
    while s.parent:
        s = by_seq[s.parent]
        out.append(s)
    return out


# ------------------------------------------------------------ recorder


def test_off_hands_back_a_shared_noop_and_keeps_nothing():
    t = stats.StageTimers()
    assert t.span("a") is stats.NULL_SPAN
    assert t.frame(3) is stats.NULL_SPAN
    with t.span("a"):
        with t.time("b"):
            pass
    assert t.ring is None and t.spans(0, 1 << 62) == []
    assert t.n["b"] == 1 and "a" not in t.n


def test_spans_nest_and_carry_the_frame_id():
    t = stats.StageTimers()
    t.set_tracing(True)
    with t.frame(7):
        with t.time("stage"):
            with t.span("pull.x"):
                pass
    with t.span("outside"):
        pass
    s = {x.name: x for x in t.spans(0, 1 << 62)}
    assert set(s) == {"track_frame", "stage", "pull.x", "outside"}
    assert s["track_frame"].parent == 0
    assert s["stage"].parent == s["track_frame"].seq
    assert s["pull.x"].parent == s["stage"].seq
    assert [s[k].frame_id for k in ("track_frame", "stage", "pull.x")] == \
        [7, 7, 7]
    assert s["outside"].frame_id == -1 and s["outside"].parent == 0
    for child, parent in (("stage", "track_frame"), ("pull.x", "stage")):
        assert s[parent].start_ns <= s[child].start_ns
        assert s[child].end_ns <= s[parent].end_ns
    # the timed stage also kept its sample
    assert t.n["stage"] == 1 and t.last_ms["stage"] >= 0


@pytest.mark.parametrize("n", [5, 8, 20, 100])
def test_ring_bound_and_drop_count(n):
    t = stats.StageTimers(span_capacity=8)
    t.set_tracing(True)
    for i in range(n):
        with t.span(f"s{i}"):
            pass
    kept = t.spans(0, 1 << 62)
    assert len(kept) == min(n, 8)
    assert t.spans_dropped == max(0, n - 8)
    assert [x.name for x in kept] == [f"s{i}" for i in range(max(0, n - 8),
                                                              n)]


def test_reader_takes_the_spans_between_two_times():
    t = stats.StageTimers()
    t.set_tracing(True)
    for name in ("a", "b", "c"):
        with t.span(name):
            pass
    a, b, c = t.spans(0, 1 << 62)
    assert [x.name for x in t.spans(b.start_ns, b.end_ns)] == ["b"]
    assert [x.name for x in t.spans(a.start_ns, c.end_ns)] == ["a", "b", "c"]
    assert t.spans(b.start_ns + 1, c.end_ns - 1) == []


def test_parent_stacks_are_per_thread():
    t = stats.StageTimers()
    t.set_tracing(True)
    inner = threading.Event()
    outer = threading.Event()

    def worker():
        with t.span("worker"):
            inner.set()
            outer.wait(10)

    th = threading.Thread(target=worker)
    with t.span("main"):
        th.start()
        inner.wait(10)
        with t.span("main.child"):
            pass
        outer.set()
        th.join()
    s = {x.name: x for x in t.spans(0, 1 << 62)}
    assert s["worker"].parent == 0
    assert s["main.child"].parent == s["main"].seq
    assert s["worker"].thread != s["main"].thread


def test_gc_pause_is_a_span_under_the_open_one():
    t = stats.StageTimers()
    t.set_tracing(True)
    with t.frame(4):
        with t.span("work"):
            gc.collect()
    s = t.spans(0, 1 << 62)
    by = _by_seq(s)
    pauses = [x for x in s if x.name == "gc"]
    assert pauses and all(by[x.parent].name == "work" for x in pauses)
    assert all(x.frame_id == 4 for x in pauses)
    t.set_tracing(False)
    n = len(t.spans(0, 1 << 62))
    gc.collect()
    assert len(t.spans(0, 1 << 62)) == n


def test_dropped_recorder_leaves_no_hook():
    before = list(gc.callbacks)
    t = stats.StageTimers()
    t.set_tracing(True)
    assert len(gc.callbacks) == len(before) + 1
    del t
    gc.collect()
    assert gc.callbacks == before


def test_stage_samples_are_bounded():
    t = stats.StageTimers()
    for i in range(stats.SAMPLES_MAX + 10):
        t.record("s", float(i))
    assert len(t.samples["s"]) == stats.SAMPLES_MAX
    assert t.samples["s"][-1] == float(stats.SAMPLES_MAX + 9)
    assert t.first_ms["s"] == 0.0
    assert stats.SAMPLES_MAX >= 1 << 17


def test_removed_method_and_keys():
    assert not hasattr(stats.RunningStats, "reset")


# -------------------------------------------------------------- engine


def test_off_keeps_no_span_and_the_parents_pack(runs):
    r = runs["off"]
    assert r["spans"] == [] and r["sys"].timers.ring is None
    assert r["packs"] and set(r["packs"]) == {PACK}
    assert not r["hooked"]
    assert not any(k.startswith("lm_points") for k in r["counters"])


def test_on_pack_carries_the_counts_past_the_layout(runs):
    levels = ss.lm_levels(runs["on"]["sys"].cfg)
    assert set(runs["on"]["packs"]) == {PACK + 2 * len(levels)}
    assert runs["on"]["hooked"]


def test_tracing_adds_no_op_to_the_frame_step(runs):
    # the counts ride in the pack's existing stack and cat: the traced
    # frame step dispatches the untraced one's ops, views left out
    off, on = runs["off"]["ops"], runs["on"]["ops"]
    assert len(off) == len(on) == len(runs["off"]["packs"])
    assert all(len(x) > 100 for x in off)
    assert on == off


def test_poses_and_depth_bit_equal_on_and_off(runs):
    a, b = runs["off"], runs["on"]
    assert len(a["outs"]) == len(b["outs"]) == FRAMES - 1
    for x, y in zip(a["outs"], b["outs"]):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x, y)
    assert np.array_equal(a["sys"].trajectory_array(),
                          b["sys"].trajectory_array())
    assert np.array_equal(a["sys"].optimized_trajectory_array(),
                          b["sys"].optimized_trajectory_array())
    for f in ("idepth", "var", "valid", "validity"):
        assert torch.equal(getattr(a["sys"].map.state, f),
                           getattr(b["sys"].map.state, f)), f
    assert [k.id for k in a["sys"].keyframes] == \
        [k.id for k in b["sys"].keyframes]
    for ka, kb in zip(a["sys"].keyframes, b["sys"].keyframes):
        assert torch.equal(ka.depth.idepth[0], kb.depth.idepth[0])


def test_one_root_span_a_call_with_its_frame_id(runs):
    roots = [s for s in runs["on"]["spans"] if s.name == "track_frame"]
    assert sorted(s.frame_id for s in roots) == list(range(1, FRAMES))
    assert all(s.parent == 0 for s in roots)


def test_every_child_lies_inside_its_parent(runs):
    spans = runs["on"]["spans"]
    by = _by_seq(spans)
    children = [s for s in spans if s.parent]
    assert len(children) > 7 * (FRAMES - 1)
    for s in children:
        p = by[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
        assert s.frame_id == p.frame_id and s.thread == p.thread
        # outside a call the frame id is -1
        root = _ancestors(s, by)[-1]
        assert (root.name == "track_frame") == (s.frame_id >= 0)


def test_ordinary_frames_hold_the_frame_step_and_the_pull(runs):
    spans = runs["on"]["spans"]
    by = _by_seq(spans)
    steps = [s for s in spans if s.name == "frame_step"]
    assert len(steps) == len(runs["on"]["packs"])
    for st in steps:
        kids = {s.name for s in spans if s.parent == st.seq}
        assert {"pyramid", "track", "observe"} <= kids
        assert by[st.parent].name == "track_frame"
        retire = [s for s in spans if s.name == "retire"
                  and s.frame_id == st.frame_id]
        assert len(retire) == 1
        assert [s.name for s in spans if s.parent == retire[0].seq] == \
            ["pull.pack"]


def test_switch_frame_holds_its_search_and_pulls(runs):
    spans = runs["on"]["spans"]
    by = _by_seq(spans)
    switches = [s for s in spans if s.name == "switch"]
    assert len(switches) == 2
    for sw in switches:
        inside = [s for s in spans if sw in _ancestors(s, by)]
        names = {s.name for s in inside}
        assert {"finalize_kf", "export_depth", "permaref",
                "reposition_search", "create_keyframe"} <= names
        pulls = {s.name for s in inside if s.name.startswith("pull.")}
        assert {"pull.export", "pull.switch"} <= pulls
        frame = [s for s in spans if s.frame_id == sw.frame_id]
        assert {"switch_pyramid", "switch_track", "retire",
                "pull.pack"} <= {s.name for s in frame}
        assert "frame_step" not in {s.name for s in frame}
    # the first keyframe's back end: three constraint stages, each with its
    # pull, and PGO with its pulls, inside `constraints`
    stages = [s for s in spans if s.name.startswith("sim3_stage")]
    assert sorted(s.name for s in stages) == [
        "sim3_stage0", "sim3_stage1", "sim3_stage2"]
    for st in stages:
        assert by[st.parent].name == "constraints"
        assert [s.name for s in spans if s.parent == st.seq] == ["pull.sim3"]
    pgo = [s for s in spans if s.name == "pgo"]
    assert pgo and all(by[s.parent].name == "constraints" for s in pgo)
    assert all(by[s.parent].name == "pgo"
               for s in spans if s.name == "pull.pgo")


def test_gc_collect_in_a_traced_call_is_a_span(runs):
    spans = runs["on"]["spans"]
    by = _by_seq(spans)
    pauses = [s for s in spans if s.name == "gc" and s.frame_id == GC_FRAME]
    assert pauses
    assert any(by[s.parent].name == "frame_step" for s in pauses)


def test_roofline_counters_equal_their_recomputed_values(runs):
    r = runs["on"]
    levels = ss.lm_levels(r["sys"].cfg)
    n = len(levels)
    trials = np.asarray(r["trials"], np.float64).reshape(-1, n)
    points = np.asarray(r["points"], np.float64)
    assert trials.shape == points.shape == (len(r["packs"]), n)
    c = r["counters"]
    for j, k in enumerate(levels):
        assert c[f"lm_points_l{k}"] == points[:, j].sum()
        assert c[f"lm_point_passes_l{k}"] == (
            points[:, j] * (trials[:, j] + 1)).sum()
    # the fused count of processed pixels is the searched slots: the
    # EPL search roofline reads it (no frame step maps elsewhere here)
    assert c["observe_processed"] == sum(r["searched"])
    assert runs["off"]["counters"]["observe_processed"] == sum(
        runs["off"]["searched"])


def test_stage_counters_come_from_the_stage_timers(runs):
    for mode in ("off", "on"):
        st, c = runs[mode]["stages"], runs[mode]["counters"]
        for stage, key in (("sim3_stage0", "sim3_stage0_ms"),
                           ("pgo", "pgo_ms")):
            first, samples, n = st[stage]
            want = first
            for x in samples:
                want += x
            assert c[key] == pytest.approx(want, rel=1e-12, abs=0)
        assert c["sim3_stage0_n"] == st["sim3_stage0"][2]
        assert c["pgo_calls"] == st["pgo"][2]
        assert not any(k.endswith("_ms_max") for k in c)


def test_timer_names(runs):
    t = runs["on"]["sys"].timers
    assert "retire_pull" not in t.n and t.n["pull.pack"] == FRAMES - 1
    assert t.n["track"] == len(runs["on"]["packs"])
    assert t.n["switch_track"] == FRAMES - 1 - len(runs["on"]["packs"])


def test_finalize_removes_the_gc_hook(runs):
    t = runs["on"]["sys"].timers
    assert not t.tracing and t._gc_hook is None
    # the ring stays for its readers; finalize's own work was traced
    after = t.spans(0, 1 << 62)
    assert len(after) > len(runs["on"]["spans"])
    assert "pgo_final" in {s.name for s in after}


def test_profiler_mode_follows_the_profiler(sequence):
    cam, frames = sequence
    sys_ = _engine(cam)
    sys_.gt_depth_init(*frames[0], 0, 0.0)
    sys_.track_frame(frames[1][0], 1, 1 / 30.0)
    assert not sys_.timers.tracing and sys_.timers.ring is None
    with _traced():
        for i in (2, 3):
            sys_.track_frame(frames[i][0], i, i / 30.0)
        assert sys_.timers.tracing and sys_.timers._gc_hook is not None
    sys_.track_frame(frames[4][0], 4, 4 / 30.0)
    assert not sys_.timers.tracing and sys_.timers._gc_hook is None
    roots = [s.frame_id for s in sys_.timers.spans(0, 1 << 62)
             if s.name == "track_frame"]
    assert roots == [2, 3]
    sys_.finalize()
