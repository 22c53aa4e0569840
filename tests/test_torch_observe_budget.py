"""The observe budget's counters (CPU, no JAX): `observe_slots` (the
point budget of every observe sweep, summed) and `observe_unsearched`
(each sweep's eligible pixels past its budget, summed).

The engine runs the 160x128 loop scenario of tests/_torch_slam_scenario.py
(two keyframe switches in 15 frames), then one standalone mapping
iteration (`update_keyframe`) and one ten-frame batch (two
multi-reference chunks at the full budget). Every other budget
`pick_budget` hands out is cut to 512, so that sweeps leave pixels
unsearched. The counters equal their values worked out from each
sweep's own budget and stats; and they are host sums of values the
engine pulls anyway: a run with the counting taken out dispatches the
same torch ops, pulls the same number of times and packs the same
frame pack.
"""

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.config import KeyframeConfig, LSDConfig
from lsd_slam_tpu_torch.depth import depth_map as dm
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.system import slam_system as ss
from lsd_slam_tpu_torch.utils import synth
from torch.utils._python_dispatch import TorchDispatchMode
from _torch_slam_scenario import H, KEYFRAME, N, W

FRAMES = 16          # frame 0 seeds the map; 1..15 are tracked
SMALL = 512          # the budget every other pick is cut to
PACK = 23 + len(tobs.OBSERVE_STAT_KEYS) + 2
PULLS = ("cpu", "item", "tolist", "numpy", "__float__", "__int__",
         "__bool__")


class _OpLog(TorchDispatchMode):
    """The names of the torch ops dispatched inside, views left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func.name())
        return func(*args, **(kwargs or {}))


def _run(counting: bool):
    """The scenario; returns what the tests read. Without `counting` the
    engine's `_count_budgets` does nothing."""
    torch.set_num_threads(2)
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=13)
    poses = synth.loop_trajectory(N)
    frames = [synth.render(scene, cam, poses[i], device="cpu")
              for i in range(FRAMES)]
    rec = dict(picks=[], sweeps=[], packs=[], pulls=0)
    real_pick, real_step = dm.pick_observe_budget, ss.frame_step
    real_obs, real_multi = tobs.observe, tobs.observe_multi
    real_pulls = {name: getattr(torch.Tensor, name) for name in PULLS}

    def pick(*a, **k):
        b = real_pick(*a, **k)
        b = SMALL if len(rec["picks"]) % 2 else b
        rec["picks"].append(b)
        return b

    def sweep(real):
        def run(*a, **k):
            state, stats = real(*a, **k)
            rec["sweeps"].append((k["point_budget"], int(stats["active"]),
                                  int(stats["processed"])))
            return state, stats
        return run

    def step(*a, **k):
        out = real_step(*a, **k)
        rec["packs"].append(int(out[4].shape[0]))
        return out

    def pull(name):
        def run(self, *a, **k):
            rec["pulls"] += 1
            return real_pulls[name](self, *a, **k)
        return run

    with pytest.MonkeyPatch.context() as m, _OpLog() as log:
        m.setattr(dm, "pick_observe_budget", pick)
        m.setattr(tobs, "observe", sweep(real_obs))
        m.setattr(tobs, "observe_multi", sweep(real_multi))
        m.setattr(ss, "frame_step", step)
        if not counting:
            m.setattr(SlamSystem, "_count_budgets", lambda *a: None)
        cfg = LSDConfig(width=W, height=H).replace(
            keyframe=KeyframeConfig(**KEYFRAME))
        sys_ = SlamSystem(cam, cfg, device="cpu")
        for name in PULLS:
            m.setattr(torch.Tensor, name, pull(name))
        for i, (img, dep) in enumerate(frames):
            if i == 0:
                sys_.gt_depth_init(img, dep, 0, 0.0)
            else:
                assert sys_.track_frame(img, i, i / 30.0) is not None
        tracked = sys_.latest_tracked
        assert tracked.parent_kf_id == sys_.current_keyframe.id
        assert sys_.update_keyframe(tracked)
        assert sys_.update_keyframe_batch([tracked] * 10)
        counters = sys_.stats.snapshot()
    return dict(counters=counters, ops=log.ops, **rec)


@pytest.fixture(scope="module")
def runs():
    return {c: _run(c) for c in (True, False)}


def test_slots_are_the_budgets_pick_budget_returned(runs):
    r = runs[True]
    c = r["counters"]
    # every pick fed one sweep (no frame was lost), then two chunks
    # of the batch at the full budget
    full = dm.observe_budget_full(H, W)
    assert [b for b, _, _ in r["sweeps"]] == r["picks"] + [full, full]
    assert c["observe_slots"] == sum(r["picks"]) + 2 * full
    assert SMALL in r["picks"] and full in r["picks"]


def test_unsearched_is_the_active_past_each_budget(runs):
    r = runs[True]
    c = r["counters"]
    want = sum(max(0, active - b) for b, active, _ in r["sweeps"])
    assert c["observe_unsearched"] == want
    # the cut budgets left pixels unsearched, the full ones none here
    assert want > 0
    assert any(b >= active for b, active, _ in r["sweeps"])
    # a sweep searches min(active, budget): the two counters agree
    assert want == c["observe_active"] - c["observe_processed"]
    assert all(p == min(a, b) for b, a, p in r["sweeps"])


def test_counting_adds_no_op_no_pull_and_no_pack_entry(runs):
    on, off = runs[True], runs[False]
    assert "observe_slots" not in off["counters"]
    assert on["ops"] == off["ops"]
    assert on["pulls"] == off["pulls"]
    # a frame step a tracked frame but the two switch frames
    assert on["packs"] == off["packs"] == [PACK] * (FRAMES - 3)
    # one pack pull a tracked frame
    assert on["counters"]["host_syncs"] == off["counters"]["host_syncs"] \
        == FRAMES - 1
    for key in ("observe_active", "observe_processed", "map_pulls"):
        assert on["counters"][key] == off["counters"][key]
    np.testing.assert_array_equal(
        [b for b, _, _ in on["sweeps"]], [b for b, _, _ in off["sweeps"]])
