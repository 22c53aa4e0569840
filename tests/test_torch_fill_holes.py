"""The hole fill's kernel (csrc/fill_holes.cu) on the card against its plain
version (`ops.regularize_stencil.fill_holes_plain`, the op-for-op port of
the JAX package's XLA-fused `fill_holes`), bit for bit on all six planes.

JAX-free, so it runs on a GPU host (`pytest --noconftest -m cuda`); every
test skips on a host without a card: the kernel has no CPU mode
(tests/test_torch_fill_holes_host.py runs the same source built for the
host with g++, and tests/test_torch_regularize.py holds the plain version
to JAX).

The states (`fill_state`) hold fractional validities, as the observe
sweep's gradient-scaled cap makes them, and planted 5x5 windows around
holes whose validity sums land on `val_sum_min_for_create` and
`val_sum_min_for_unblacklist`: exactly (case "exact": every validity a
multiple of 1/4, so the integral image is exact and `>` decides), or to
within the integral image's rounding (case "rounded": the order of the
sums decides). Planted holes also sit on the border of the fill region
(rows and columns 2, 3, h-3, h-2 and their x counterparts).
"""

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.depth import regularize as treg
from lsd_slam_tpu_torch.depth.state import DepthMapState
from lsd_slam_tpu_torch.ops import regularize_stencil as stencil

# the main path's shapes (TUM 640x480, EuRoC 752x480) and the tests' 160x128
CARD_SHAPES = ((480, 640), (480, 752), (128, 160))
CASES = ("exact", "rounded")
MIN_GRAD = LSDConfig().mapping.min_use_grad
PLANES = ("valid", "idepth", "var", "validity", "idepth_smoothed",
          "var_smoothed")

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _plant(valid, validity, max_grad, bl, cy, cx, total, fractional, rng):
    """A hole at (cy, cx) with every neighbour in its 5x5 window valid and
    validities summing to `total`: exactly (multiples of 1/4), or, when
    `fractional`, as tenths whose f32 sum misses `total` by a rounding or
    two in a direction the order of the sums decides. The hole passes the
    gradient test, and its blacklist lets `val_sum_min_for_create`
    decide."""
    h, w = valid.shape
    ys = slice(max(cy - 2, 0), min(cy + 3, h))
    xs = slice(max(cx - 2, 0), min(cx + 3, w))
    win = np.ones((ys.stop - ys.start, xs.stop - xs.start), bool)
    win[cy - ys.start, cx - xs.start] = False
    n = int(win.sum())
    if fractional:
        v = np.round(rng.uniform(0.5, total / n, n - 1), 1)
    else:
        v = np.floor(np.full(n - 1, total / n) * 4) / 4
    v = np.append(v, total - v.sum()).astype(np.float32)
    valid[ys, xs] = win
    validity[ys, xs][win] = v
    max_grad[cy, cx] = 2 * MIN_GRAD
    bl[cy, cx] = 0


def fill_state(h, w, case="rounded", seed=0, device="cpu"):
    """(state, max_grad) for `stencil.fill_holes`: a random state with
    var 0 at its invalid pixels, as real states hold it, and planted holes
    at the thresholds, inside the image and on the fill region's border
    (rows 2, 3, h-3, h-2; columns 2, 3, w-3, w-2). Planted windows do not
    overlap."""
    dcfg = LSDConfig().depth
    rng = np.random.default_rng(seed)
    valid = rng.uniform(size=(h, w)) < 0.55
    exact = case == "exact"
    if exact:
        validity = rng.integers(0, 33, (h, w)) / 4.0
    else:
        validity = rng.uniform(0.0, 8.0, (h, w))
    validity = np.where(valid, validity, 0.0).astype(np.float32)
    max_grad = rng.uniform(0.0, 4.0 * MIN_GRAD, (h, w)).astype(np.float32)
    bl = rng.integers(-3, 1, (h, w)).astype(np.int32)
    totals = (float(dcfg.val_sum_min_for_create),
              float(dcfg.val_sum_min_for_unblacklist))
    centres = []
    for k, y in enumerate((2, 3, h - 3, h - 2)):
        centres += [(y, x) for x in range(8 + 11 * (k % 2), w - 8, 22)]
    for k, x in enumerate((2, 3, w - 3, w - 2)):
        centres += [(y, x) for y in range(8 + 11 * (k % 2), h - 8, 22)]
    centres += [(y, x) for y in range(13, h - 13, 7)
                for x in range(13, w - 13, 9)]
    for k, (cy, cx) in enumerate(centres):
        _plant(valid, validity, max_grad, bl, cy, cx, totals[k % 2],
               not exact, rng)
    idepth = np.where(valid, rng.uniform(0.2, 2.0, (h, w)), 0.0)
    var = np.where(valid, rng.uniform(1e-4, 5e-2, (h, w)), 0.0)
    id_sm = np.where(valid, idepth * rng.uniform(0.9, 1.1, (h, w)), -1.0)
    var_sm = np.where(valid, var * rng.uniform(0.9, 1.1, (h, w)), -1.0)

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype),
                               device=device)

    state = DepthMapState(
        valid=t(valid, bool), idepth=t(idepth), var=t(var),
        idepth_smoothed=t(id_sm), var_smoothed=t(var_sm),
        validity=t(validity), blacklisted=t(bl, np.int32),
        next_min_id=t(np.zeros((h, w))))
    return state, t(max_grad)


def plane_args(state, max_grad):
    """The positional arguments of `stencil.fill_holes` for `state` at the
    default configuration."""
    dcfg = LSDConfig().depth
    return (state.valid, state.idepth, state.var, state.validity,
            state.blacklisted, max_grad, state.idepth_smoothed,
            state.var_smoothed, MIN_GRAD, dcfg.min_blacklist,
            dcfg.val_sum_min_for_create, dcfg.val_sum_min_for_unblacklist,
            dcfg.var_random_init_initial)


def bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same_bits(got, want, where=""):
    for name, a, b in zip(PLANES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        off = int((bits(a).cpu() != bits(b).cpu()).sum())
        assert off == 0, f"{where} {name}: {off} of {a.numel()} differ"


def thresholds_met(state, max_grad):
    """How many holes have a window sum equal to a threshold to within
    4 ulp (the cases the rounding order decides)."""
    dcfg = LSDConfig().depth
    v = torch.where(state.valid, state.validity,
                    torch.zeros_like(state.validity)).cpu().double()
    win = torch.nn.functional.avg_pool2d(v[None, None], 5, 1, 2,
                                         count_include_pad=True)[0, 0] * 25
    hole = ~state.valid.cpu() & (max_grad.cpu() >= MIN_GRAD)
    near = torch.zeros_like(hole)
    for th in (dcfg.val_sum_min_for_create, dcfg.val_sum_min_for_unblacklist):
        near |= (win - th).abs() <= 4 * th * 2.0 ** -23
    return int((hole & near).sum())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("h,w", CARD_SHAPES,
                         ids=[f"{h}x{w}" for h, w in CARD_SHAPES])
def test_kernel_matches_plain_bit_for_bit(h, w, case):
    _need_card()
    state, max_grad = fill_state(h, w, case, seed=h + w, device="cuda")
    assert thresholds_met(state, max_grad) > 10
    args = plane_args(state, max_grad)
    before = stencil.FILL_HOLES_LAUNCHES
    got = stencil.fill_holes(*args)
    want = stencil.fill_holes_plain(*args)
    torch.cuda.synchronize()
    assert stencil.FILL_HOLES_LAUNCHES == before + 1
    assert_same_bits(got, want, f"{h}x{w} {case}")
    cpu = stencil.fill_holes_plain(*(a.cpu() if torch.is_tensor(a) else a
                                     for a in args))
    assert_same_bits(got, cpu, f"{h}x{w} {case} (CPU plain)")
    created = int((got[0] & ~state.valid).sum())
    assert created > 50, created


def test_kernel_makes_at_most_three_launches():
    """One `fill_holes` call on the card launches its two kernels and no
    other device operation but the outputs' and scratch's allocation."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    state, max_grad = fill_state(480, 640, device="cuda")
    args = plane_args(state, max_grad)
    stencil.fill_holes(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stencil.fill_holes(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        pytest.skip("the profiler saw no device activity on this host")
    assert 1 <= len(kernels) <= 3, kernels
    assert all("fill_holes" in k for k in kernels), kernels


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    _need_card()

    def plain(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(stencil, "fill_holes_plain", plain)
    state, max_grad = fill_state(37, 53, device="cuda")
    out = treg.fill_holes(state, max_grad, LSDConfig().depth, MIN_GRAD)
    torch.cuda.synchronize()
    assert out.valid.is_cuda and out.idepth.shape == (37, 53)
    assert out.blacklisted is state.blacklisted


def test_frame_step_and_finalize_launch_it_once_each():
    """An ordinary frame step runs one observe sweep and one hole fill;
    `finalize_keyframe` runs one more (160x128 VO)."""
    _need_card()
    from lsd_slam_tpu_torch.ops import epl_stereo
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth

    cam = synth.default_camera(160, 128)
    scene = synth.PlaneScene(seed=7)
    frames = [synth.render(scene, cam, p, device="cuda")
              for p in synth.orbit_trajectory(8)]
    sys_ = SlamSystem(cam, LSDConfig(), enable_slam=False, device="cuda")
    sys_.gt_depth_init(frames[0][0], frames[0][1])
    steps = 0
    for i, (img, _) in enumerate(frames[1:], 1):
        epl_stereo.reset_counts()
        before = stencil.FILL_HOLES_LAUNCHES
        sys_.track_frame(img, i)
        torch.cuda.synchronize()
        sweeps = epl_stereo.counts()["epl_prepare"]
        if sweeps == 1:  # an ordinary frame (a switch frame sweeps none)
            assert stencil.FILL_HOLES_LAUNCHES - before == 1
            steps += 1
    assert steps >= 3
    before = stencil.FILL_HOLES_LAUNCHES
    sys_.map.finalize_keyframe(sys_.current_keyframe.pyr.max_grad[0])
    torch.cuda.synchronize()
    assert stencil.FILL_HOLES_LAUNCHES == before + 1
