"""csrc/fill_holes.cu built for the host with g++ and held, bit for bit on
all six planes, to the plain version (`ops.regularize_stencil.
fill_holes_plain`) on the CPU.

The kernel repeats the plain version's order of operations (the integral
image's blocked scans, the window sum, the taps in lattice order, IEEE
divisions). These tests build the source with g++ under a small shim for
the CUDA builtins (`-ffp-contract=off`: no contraction, as nvcc's
`-fmad=false`; x86-64 SSE float arithmetic, IEEE like the card's), with
one thread a block: the thread-count lines become 1, so each phase between
two barriers runs all of its work items in turn, and a host `launch` walks
both launches' grids block by block. The wrapper `stencil.fill_holes` is
called as on the card (its checks, its scratch, its arguments), with only
the launch and the device test replaced. The card's own run is
tests/test_torch_fill_holes.py.
"""

import ctypes
import pathlib
import shutil
import subprocess

import pytest
import torch

from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
from test_torch_fill_holes import (CARD_SHAPES, CASES, assert_same_bits,
                                   fill_state, plane_args, thresholds_met)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "lsd_slam_tpu_torch" / "csrc" / "fill_holes.cu")

SHIM = r"""
#include <math.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uchar4 { unsigned char x, y, z, w; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline uchar4 make_uchar4(unsigned char x, unsigned char y, unsigned char z,
                          unsigned char w) {
  return uchar4{x, y, z, w};
}
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline void __trap() { std::abort(); }
constexpr int cudaErrorInvalidValue = 1;
"""

# griddepcontrol (programmatic dependent launch) has no meaning when the
# launches run one after the other on the host
GRID_LINES = ('asm volatile("griddepcontrol.launch_dependents;");',
              'asm volatile("griddepcontrol.wait;" ::: "memory");')
THREAD_LINES = ("constexpr int kLanes = 32;",
                "constexpr int kRowWarps = 16;",
                "constexpr int kFuseThreads = 256;")

HOST_LAUNCH = r"""// ---- launches (host: one thread a block) ----

int launch(const Args& a, void*) {
  std::vector<float> rows(rows_smem(a) / sizeof(float));
  std::vector<float> fuse(fuse_smem(a) / sizeof(float));
  for (int b = 0; b < a.nbands; ++b) rows_block(a, rows.data(), b, 0);
  for (int by = 0; by * kTH < a.h; ++by)
    for (int bx = 0; bx * kTW < a.w; ++bx)
      fuse_block(a, fuse.data(), bx, by, 0);
  return 0;
}

}  // namespace
"""

# shapes beyond the card's: one band (no blocked column scan), a 16-wide
# row, ragged tiles, more bands than a scan block holds (the band totals'
# scan recurses)
HOST_SHAPES = CARD_SHAPES + ((16, 40), (17, 16), (37, 53), (300, 70))


def host_source(src: str) -> str:
    for anchor in ("#include <cuda_runtime.h>", *THREAD_LINES, *GRID_LINES,
                   "// ---- launches ----", "}  // namespace"):
        assert src.count(anchor) == 1, f"anchor not found once: {anchor!r}"
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    for line in THREAD_LINES:
        src = src.replace(line, line.split("=")[0] + "= 1;")
    for line in GRID_LINES:
        src = src.replace(line, "")
    head = src[:src.index("// ---- launches ----")]
    tail = src[src.index("}  // namespace") + len("}  // namespace"):]
    return head + HOST_LAUNCH + tail


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel for the host")
    out = tmp_path_factory.mktemp("fill_holes_host")
    cpp = out / "fill_holes_host.cpp"
    cpp.write_text(host_source(SOURCE.read_text()))
    lib = out / "libfill_holes_host.so"
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture
def on_host(monkeypatch, host_lib):
    """`stencil.fill_holes` launching the host build on CPU tensors."""
    def launch(name, symbol, device, *args):
        rc = stencil.bind(host_lib, symbol)(*args, None)
        assert rc == 0, f"{name}: {rc}"
    monkeypatch.setattr(stencil, "_cuda_or_plain", lambda name, t: True)
    monkeypatch.setattr(stencil, "_launch", launch)
    return stencil


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("h,w", HOST_SHAPES,
                         ids=[f"{h}x{w}" for h, w in HOST_SHAPES])
def test_host_build_matches_plain_bit_for_bit(on_host, h, w, case):
    state, max_grad = fill_state(h, w, case, seed=h * w)
    args = plane_args(state, max_grad)
    want = stencil.fill_holes_plain(*args)
    before = stencil.FILL_HOLES_LAUNCHES
    got = on_host.fill_holes(*args)
    assert stencil.FILL_HOLES_LAUNCHES == before + 1
    assert_same_bits(got, want, f"{h}x{w} {case}")
    if h >= 128:
        assert thresholds_met(state, max_grad) > 10
        assert int((got[0] & ~state.valid).sum()) > 50


def test_host_build_rounds_each_threshold_case_like_the_plain_version(
        on_host):
    """Holes whose window sum the integral image's rounding puts on either
    side of a threshold: created or not as the plain version decides."""
    state, max_grad = fill_state(480, 640, "rounded", seed=5)
    args = plane_args(state, max_grad)
    want = stencil.fill_holes_plain(*args)
    got = on_host.fill_holes(*args)
    assert_same_bits(got, want)
    near = thresholds_met(state, max_grad)
    created = got[0] & ~state.valid
    assert near > 100 and int(created.sum()) > 100


def test_wrapper_refuses_a_non_integer_blacklist_threshold(on_host):
    state, max_grad = fill_state(20, 24)
    args = list(plane_args(state, max_grad))
    args[9] = -1.5
    with pytest.raises(ValueError, match="min_blacklist"):
        on_host.fill_holes(*args)


@pytest.mark.parametrize("plane", (0, 1, 4, 5))
def test_wrapper_checks_the_planes_it_launches_on(on_host, plane):
    """A plane of another dtype or shape raises before any
    launch."""
    state, max_grad = fill_state(20, 24)
    args = list(plane_args(state, max_grad))
    t = args[plane]
    args[plane] = (t.to(torch.float32) if t.dtype == torch.bool
                   else t.to(torch.float64) if plane != 4
                   else t.to(torch.int64))
    before = stencil.FILL_HOLES_LAUNCHES
    with pytest.raises(TypeError):
        on_host.fill_holes(*args)
    args[plane] = torch.empty((21, 24), dtype=t.dtype)
    with pytest.raises(ValueError):
        on_host.fill_holes(*args)
    assert stencil.FILL_HOLES_LAUNCHES == before
