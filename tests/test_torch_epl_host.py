"""csrc/epl_stereo.cu built for the host with g++ and held, bit for bit, to
the plain versions on the CPU with a correctly rounded sqrt.

The kernels follow their plain versions (`depth/observe.py`
`epl_setup_plain`, `epl_search_plain`, `fuse_plain`) operation for
operation; the rounding rules are in the source's header. On the card they
differ from the CPU plain versions in the last bit of a few EPL directions
and search results: the CPU's `torch.sqrt` of a large f32 tensor runs MKL's
vector math, which is not always correctly rounded, and the kernels'
`sqrtf` is. These tests tell that difference from any other. They compile
the source with g++ under a small shim for the CUDA builtins
(`-ffp-contract=off`: no contraction, as nvcc's `-fmad=false`; x86-64 SSE
float arithmetic, IEEE like the card's), run each kernel one emulated
thread at a time through the wrappers of `ops/epl_stereo.py`, and require
every output to have the bits of the plain version with `torch.sqrt`
replaced by numpy's IEEE square root. The block sums of the fusion's
counts (`__syncthreads_count` and one atomic a block) are the only lines
replaced: each emulated thread adds its own predicates.

Inputs: tests/test_torch_epl.py's 160x128 scene (30% of the pixels
invalidated, blacklist counters from a seed), with a fifth of the pixels at
0.95 max_var in the "kills" case so failed updates kill.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch import lie
from lsd_slam_tpu_torch.depth import observe as tobs
from lsd_slam_tpu_torch.ops import epl_stereo
from test_torch_epl import B, H, W, _inputs, make_scene

SOURCE = (pathlib.Path(__file__).resolve().parent.parent
          / "lsd_slam_tpu_torch" / "csrc" / "epl_stereo.cu")

SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct LsdHostDim3 { unsigned x, y, z; };
static LsdHostDim3 threadIdx, blockIdx, blockDim;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
using std::isfinite;
using std::isnan;
inline int __syncthreads_count(bool p) { return p ? 1 : 0; }
"""

BLOCK_COUNTS = """  if (threadIdx.x < kNStats && counts[threadIdx.x] > 0)
    atomicAdd(a.stats + threadIdx.x,
              static_cast<unsigned long long>(counts[threadIdx.x]));"""

THREAD_COUNTS = """  for (int q = 0; q < kNStats; ++q)
    a.stats[q] += static_cast<unsigned long long>(counts[q]);"""

LAUNCHERS = r"""
}  // namespace

template <class Kernel>
static void lsd_host_run(Kernel kernel, int n, int threads,
                         const LsdEplPtrs* a, const LsdEplParams* p) {
  blockDim.x = threads;
  for (int b = 0; b * threads < n; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < threads; ++t) {
      threadIdx.x = t;
      kernel(*a, *p);
    }
  }
}

extern "C" int lsd_epl_prepare(const LsdEplPtrs* a, const LsdEplParams* p,
                               void*) {
  lsd_host_run(epl_prepare_kernel, p->n_pix, kThreads, a, p);
  return 0;
}

extern "C" int lsd_epl_stereo(const LsdEplPtrs* a, const LsdEplParams* p,
                              void*) {
  if (p->budget > 0)
    lsd_host_run(epl_stereo_kernel, p->budget, kStereoThreads, a, p);
  return 0;
}

extern "C" int lsd_observe_fuse(const LsdEplPtrs* a, const LsdEplParams* p,
                                void*) {
  lsd_host_run(observe_fuse_kernel, p->n_pix, kThreads, a, p);
  return 0;
}
"""


def host_source(src: str) -> str:
    """The kernel source for g++: the shim for <cuda_runtime.h>, the
    per-thread counts for the block sums, host launchers for the card's."""
    for anchor in ("#include <cuda_runtime.h>", BLOCK_COUNTS,
                   "int grid_of(int n, int threads)"):
        assert src.count(anchor) == 1, f"anchor not found once: {anchor!r}"
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src = src.replace(BLOCK_COUNTS, THREAD_COUNTS)
    return src[:src.index("int grid_of(int n, int threads)")] + LAUNCHERS


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("epl_host")
    cpp = out / "epl_stereo_host.cpp"
    cpp.write_text(host_source(SOURCE.read_text()))
    lib = out / "libepl_stereo_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers of ops/epl_stereo.py launching the host build on CPU
    tensors."""
    def launch(name, entry, ptrs, prm, dev):
        rc = epl_stereo._entry(entry)(ctypes.byref(ptrs), ctypes.byref(prm),
                                      None)
        assert rc == 0
    monkeypatch.setattr(epl_stereo, "_library", lambda: host_lib)
    monkeypatch.setattr(epl_stereo, "_on_card", lambda name, dev: None)
    monkeypatch.setattr(epl_stereo, "_launch", launch)
    return epl_stereo


def _rounded_sqrt(real):
    def sqrt(x, *a, **k):
        if (not a and not k and torch.is_tensor(x)
                and x.dtype == torch.float32):
            return torch.from_numpy(np.sqrt(x.numpy()))
        return real(x, *a, **k)
    return sqrt


def _bits(t):
    t = t.contiguous()
    if t.dtype.is_floating_point:
        return t.view(torch.int32)
    return t


def _assert_bits(got, want, what):
    off = int((_bits(got) != _bits(want)).sum())
    assert off == 0, f"{what}: {off} of {got.numel()} entries differ"


CASES = {"single": [1], "multi3": [1, 2, 3], "multi8": list(range(1, 9)),
         "kills": [1, 2, 3], "reactivated": [2]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_has_the_plain_versions_bits(scene, on_host, case,
                                                monkeypatch):
    """Set-up, search and fusion of the host build against the plain
    versions with a correctly rounded sqrt: every output bit-equal, the
    counts equal."""
    s, c = scene, _inputs(scene, CASES[case])
    dcfg, mcfg, cam = s["cfg"].depth, s["cfg"].mapping, s["cam"]
    state = c["state"]
    if case == "kills":
        rng = np.random.default_rng(1)
        high = torch.as_tensor(rng.uniform(size=(H, W)) < 0.2)
        state = state.replace(var=torch.where(
            high, torch.full_like(state.var, 0.95 * dcfg.max_var),
            state.var))
    reactivated = case == "reactivated"
    n = len(c["ids"])
    terms = tobs.frame_terms(
        lie.se3_inverse(c["ref_to_kf"] if n > 1 else c["ref_to_kf"][0]),
        0.25 * (1.0 + (c["residual"] if n > 1 else c["residual"][0])), cam)
    setup_args = (state, c["kf_img"], c["kf_max_grad"],
                  c["ref_to_kf"][:, 4:7].contiguous(), c["ids"], c["good"],
                  cam, dcfg, mcfg, reactivated)

    sk = on_host.epl_prepare(*setup_args)
    for g, fill in zip(sk.out, (tobs.SKIP, 0.0, 0.0, 1e9)):
        assert bool((g == fill).all())
    assert int(sk.stats.abs().sum()) == 0
    flat_idx, valid_k = tobs.compact_active(
        sk.process, tobs.frame_shift(c["ids"][-1], H * W), B)
    search_args = (flat_idx, valid_k, c["kf_img"], c["kf_gx"], c["kf_gy"],
                   c["ref_stack"], terms, cam, dcfg, mcfg)
    gk = on_host.epl_stereo(sk, *search_args)
    nk, stk = on_host.observe_fuse(state, sk, gk, c["kf_max_grad"],
                                   c["ids"], 3.0, dcfg)

    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _rounded_sqrt(torch.sqrt))
        sp = tobs.epl_setup_plain(*setup_args)
        gp = tobs.epl_search_plain(sp, *search_args)
        np_, stp = tobs.fuse_plain(state, sp, gp, valid_k,
                                   c["kf_max_grad"], c["ids"], 3.0, dcfg)

    for f in tobs.EplSetup._fields[:10]:
        _assert_bits(getattr(sk, f), getattr(sp, f), f"set-up {f}")
    for f in tobs.StereoGrids._fields:
        _assert_bits(getattr(gk, f), getattr(gp, f), f"search {f}")
    for f in ("valid", "idepth", "var", "validity", "blacklisted",
              "next_min_id"):
        _assert_bits(getattr(nk, f), getattr(np_, f), f"fusion {f}")
    assert {k: int(v) for k, v in stk.items()} == {
        k: int(v) for k, v in stp.items()}
    # the case reaches the branches it is there for
    assert int(valid_k.sum()) > 1000
    assert int(stp["created"]) > 0 and int(stp["updated"]) > 0
    assert int(stp["blacklisted"]) > 0
    if case == "kills":
        assert int(stp["killed"]) > 0
