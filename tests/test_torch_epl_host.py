"""csrc/epl_stereo.cu built for the host with g++ and held, bit for bit, to
the plain versions on the CPU with a correctly rounded sqrt.

The kernels follow their plain versions (`depth/observe.py`
`epl_setup_plain`, `epl_search_plain`, `fuse_plain`) operation for
operation; the rounding rules are in the source's header. On the card they
differ from the CPU plain versions in the last bit of a few EPL directions
and search results: the CPU's `torch.sqrt` of a large f32 tensor runs MKL's
vector math, which is not always correctly rounded, and the kernels'
`sqrtf` is. These tests tell that difference from any other. They compile
the source with g++ at every group size (kGroup 8, 16, 32) under a small
shim for the CUDA builtins (`-ffp-contract=off`: no contraction, as
nvcc's `-fmad=false`; x86-64 SSE float arithmetic, IEEE like the card's),
run each kernel one emulated thread at a time through the wrappers of
`ops/epl_stereo.py` (the search: a warp's owner lanes, then each group's
lanes stage by stage, then the owners' tails, walking the slots as the
card's grid does), and require every output to have the bits of the
plain version with `torch.sqrt` replaced by numpy's IEEE square root.
Two pieces of the source are replaced: the block sums of the fusion's
counts (`__syncthreads_count` and one atomic a block; each emulated
thread adds its own predicates) and the group's shuffle butterfly (the
same butterfly over the emulated lanes).

Inputs: tests/test_torch_epl.py's 160x128 scene (30% of the pixels
invalidated, blacklist counters from a seed), with a fifth of the pixels at
0.95 max_var in the "kills" case so failed updates kill.
"""

import ctypes
import pathlib
import re
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
#define __shared__
#define __launch_bounds__(...)
struct LsdHostDim3 { unsigned x, y, z; };
static LsdHostDim3 threadIdx, blockIdx, blockDim, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
using std::isfinite;
using std::isnan;
inline int __syncthreads_count(bool p) { return p ? 1 : 0; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int, int) {
  return v;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline long long clock64() { return 0; }
"""

BLOCK_COUNTS = """  if (threadIdx.x < kNStats && counts[threadIdx.x] > 0)
    atomicAdd(a.stats + threadIdx.x,
              static_cast<unsigned long long>(counts[threadIdx.x]));"""

THREAD_COUNTS = """  for (int q = 0; q < kNStats; ++q)
    a.stats[q] += static_cast<unsigned long long>(counts[q]);"""

# the card's butterfly of shuffles, and the same butterfly over the
# group's emulated lanes (every lane's own steps first)
GROUP_BEST = """  unsigned long long key = lane_best(err, lane, n_steps, skip);
#pragma unroll
  for (int d = kGroup / 2; d > 0; d /= 2)
    key = key_min(key, __shfl_xor_sync(gmask, key, d, kGroup));"""

LANES_BEST = """  unsigned long long keys[kGroup];
  for (int l = 0; l < kGroup; ++l) keys[l] = lane_best(err, l, n_steps, skip);
  for (int d = kGroup / 2; d > 0; d /= 2) {
    unsigned long long nxt[kGroup];
    for (int l = 0; l < kGroup; ++l) nxt[l] = key_min(keys[l], keys[l ^ d]);
    for (int l = 0; l < kGroup; ++l) keys[l] = nxt[l];
  }
  const unsigned long long key = keys[lane];"""

GROUP_LINE = "constexpr int kGroup = {};"

# The host launchers. The search walks the slots as the card's grid does
# (each warp's ballot of 32 tested slots, their owners' set-ups, the
# groups' searches of them in turns, the owners' tails) on a grid of
# HOST_BLOCKS blocks, so each warp strides over many batches, and runs each
# group's stages one emulated lane at a time.
HOST_BLOCKS = 2
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
  if (p->budget <= 0) return 0;
  static WarpSlice ws;
  const int n_groups = HOST_BLOCKS * kSlotGroups;
  for (int w = 0; w < HOST_BLOCKS * kStereoThreads / 32; ++w) {
    const int g0 = w * kWarpGroups;
    for (int b = 0; g0 + static_cast<long long>(b) * kGroup * n_groups <
                    p->budget; ++b) {
      unsigned valid = 0;
      for (int l = 0; l < 32; ++l) {
        const long long s = batch_slot(g0, b, l, n_groups);
        if (s < p->budget && a->valid_k[s] != 0) valid |= 1u << l;
      }
      for (unsigned m = valid; m != 0; m &= m - 1) {
        const int l = __ffs(static_cast<int>(m)) - 1;
        ws.front[l] = slot_front(
            *a, *p,
            static_cast<int>(a->flat_idx[batch_slot(g0, b, l, n_groups)]),
            nullptr);
      }
      int rank = 0;
      for (unsigned m = valid; m != 0; m &= m - 1, ++rank) {
        const int j = rank % kWarpGroups;
        const int o = __ffs(static_cast<int>(m)) - 1;
        for (int l = 0; l < kGroup; ++l)
          group_samples(*a, *p, ws.front[o], ws.samp[j], l);
        for (int l = 0; l < kGroup; ++l) group_ssd(ws.samp[j], ws.err[j], l);
        for (int l = 0; l < kGroup; ++l)
          group_search(*p, ws.front[o], ws.samp[j], ws.err[j], ws.found[o],
                       l, 0u);
      }
      for (unsigned m = valid; m != 0; m &= m - 1) {
        const int l = __ffs(static_cast<int>(m)) - 1;
        slot_tail(*a, *p, ws.front[l], ws.found[l], nullptr);
      }
    }
  }
  return 0;
}

extern "C" int lsd_observe_fuse(const LsdEplPtrs* a, const LsdEplParams* p,
                                void*) {
  lsd_host_run(observe_fuse_kernel, p->n_pix, kThreads, a, p);
  return 0;
}

// group_best's result for lane 0 on one set of step errors
extern "C" void lsd_host_group_best(const float* err, int n_steps, int skip,
                                    int* k, float* v) {
  const Best b = group_best(err, 0, n_steps, skip, 0u);
  *k = b.k;
  *v = b.v;
}
""".replace("HOST_BLOCKS", str(HOST_BLOCKS))

GROUPS = (8, 16, 32)
SOURCE_GROUP = int(re.search(r"constexpr int kGroup = (\d+);",
                             SOURCE.read_text()).group(1))


def host_source(src: str, group: int = SOURCE_GROUP) -> str:
    """The kernel source for g++ at `group` lanes a slot: the shim for
    <cuda_runtime.h>, the per-thread counts for the block sums, the
    butterfly over emulated lanes, host launchers for the card's."""
    for anchor in ("#include <cuda_runtime.h>", BLOCK_COUNTS, GROUP_BEST,
                   GROUP_LINE.format(SOURCE_GROUP),
                   "int grid_of(int n, int threads)"):
        assert src.count(anchor) == 1, f"anchor not found once: {anchor!r}"
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src = src.replace(BLOCK_COUNTS, THREAD_COUNTS)
    src = src.replace(GROUP_BEST, LANES_BEST)
    src = src.replace(GROUP_LINE.format(SOURCE_GROUP),
                      GROUP_LINE.format(group))
    return src[:src.index("int grid_of(int n, int threads)")] + LAUNCHERS


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The host build at every group size, g++ run for all at once."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("epl_host")
    src = SOURCE.read_text()
    procs = {}
    for g in GROUPS:
        cpp = out / f"epl_stereo_host_g{g}.cpp"
        cpp.write_text(host_source(src, g))
        lib = out / f"libepl_stereo_host_g{g}.so"
        procs[g] = (subprocess.Popen(
            ["g++", "-std=c++17", "-O2", "-ffp-contract=off",
             "-fno-fast-math", "-shared", "-fPIC", "-o", str(lib), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for g, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ at kGroup = {g}:\n{log}"
        libs[g] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _use(monkeypatch, lib):
    """The wrappers of ops/epl_stereo.py launching the host build `lib` on
    CPU tensors."""
    def launch(name, entry, ptrs, prm, dev):
        rc = epl_stereo._entry(entry)(ctypes.byref(ptrs), ctypes.byref(prm),
                                      None)
        assert rc == 0
    monkeypatch.setattr(epl_stereo, "_library", lambda: lib)
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


def _assert_bits(got, want, what, nan_equal=False):
    """Every entry with the same bits (with `nan_equal`, or both NaN)."""
    off = _bits(got) != _bits(want)
    if nan_equal and got.dtype.is_floating_point:
        off &= ~(torch.isnan(got) & torch.isnan(want))
    off = int(off.sum())
    assert off == 0, f"{what}: {off} of {got.numel()} entries differ"


CASES = {"single": [1], "multi3": [1, 2, 3], "multi8": list(range(1, 9)),
         "kills": [1, 2, 3], "reactivated": [2]}
# the plain versions' results by case (they do not depend on the build)
_PLAIN = {}


def _case_inputs(scene, case):
    s, c = scene, _inputs(scene, CASES[case])
    dcfg, mcfg, cam = s["cfg"].depth, s["cfg"].mapping, s["cam"]
    state = c["state"]
    if case == "kills":
        rng = np.random.default_rng(1)
        high = torch.as_tensor(rng.uniform(size=(H, W)) < 0.2)
        state = state.replace(var=torch.where(
            high, torch.full_like(state.var, 0.95 * dcfg.max_var),
            state.var))
    n = len(c["ids"])
    terms = tobs.frame_terms(
        lie.se3_inverse(c["ref_to_kf"] if n > 1 else c["ref_to_kf"][0]),
        0.25 * (1.0 + (c["residual"] if n > 1 else c["residual"][0])), cam)
    setup_args = (state, c["kf_img"], c["kf_max_grad"],
                  c["ref_to_kf"][:, 4:7].contiguous(), c["ids"], c["good"],
                  cam, dcfg, mcfg, case == "reactivated")
    return c, state, terms, setup_args


def _check_case(scene, case, lib, monkeypatch):
    """Set-up, search and fusion of the host build `lib` against the plain
    versions with a correctly rounded sqrt: every output bit-equal, the
    counts equal."""
    s = scene
    dcfg, mcfg, cam = s["cfg"].depth, s["cfg"].mapping, s["cam"]
    c, state, terms, setup_args = _case_inputs(scene, case)
    on_host = _use(monkeypatch, lib)
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

    if case not in _PLAIN:
        with monkeypatch.context() as m:
            m.setattr(torch, "sqrt", _rounded_sqrt(torch.sqrt))
            sp = tobs.epl_setup_plain(*setup_args)
            gp = tobs.epl_search_plain(sp, *search_args)
            np_, stp = tobs.fuse_plain(state, sp, gp, valid_k,
                                       c["kf_max_grad"], c["ids"], 3.0,
                                       dcfg)
        _PLAIN[case] = sp, gp, np_, stp
    sp, gp, np_, stp = _PLAIN[case]

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


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_has_the_plain_versions_bits(scene, host_libs, case,
                                                monkeypatch):
    """The source as it stands (kGroup lanes a slot)."""
    _check_case(scene, case, host_libs[SOURCE_GROUP], monkeypatch)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_counts_each_searched_slot_as_processed(
        scene, host_libs, case, monkeypatch):
    """The fusion's `processed` count is the sweep's searched slots (the
    set entries of valid_k): the EPL search's roofline reads the
    engine's `observe_processed` counter as the points searched."""
    s = scene
    dcfg, mcfg, cam = s["cfg"].depth, s["cfg"].mapping, s["cam"]
    c, state, terms, setup_args = _case_inputs(scene, case)
    on_host = _use(monkeypatch, host_libs[SOURCE_GROUP])
    sk = on_host.epl_prepare(*setup_args)
    flat_idx, valid_k = tobs.compact_active(
        sk.process, tobs.frame_shift(c["ids"][-1], H * W), B)
    gk = on_host.epl_stereo(sk, flat_idx, valid_k, c["kf_img"], c["kf_gx"],
                            c["kf_gy"], c["ref_stack"], terms, cam, dcfg,
                            mcfg)
    _, stk = on_host.observe_fuse(state, sk, gk, c["kf_max_grad"], c["ids"],
                                  3.0, dcfg)
    assert int(valid_k.sum()) > 1000
    assert int(stk["processed"]) == int(valid_k.sum())
    assert int((gk.code != tobs.SKIP).sum()) == int(valid_k.sum())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("group", [g for g in GROUPS if g != SOURCE_GROUP])
def test_host_build_every_group_size(scene, host_libs, group, case,
                                     monkeypatch):
    """The source built at each other group size: the same bits."""
    _check_case(scene, case, host_libs[group], monkeypatch)


def _search_both(scene, lib, monkeypatch, case, edit):
    """The host build's search and the plain version's (with a correctly
    rounded sqrt) on one set-up (the host build's) of `case`, after
    `edit(setup, flat_idx, valid_k, ref_stack)` returns the searched
    (setup, flat_idx, valid_k, ref_stack). Returns both grids and the
    slots searched."""
    s = scene
    dcfg, mcfg, cam = s["cfg"].depth, s["cfg"].mapping, s["cam"]
    c, _, terms, setup_args = _case_inputs(scene, case)
    on_host = _use(monkeypatch, lib)
    sk = on_host.epl_prepare(*setup_args)
    flat_idx, valid_k = tobs.compact_active(
        sk.process, tobs.frame_shift(c["ids"][-1], H * W), B)
    sk, flat_idx, valid_k, ref = edit(sk, flat_idx, valid_k, c["ref_stack"])
    args = (flat_idx, valid_k, c["kf_img"], c["kf_gx"], c["kf_gy"], ref,
            terms, cam, dcfg, mcfg)
    gk = on_host.epl_stereo(sk, *args)
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _rounded_sqrt(torch.sqrt))
        gp = tobs.epl_search_plain(sk, *args)
    return gk, gp, flat_idx[valid_k]


@pytest.mark.parametrize("group", GROUPS)
def test_host_build_slots_with_gaps(scene, host_libs, group, monkeypatch):
    """valid_k with gaps (single slots, and a run of 300) and a slot count
    that is not a multiple of the group or of a warp: the groups' walk
    over the slots searches each valid slot once and no other."""
    budget = B - 3
    assert budget % group and budget % 32

    def edit(sk, flat_idx, valid_k, ref):
        rng = np.random.default_rng(2)
        keep = torch.as_tensor(rng.uniform(size=budget) < 0.7)
        keep[100:400] = False
        return sk, flat_idx[:budget], valid_k[:budget] & keep, ref

    gk, gp, slots = _search_both(scene, host_libs[group], monkeypatch,
                                 "multi3", edit)
    for f in tobs.StereoGrids._fields:
        _assert_bits(getattr(gk, f), getattr(gp, f), f"search {f}")
    assert slots.numel() > 800
    assert slots.numel() == int((gk.code != tobs.SKIP).sum())


@pytest.mark.parametrize("group", GROUPS)
def test_host_build_ties_and_nans(scene, host_libs, group, monkeypatch):
    """A reference image constant but for a block of NaN pixels (every
    step of a slot ties, or a NaN sample makes its steps NaN: the first
    minimum, the first NaN), and NaN far bounds at a tenth of the pixels
    (every lattice coordinate NaN: each group's base (0, 0), each sample
    0): the host build's codes and results are the plain version's."""
    def edit(sk, flat_idx, valid_k, ref):
        ref = torch.full_like(ref, 100.0)
        ref[:, 40:70, 20:140:5] = float("nan")
        rng = np.random.default_rng(3)
        nan_far = torch.as_tensor(rng.uniform(size=(H, W)) < 0.1)
        sk = sk._replace(max_id=torch.where(
            nan_far, torch.full_like(sk.max_id, float("nan")), sk.max_id))
        return sk, flat_idx, valid_k, ref

    gk, gp, slots = _search_both(scene, host_libs[group], monkeypatch,
                                 "single", edit)
    for f in tobs.StereoGrids._fields:
        _assert_bits(getattr(gk, f), getattr(gp, f), f"search {f}",
                     nan_equal=True)
    codes = gp.code.reshape(-1)[slots]
    # the NaN bounds fail, the rest are searched
    assert int((codes == tobs.ERR_NAN).sum()) > 50
    assert int((codes != tobs.ERR_NAN).sum()) > 500


def _plain_best(err, n_steps, skip):
    """The plain version's argmin (depth/observe.py line_stereo_points)
    over one slot's step errors."""
    ks = torch.arange(tobs.MAX_STEPS)
    keep = ks < n_steps
    if skip >= 0:
        keep &= ks != skip
    ee = torch.where(keep, err, torch.full_like(err, float("inf")))
    k = int(torch.argmin(ee))
    return k, np.float32(ee[k].item())


@pytest.mark.parametrize("group", GROUPS)
def test_group_best_is_the_plain_argmin(host_libs, group):
    """The groups' reduction (each lane's steps in order, then the
    butterfly) gives the plain version's best_k and second_k, and their
    errors' bits, on step errors with ties (among them -0 and +0), NaNs
    and infinities, at every n_steps."""
    fn = host_libs[group].lsd_host_group_best
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(4)
    pool = np.float32([0.0, -0.0, 1.0, 1.0, 2.5, np.inf, np.nan, 7.0])
    k_out, v_out = ctypes.c_int(), ctypes.c_float()
    checked = 0
    for trial in range(400):
        err = rng.choice(pool, tobs.MAX_STEPS).astype(np.float32)
        if trial % 4 == 0:
            err[:] = np.float32(3.0)          # every step ties
        elif trial % 4 == 1:
            err[err != err] = np.float32(1.0)  # ties, no NaN
        t = torch.from_numpy(err)
        n_steps = int(rng.integers(1, tobs.MAX_STEPS + 1))
        best_k, best_v = _plain_best(t, n_steps, -1)
        for skip, want_k, want_v in ((-1, best_k, best_v),
                                     (best_k, *_plain_best(t, n_steps,
                                                           best_k))):
            fn(err.ctypes.data, n_steps, skip, ctypes.byref(k_out),
               ctypes.byref(v_out))
            got_v = np.float32(v_out.value)
            assert k_out.value == want_k, (err, n_steps, skip)
            assert got_v.tobytes() == want_v.tobytes() or (
                np.isnan(got_v) and np.isnan(want_v)), (err, n_steps, skip)
            checked += 1
    assert checked == 800
