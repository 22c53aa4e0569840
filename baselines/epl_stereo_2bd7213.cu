// An earlier lsd_slam_tpu_torch/csrc/epl_stereo.cu, kept to be measured
// against the current kernel: commit 2bd7213's kernels (`epl_stereo` one
// thread a slot, a grid over the whole budget) with only the clock stamps
// of the current search kernel added (`LsdEplPtrs.stamps`, null or an int64
// buffer of five entries a slot, where the slot's thread writes clock64()
// at its start and after its gathers and descriptor, its endpoints, its
// lattice, and its scans and tail). Built and bound by
// `chip_smoke.py --baseline-epl-cu baselines/<this file>`, which checks its
// sha256; the package never builds it.
//
// The depth filter's observe sweep on Hopper: the per-pixel set-up, the
// epipolar-line (EPL) stereo search of the compacted points and the EKF
// fusion, for one reference frame (the frame step) or a stack of K <= 16
// (the mapping thread's multi-reference sweep).
//
// Replaces, in the JAX package (lsd_slam_tpu/depth/observe.py), the jnp code
// that XLA fuses into the jitted `observe` (:417) and `observe_multi` (:616):
//   lsd_epl_prepare  make_epl (:62), make_epl_multi (:586), the priors and
//                    masks of observe (:430-462) and the per-pixel frame
//                    choice of observe_multi (:640-680). One thread a pixel.
//                    It picks the pixel's frame k_sel first and runs the EPL
//                    checks for that frame alone: the values equal the
//                    (K, H, W) stack of make_epl_multi gathered at k_sel,
//                    since a pixel's value for a frame depends on nothing
//                    else. It also fills the result grids with the
//                    not-processed values (code SKIP, idepth 0, var 0, EPL
//                    length 1e9) and zeroes the stat counts, so that the
//                    search writes only its own slots and the fusion adds
//                    into zeros.
//   lsd_epl_stereo   line_stereo (:88-414). One thread a compacted slot
//                    (flat_idx, valid_k from the torch compaction, whose slot
//                    order is JAX's nonzero(size=)): it gathers its inputs at
//                    flat_idx and runs the whole search (the 5-tap keyframe
//                    descriptor; the near / far endpoints, crop, pad and
//                    border clamp; the 38-sample lattice and the 34-step
//                    5-tap SSD; the best and the non-adjacent second best;
//                    subpixel refinement; triangulation; the variance
//                    model), and writes code / idepth / var / EPL length
//                    into the (H*W) grids at flat_idx: the four scatters.
//   lsd_observe_fuse _fuse_results (:501). One thread a pixel: the create /
//                    EKF-update / fail lattice, the new state fields and the
//                    nine stat counts (OBSERVE_STAT_KEYS order), block sums
//                    of int predicates (__syncthreads_count) added with
//                    64-bit integer atomics: exact and order-free.
// A sweep on the card is these three launches and the torch compaction.
// The per-frame K*R, K*t, R, t and tracking-error factor (K <= 16) come in
// from torch ops; only per-point work is here.
//
// The plain versions, which these kernels follow operation for operation,
// are lsd_slam_tpu_torch/depth/observe.py `epl_setup_plain`,
// `epl_search_plain` (`line_stereo_points`) and `fuse_plain`
// (`_fuse_results`). Where parity can break, and what is done about it:
//  1. patch16_sample is not plain bilinear (ops/interp.py:131-166). Each
//     group of three lattice samples (or tap pair) takes one base: the floor
//     of the group's clamped minimum, clamped to [0, W-4] x [0, H-4]; a NaN
//     coordinate in the group makes that minimum NaN and the base (0, 0)
//     (trunc of NaN is 0). The in-patch corner is clamped to [0, 2], so fu
//     and fv may leave [0, 1]; the weights are formed and summed in the
//     plain version's order. A NaN corner samples 0. The patch16 layout is
//     not built: lane 4*dy+dx of patch row y*W+x is img[y+dy][x+dx] once the
//     base is clamped, so the taps are read from the image. In multi mode
//     the stack is one tall (K*H, W) image, clamped at K*H, so a masked tail
//     may read a neighbouring frame, as the JAX sweep does.
//  2. Argmin: the first minimum; a NaN wins (the first NaN); the second
//     best excludes only best_k itself (scan_argmin).
//  3. Rounding: built with -fmad=false (ops/build.py), IEEE `/` and sqrtf,
//     no fast-math. Every Python constant is the f32 torch rounds it to
//     (passed in LsdEplParams). `c / x` with a Python c is torch's
//     reciprocal(x) * c (Tensor.__rtruediv__); `x / c` a true division.
//     The SSD sums its taps in order j = 0..4 from 0; torch.sum over the
//     five subpixel terms adds ((((x0 + x4) + x1) + x2) + x3) on the CPU
//     (ATen's row_sum with four accumulators), and so does sum5 here.
//     trunc_int follows ops/interp.py:26 (truncate, NaN to 0, saturate to
//     int32). The validity cap rounds as depth/observe.py does: the product
//     and sum in f64, then to f32. clamp / clamp_min / minimum keep NaN.
//  4. Graph decisions at 640x480 follow f32 rounding: the kernels are held
//     against the plain version run on the CPU, not only against the card's
//     torch ops (which divide by a Python float through a reciprocal).
//
// Bound (chip_smoke.py `epl_bounds`, each input read once, each output
// written once, each field at its dtype's size): the set-up reads 25 B a
// pixel (+1 B for each of at most two good masks) and writes 48 B; the
// search reads valid_k (1 B) of every slot and, of a searched slot,
// flat_idx (8 B) and 28 B of set-up and gradients (+8 B of k_sel with
// several frames), writes 16 B, reads the keyframe and the reference
// images, and does ~2,250 f32 operations a slot (43 bilinear samples, the
// 34 x 5 SSD terms of two scans: the second best rescans, then the
// endpoints, subpixel fit, triangulation and variance); the fusion reads
// 53 B a pixel (+8 B of k_sel with several frames) and writes 21 B. All
// three are one thread an item with no reuse; the set-up and the fusion are
// memory-bound, the search is latency-bound (a slot's serial chain of
// dependent gathers).
//
// On the CPU, tests/test_torch_epl_host.py builds this file with g++ under a
// shim for the CUDA builtins and holds every output to the plain versions
// (with a correctly rounded sqrt) bit for bit. It edits three anchors, which
// must stay as they are: the <cuda_runtime.h> include, the block counts'
// atomic add and `grid_of`, where the host launchers take over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxFrames = 16;
constexpr int kSteps = 34;          // MAX_STEPS
constexpr int kGroups = 13;         // ceil(N_SAMPLES / 3), N_SAMPLES = 38
constexpr int kThreads = 256;
constexpr int kStereoThreads = 128;

enum : int {
  kOk = 0,
  kErrOob = -1,
  kErrFail = -2,
  kErrBig = -3,
  kErrNan = -4,
  kSkip = -100,
};

// the stat counts, in OBSERVE_STAT_KEYS order
enum : int {
  kActive = 0,
  kBlacklisted,
  kCreated,
  kInconsistent,
  kKilled,
  kOob,
  kProcessed,
  kUpdateFailed,
  kUpdated,
  kNStats
};

}  // namespace

// Every pointer a launch may touch; each entry reads and writes its own.
struct LsdEplPtrs {
  // the depth state (H, W)
  const uint8_t* valid;
  const float* idepth;
  const float* var;
  const float* idepth_sm;
  const float* var_sm;
  const float* validity;
  const int32_t* blacklisted;
  const float* next_min_id;
  // the keyframe (H, W)
  const float* kf_img;
  const float* kf_gx;
  const float* kf_gy;
  const float* kf_max_grad;
  // the reference frames: t_r2k (K, 3), good masks (K, H, W), images
  // (K, H, W) read as one (K*H, W) image, and the frame terms
  const float* t_r2k;
  const uint8_t* good;
  const float* ref;
  const float* KR;   // (K, 3, 3)
  const float* Kt;   // (K, 3)
  const float* R;    // (K, 3, 3)
  const float* t;    // (K, 3)
  const float* tef;  // (K,)
  // the set-up (H, W)
  float* epx;
  float* epy;
  float* prior;
  float* min_id;
  float* max_id;
  uint8_t* epl_ok;
  uint8_t* can_update;
  uint8_t* can_create;
  uint8_t* process;
  int64_t* k_sel;
  // the compaction (budget,)
  const int64_t* flat_idx;
  const uint8_t* valid_k;
  // the result grids (H, W)
  int32_t* code;
  float* r_idepth;
  float* r_var;
  float* r_epl;
  // the new state (H, W) and the stat counts (9,)
  uint8_t* n_valid;
  float* n_idepth;
  float* n_var;
  float* n_validity;
  int32_t* n_blacklisted;
  float* n_next_min_id;
  unsigned long long* stats;
  // epl_stereo's clock stamps (null on every engine path): five a slot
  long long* stamps;
};

// The by-value constants; each float is the f32 torch uses for the same
// Python constant (ops/epl_stereo.py `make_params`).
struct LsdEplParams {
  int h, w, n_ref, n_pix, budget;
  int multi, reactivated, use_subpixel, allow_negative, min_blacklist;
  float fx, fy, cx, cy, neg_fx, neg_fy, cx_fx, cy_fy;
  float ids[kMaxFrames];
  float min_epl_length_sq, min_epl_grad_sq, min_epl_angle_sq, grad_dist;
  float min_use_grad, var_fac, inv_min_depth;
  float max_crop, min_crop, half_min_crop;
  float border, w_border, h_border;
  float kf_u_hi, kf_v_hi, kf_bx_hi, kf_by_hi;
  float ref_v_hi, ref_by_hi;
  float err_big, max_error_stereo, min_dist_error, photo_num;
  float max_var, diff_fac, succ_var_inc, fail_var_inc;
  float vc_initial, vc_inc, vc_dec, skip_inc;
  double cap_fac, vc_max;
};

namespace {

// torch.clamp_min / clamp_max / clamp: NaN stays NaN, -0 stays -0
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}
// torch.minimum: NaN if either is NaN
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}
// torch.amin of two: NaN if either is NaN
__device__ __forceinline__ float amin2(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000)
                                : (b < a ? b : a);
}
// depth/observe.py `_unzero`
__device__ __forceinline__ float unzero(float x) {
  const float eps = x < 0.0f ? -1e-10f : 1e-10f;
  return fabsf(x) < 1e-10f ? eps : x;
}
// ops/interp.py `trunc_int`: truncate, NaN -> 0, saturate to int32
__device__ __forceinline__ long long trunc_int(float x) {
  if (isnan(x)) return 0;
  double d = static_cast<double>(x);
  if (d < -2147483648.0) d = -2147483648.0;
  if (d > 2147483647.0) d = 2147483647.0;
  return static_cast<long long>(d);
}
// torch.sum over five values on the CPU: ATen's row_sum with four
// accumulators adds the fifth into the first, then the other three
__device__ __forceinline__ float sum5(const float* x) {
  float s = 0.0f + x[0];
  s = s + x[4];
  s = s + x[1];
  s = s + x[2];
  return s + x[3];
}

// ops/interp.py `patch16_sample` for one group of M coordinates of an image
// of `w` columns: the clamps, the group's base, the corner lanes and the
// weights in the plain version's order.
template <int M>
__device__ __forceinline__ void patch_sample(const float* __restrict__ img,
                                             int w, float u_hi, float v_hi,
                                             float bx_hi, float by_hi,
                                             const float* us_in,
                                             const float* vs_in, float* out) {
  float us[M], vs[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    us[m] = clamp_to(us_in[m], 0.0f, u_hi);
    vs[m] = clamp_to(vs_in[m], 0.0f, v_hi);
  }
  float mu = us[0], mv = vs[0];
#pragma unroll
  for (int m = 1; m < M; ++m) {
    mu = amin2(mu, us[m]);
    mv = amin2(mv, vs[m]);
  }
  const long long bx = trunc_int(floorf(clamp_to(mu, 0.0f, bx_hi)));
  const long long by = trunc_int(floorf(clamp_to(mv, 0.0f, by_hi)));
  const float bxf = static_cast<float>(bx), byf = static_cast<float>(by);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float lx = us[m] - bxf;
    const float ly = vs[m] - byf;
    const float u0 = clamp_to(floorf(lx), 0.0f, 2.0f);
    const float v0 = clamp_to(floorf(ly), 0.0f, 2.0f);
    const float fu = lx - u0;
    const float fv = ly - v0;
    const float corner = v0 * 4.0f + u0;
    if (isnan(corner)) {
      out[m] = 0.0f;
      continue;
    }
    const float* p = img + (by + static_cast<long long>(v0)) * w + bx +
                     static_cast<long long>(u0);
    const float t0 = __ldg(p), t1 = __ldg(p + 1);
    const float t2 = __ldg(p + w), t3 = __ldg(p + w + 1);
    const float omu = 1.0f - fu, omv = 1.0f - fv;
    out[m] = t0 * (omu * omv) + t1 * (fu * omv) + t2 * (omu * fv) +
             t3 * (fu * fv);
  }
}

// argmin over the 34 steps with torch's rule: the first minimum, the first
// NaN if any; `skip` (-1 for none) and steps >= n_steps read +inf
__device__ __forceinline__ int scan_argmin(const float* samp,
                                           const float* real, int n_steps,
                                           int skip, float* best_out) {
  float best = 0.0f;
  int bk = 0;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float d = samp[k + j] - real[j];
      e = e + d * d;
    }
    const float v = (k < n_steps && k != skip) ? e : __int_as_float(0x7f800000);
    if (k == 0) {
      best = v;
    } else if (!isnan(best) && (isnan(v) || v < best)) {
      best = v;
      bk = k;
    }
  }
  *best_out = best;
  return bk;
}

__global__ void __launch_bounds__(kThreads)
    epl_prepare_kernel(LsdEplPtrs a, LsdEplParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x < kNStats) a.stats[threadIdx.x] = 0ull;
  if (i >= p.n_pix) return;
  const int w = p.w, h = p.h;
  const int y = i / w, x = i - y * w;

  // --- the per-pixel frame choice (DepthMap.cpp:302-319) ---
  const float nmi = a.next_min_id[i];
  int k_upd = 0;
  bool found = false;
  for (int k = 0; k < p.n_ref; ++k) {
    if (!found && p.ids[k] >= nmi) {
      k_upd = k;
      found = true;
    }
  }
  const bool has_upd = p.reactivated || p.ids[p.n_ref - 1] >= nmi;
  const bool valid = a.valid[i] != 0;
  const bool interior = y >= 3 && y < h - 3 && x >= 3 && x < w - 3;
  const bool grad_ok = a.kf_max_grad[i] >= p.min_use_grad;
  const bool good_upd =
      a.good[static_cast<long long>(k_upd) * p.n_pix + i] != 0;
  const bool can_update = valid && interior && grad_ok && good_upd && has_upd;
  const bool can_create = !valid && interior && grad_ok && a.good[i] != 0 &&
                          a.blacklisted[i] >= p.min_blacklist;
  const int k_sel = can_update ? k_upd : 0;

  // --- makeAndCheckEPL (DepthMap.cpp:184-234) for frame k_sel ---
  const float t0 = a.t_r2k[3 * k_sel], t1 = a.t_r2k[3 * k_sel + 1],
              t2 = a.t_r2k[3 * k_sel + 2];
  const float epx = p.neg_fx * t0 + t2 * (static_cast<float>(x) - p.cx);
  const float epy = p.neg_fy * t1 + t2 * (static_cast<float>(y) - p.cy);
  const bool finite = isfinite(epx + epy);
  const float lsq = epx * epx + epy * epy;
  const bool ok_len = lsq >= p.min_epl_length_sq;
  // raw (not halved) central differences, 0 on the border
  const float* img = a.kf_img;
  const float gx = (x >= 1 && x < w - 1) ? img[i + 1] - img[i - 1] : 0.0f;
  const float gy = (y >= 1 && y < h - 1) ? img[i + w] - img[i - w] : 0.0f;
  const float dot = gx * epx + gy * epy;
  const float safe_lsq = clamp_lo(lsq, 1e-10f);
  const float egs = dot * dot / safe_lsq;
  const bool ok_grad = egs >= p.min_epl_grad_sq;
  const bool ok_angle =
      egs / clamp_lo(gx * gx + gy * gy, 1e-10f) >= p.min_epl_angle_sq;
  const float fac = (1.0f / sqrtf(safe_lsq)) * p.grad_dist;
  const bool epl_ok = finite && ok_len && ok_grad && ok_angle;

  // --- priors: update +- STEREO_EPL_VAR_FAC sigma, create the full range
  const float sv = sqrtf(clamp_lo(a.var_sm[i], 0.0f));
  const float upd_prior = a.idepth_sm[i];
  const float upd_min = clamp_lo(upd_prior - sv * p.var_fac, 0.0f);
  const float upd_max = clamp_hi(upd_prior + sv * p.var_fac, p.inv_min_depth);

  a.epx[i] = epx * fac;
  a.epy[i] = epy * fac;
  a.epl_ok[i] = epl_ok;
  a.can_update[i] = can_update;
  a.can_create[i] = can_create;
  a.process[i] = (can_update || can_create) && epl_ok;
  a.prior[i] = can_update ? upd_prior : 1.0f;
  a.min_id[i] = can_update ? upd_min : 0.0f;
  a.max_id[i] = can_update ? upd_max : p.inv_min_depth;
  a.k_sel[i] = k_sel;
  a.code[i] = kSkip;
  a.r_idepth[i] = 0.0f;
  a.r_var[i] = 0.0f;
  a.r_epl[i] = 1e9f;
}

__global__ void __launch_bounds__(kStereoThreads)
    epl_stereo_kernel(LsdEplPtrs a, LsdEplParams p) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.budget || a.valid_k[s] == 0) return;
  long long* const stamp = a.stamps ? a.stamps + 5LL * s : nullptr;
  if (stamp) stamp[0] = clock64();
  const long long pix = a.flat_idx[s];
  const int w = p.w, h = p.h;
  const float xs = static_cast<float>(pix % w);
  const float ys = static_cast<float>(pix / w);
  const int k = p.multi ? static_cast<int>(a.k_sel[pix]) : 0;
  const float prior = a.prior[pix], min_id = a.min_id[pix];
  float max_id = a.max_id[pix];
  const float epxn = a.epx[pix], epyn = a.epy[pix];
  const float kgx = a.kf_gx[pix], kgy = a.kf_gy[pix];
  const float* KR = a.KR + 9 * k;
  const float* Kt = a.Kt + 3 * k;
  const float* R = a.R + 9 * k;
  const float* T = a.t + 3 * k;
  const float tef = a.tef[k];

  bool ok = true;
  int code = kOk;
  auto fail = [&](bool cond, int c) {
    if (ok && cond) code = c;
    ok = ok && !cond;
  };

  const float kx = (xs - p.cx) / p.fx;
  const float ky = (ys - p.cy) / p.fy;
  float p_inf[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    p_inf[r] = KR[3 * r] * kx + KR[3 * r + 1] * ky + KR[3 * r + 2];
  const float safe_prior = clamp_lo(prior, 1e-10f);
  const float kt_z = Kt[2];
  const float rescale = p_inf[2] + kt_z * safe_prior;

  // the 5-tap descriptor's footprint must stay inside the keyframe
  const float fx_off = 2.0f * epxn * rescale;
  const float fy_off = 2.0f * epyn * rescale;
  const float w2 = static_cast<float>(w - 2), h2 = static_cast<float>(h - 2);
  fail((xs - fx_off <= 0.0f) || (xs - fx_off >= w2) || (ys - fy_off <= 0.0f) ||
           (ys - fy_off >= h2) || (xs + fx_off <= 0.0f) ||
           (xs + fx_off >= w2) || (ys + fy_off <= 0.0f) ||
           (ys + fy_off >= h2),
       kErrOob);
  fail(!((rescale > 0.7f) && (rescale < 1.4f)), kErrOob);

  // keyframe 5-tap descriptor, taps grouped {-2,-1} {0,1} {2}
  float real[5];
  {
    const float sx = epxn * rescale, sy = epyn * rescale;
    const float tj[3][2] = {{-2.0f, -1.0f}, {0.0f, 1.0f}, {2.0f, 2.0f}};
    float out[2];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float us[2] = {xs + tj[g][0] * sx, xs + tj[g][1] * sx};
      const float vs[2] = {ys + tj[g][0] * sy, ys + tj[g][1] * sy};
      patch_sample<2>(a.kf_img, w, p.kf_u_hi, p.kf_v_hi, p.kf_bx_hi,
                      p.kf_by_hi, us, vs, out);
      real[2 * g] = out[0];
      if (g < 2) real[2 * g + 1] = out[1];
    }
  }
  if (stamp) stamp[1] = clock64();

  // near / far endpoints on the EPL in the ref image (DepthMap.cpp:1489-1512)
  float p_close[3], p_far[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) p_close[r] = p_inf[r] + Kt[r] * max_id;
  const bool behind = p_close[2] < 0.001f;
  const float kt_z_safe = kt_z == 0.0f ? 1e-10f : kt_z;
  max_id = behind ? (0.001f - p_inf[2]) / kt_z_safe : max_id;
#pragma unroll
  for (int r = 0; r < 3; ++r) p_close[r] = p_inf[r] + Kt[r] * max_id;
  const float pcz = unzero(p_close[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r) p_close[r] = p_close[r] / pcz;
#pragma unroll
  for (int r = 0; r < 3; ++r) p_far[r] = p_inf[r] + Kt[r] * min_id;
  fail((p_far[2] < 0.001f) || (max_id < min_id), kErrOob);
  const float pfz = unzero(p_far[2]);
#pragma unroll
  for (int r = 0; r < 3; ++r) p_far[r] = p_far[r] / pfz;
  fail(!isfinite(p_far[0] + p_close[0]), kErrNan);

  float incx = p_close[0] - p_far[0];
  float incy = p_close[1] - p_far[1];
  const float epl_len = sqrtf(incx * incx + incy * incy);
  fail(!(epl_len > 0.0f) || !isfinite(epl_len), kErrNan);
  const float safe_len = clamp_lo(epl_len, 1e-10f);

  // crop to MAX_EPL_LENGTH_CROP
  const float cfac =
      epl_len > p.max_crop ? (1.0f / safe_len) * p.max_crop : 1.0f;
  float pcx = p_far[0] + incx * cfac;
  float pcy = p_far[1] + incy * cfac;
  incx = incx * p.grad_dist / safe_len;
  incy = incy * p.grad_dist / safe_len;
  float pfx = p_far[0] - incx;
  float pfy = p_far[1] - incy;
  pcx = pcx + incx;
  pcy = pcy + incy;

  // pad short EPLs to MIN_EPL_LENGTH_CROP
  const float pad =
      epl_len < p.min_crop ? (p.min_crop - epl_len) / 2.0f : 0.0f;
  pfx = pfx - incx * pad;
  pfy = pfy - incy * pad;
  pcx = pcx + incx * pad;
  pcy = pcy + incy * pad;

  const float b = p.border, wb = p.w_border, hb = p.h_border;
  fail((pfx <= b) || (pfx >= wb) || (pfy <= b) || (pfy >= hb), kErrOob);

  // near point outside: clamp along the line (DepthMap.cpp:1566-1613)
  const bool was_outside = (pcx <= b) || (pcx >= wb) || (pcy <= b) ||
                           (pcy >= hb);
  const float sxu = unzero(incx), syu = unzero(incy);
  float to_add = pcx <= b ? (b - pcx) / sxu
                          : (pcx >= wb ? (wb - pcx) / sxu : 0.0f);
  pcx = pcx + to_add * incx;
  pcy = pcy + to_add * incy;
  to_add = pcy <= b ? (b - pcy) / syu : (pcy >= hb ? (hb - pcy) / syu : 0.0f);
  pcx = pcx + to_add * incx;
  pcy = pcy + to_add * incy;
  const float dxl = pcx - pfx, dyl = pcy - pfy;
  const float new_len = sqrtf(dxl * dxl + dyl * dyl);
  fail((pcx <= b) || (pcx >= wb) || (pcy <= b) || (pcy >= hb) ||
           (was_outside && (new_len < 8.0f)),
       kErrOob);
  long long n_steps_l = trunc_int(floorf(new_len + 1e-3f)) + 1;
  n_steps_l = n_steps_l < 1 ? 1 : (n_steps_l > kSteps ? kSteps : n_steps_l);
  const int n_steps = static_cast<int>(n_steps_l);
  if (stamp) stamp[2] = clock64();

  // ---- the sample lattice and the 5-tap SSD over the masked window ----
  float samp[kGroups * 3];
  {
    const float y_off = p.multi ? static_cast<float>(k * h) : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float qx[3], qy[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float ms = static_cast<float>(3 * g + m) - 2.0f;
        qx[m] = pfx + ms * incx;
        qy[m] = pfy + ms * incy;
        if (p.multi) qy[m] = qy[m] + y_off;
      }
      patch_sample<3>(a.ref, w, p.kf_u_hi, p.ref_v_hi, p.kf_bx_hi,
                      p.ref_by_hi, qx, qy, samp + 3 * g);
    }
  }
  if (stamp) stamp[3] = clock64();

  float best_err, second_err;
  const int best_k = scan_argmin(samp, real, n_steps, -1, &best_err);
  const int second_k = scan_argmin(samp, real, n_steps, best_k, &second_err);
  const int gap = second_k - best_k;
  const bool second_nonadj = (gap < 0 ? -gap : gap) > 1;
  fail(best_err > p.err_big, kErrBig);
  fail(second_nonadj && (p.min_dist_error * best_err > second_err), kErrFail);

  // ---- subpixel refinement (DepthMap.cpp:1767-1848) ----
  float e_best[5], e_pre[5], e_post[5];
  {
    const int i_b = best_k;
    const int i_pre = best_k - 1 < 0 ? 0 : best_k - 1;
    const int i_post = best_k + 1 > kSteps - 1 ? kSteps - 1 : best_k + 1;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      e_best[j] = samp[i_b + j] - real[j];
      e_pre[j] = samp[i_pre + j] - real[j];
      e_post[j] = samp[i_post + j] - real[j];
    }
  }
  float sq_pre[5], sq_post[5], x_pre[5], x_post[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    sq_pre[j] = e_pre[j] * e_pre[j];
    sq_post[j] = e_post[j] * e_post[j];
    x_pre[j] = e_best[j] * e_pre[j];
    x_post[j] = e_best[j] * e_post[j];
  }
  const float err_pre = sum5(sq_pre), err_post = sum5(sq_post);
  const float cross_pre = sum5(x_pre), cross_post = sum5(x_post);

  const bool valid_pre = best_k >= 1;
  const bool valid_post = (best_k + 1) < n_steps;
  const float grad_pre_pre = -(err_pre - cross_pre);
  const float grad_pre_this = best_err - cross_pre;
  const float grad_post_this = -(best_err - cross_post);
  const float grad_post_post = err_post - cross_post;
  const bool both_valid = valid_pre && valid_post;
  const bool crossing_mid = (grad_post_this < 0.0f) != (grad_pre_this < 0.0f);
  const bool crossing_pre = (grad_pre_pre < 0.0f) != (grad_pre_this < 0.0f);
  const bool crossing_post =
      (grad_post_post < 0.0f) != (grad_post_this < 0.0f);
  const bool interp_pre =
      both_valid && !crossing_mid && crossing_pre && !crossing_post;
  const bool interp_post =
      both_valid && !crossing_mid && !crossing_pre && crossing_post;
  const float d_pre = grad_pre_this / unzero(grad_pre_this - grad_pre_pre);
  const float d_post =
      grad_post_this / unzero(grad_post_this - grad_post_post);

  float sub_off = 0.0f;
  bool did_sub = false;
  if (p.use_subpixel) {
    sub_off = interp_pre ? -d_pre : (interp_post ? d_post : 0.0f);
    did_sub = interp_pre || interp_post;
    const float e_pre_fit = best_err - 2.0f * d_pre * grad_pre_this -
                            (grad_pre_pre - grad_pre_this) * d_pre * d_pre;
    const float e_post_fit =
        best_err + 2.0f * d_post * grad_post_this +
        (grad_post_post - grad_post_this) * d_post * d_post;
    best_err = interp_pre ? e_pre_fit : (interp_post ? e_post_fit : best_err);
  }

  const float pos = static_cast<float>(best_k) + sub_off;
  const float best_x = pfx + pos * incx;
  const float best_y = pfy + pos * incy;

  // gradient along the searched line in the KF (DepthMap.cpp:1854-1862)
  const float sample_dist = p.grad_dist * rescale;
  float gal = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = real[j + 1] - real[j];
    gal = gal + d * d;
  }
  gal = gal / clamp_lo(sample_dist * sample_dist, 1e-10f);
  fail(best_err > p.max_error_stereo + sqrtf(gal) * 20.0f, kErrBig);

  // ---- triangulate inverse depth in the KF (DepthMap.cpp:1872-1904) ----
  const float dot0 = R[0] * kx + R[1] * ky + R[2];
  const float dot1 = R[3] * kx + R[4] * ky + R[5];
  const float dot2 = R[6] * kx + R[7] * ky + R[8];
  const float t0 = T[0], t1 = T[1], t2 = T[2];
  const bool use_x = incx * incx > incy * incy;
  const float old_x = best_x / p.fx - p.cx_fx;
  const float old_y = best_y / p.fy - p.cy_fy;
  const float nom_x = unzero(old_x * t2 - t0);
  const float nom_y = unzero(old_y * t2 - t1);
  const float id_x = (dot0 - old_x * dot2) / nom_x;
  const float id_y = (dot1 - old_y * dot2) / nom_y;
  const float alpha_x =
      incx / p.fx * (dot0 * t2 - dot2 * t0) / (nom_x * nom_x);
  const float alpha_y =
      incy / p.fy * (dot1 * t2 - dot2 * t1) / (nom_y * nom_y);
  const float idepth_new = use_x ? id_x : id_y;
  const float alpha = use_x ? alpha_x : alpha_y;
  if (!p.allow_negative) fail(idepth_new < 0.0f, kErrFail);

  // ---- variance model (DepthMap.cpp:1911-1930) ----
  const float photo_err = (1.0f / (gal + 1e-10f)) * p.photo_num;
  const float geo_dot = kgx * epxn + kgy * epyn + 1e-10f;
  const float geo_err =
      tef * tef * (kgx * kgx + kgy * kgy) / (geo_dot * geo_dot);
  const float disc = (did_sub ? 0.05f : 0.5f) * sample_dist * sample_dist;
  const float result_var = alpha * alpha * (disc + geo_err + photo_err);

  a.code[pix] = ok ? kOk : code;
  a.r_idepth[pix] = idepth_new;
  a.r_var[pix] = result_var;
  a.r_epl[pix] = epl_len;
  if (stamp) stamp[4] = clock64();
}

__global__ void __launch_bounds__(kThreads)
    observe_fuse_kernel(LsdEplPtrs a, LsdEplParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < p.n_pix;
  const int j = in ? i : 0;
  const int code = a.code[j];
  const float r_id = a.r_idepth[j], r_var = a.r_var[j], r_epl = a.r_epl[j];
  const bool valid = a.valid[j] != 0;
  const float idepth = a.idepth[j], var = a.var[j];
  const float id_sm = a.idepth_sm[j], var_sm = a.var_sm[j];
  const float validity = a.validity[j];
  const int bl = a.blacklisted[j];
  const float nmi = a.next_min_id[j];
  const bool can_update = a.can_update[j] != 0;
  const bool can_create = a.can_create[j] != 0;
  const bool epl_ok = a.epl_ok[j] != 0;

  const bool success = code == kOk;
  // create path (DepthMap.cpp:237-292)
  const bool create_try = can_create && epl_ok;
  const bool create_success = create_try && success && (r_var <= p.max_var);
  const bool create_blacklist =
      create_try && ((code == kErrBig) || (code == kErrFail));
  // update path (DepthMap.cpp:344-470)
  const bool upd_try = can_update && epl_ok;
  const bool upd_fail = upd_try && (code == kErrFail);
  const float diff = r_id - id_sm;
  const bool inconsistent =
      upd_try && success && (p.diff_fac * diff * diff > r_var + var_sm);
  const bool upd_success = upd_try && success && !inconsistent;

  // EKF fusion (DepthMap.cpp:430-444)
  const float id_var = var * p.succ_var_inc;
  const float wgt = r_var / clamp_lo(r_var + id_var, 1e-10f);
  const float fused_idepth = unzero((1.0f - wgt) * r_id + wgt * idepth);
  const float fused_var = minimum(id_var * wgt, var);
  // the f64 product and sum of depth/observe.py, then f32
  const float cap = static_cast<float>(__dadd_rn(
      __dmul_rn(static_cast<double>(a.kf_max_grad[j]), p.cap_fac),
      p.vc_max));

  float new_idepth =
      create_success ? unzero(r_id) : (upd_success ? fused_idepth : idepth);
  float new_var = create_success ? r_var : (upd_success ? fused_var : var);
  // failed update: inflate variance, maybe kill (DepthMap.cpp:369-389,414)
  const bool fail_like = upd_fail || inconsistent;
  new_var = fail_like ? new_var * p.fail_var_inc : new_var;
  const bool killed = fail_like && (new_var > p.max_var);
  const bool new_valid = (valid || create_success) && !killed;
  const float new_validity =
      create_success
          ? p.vc_initial
          : (upd_success
                 ? minimum(validity + p.vc_inc, cap)
                 : (upd_fail ? clamp_lo(validity - p.vc_dec, 0.0f)
                             : validity));
  const int new_bl = bl - static_cast<int>(create_blacklist) -
                     static_cast<int>(killed && upd_fail);

  // adaptive frame skipping for short EPLs (DepthMap.cpp:447-463)
  const bool short_epl = r_epl < p.min_crop;
  const long long ti = trunc_int(r_epl * 10000.0f);
  int parity = static_cast<int>(ti % 2);
  if (parity < 0) parity += 2;
  float inc = p.skip_inc + static_cast<float>(parity);
  inc = r_epl < p.half_min_crop ? inc * 3.0f : inc;
  const float ref_id = p.ids[p.multi ? static_cast<int>(a.k_sel[j]) : 0];
  const float new_nmi = (upd_success && short_epl)
                            ? ref_id + inc
                            : (upd_fail ? 0.0f : nmi);

  if (in) {
    a.n_valid[i] = new_valid;
    a.n_idepth[i] = new_idepth;
    a.n_var[i] = new_var;
    a.n_validity[i] = new_validity;
    a.n_blacklisted[i] = new_bl;
    a.n_next_min_id[i] = new_nmi;
  }

  // the nine counts: block sums, then one 64-bit atomic each
  const int counts[kNStats] = {
      __syncthreads_count(in && a.process[j] != 0),
      __syncthreads_count(in && create_blacklist),
      __syncthreads_count(in && create_success),
      __syncthreads_count(in && inconsistent),
      __syncthreads_count(in && killed),
      __syncthreads_count(in && code == kErrOob && (upd_try || create_try)),
      __syncthreads_count(in && code != kSkip),
      __syncthreads_count(in && upd_fail),
      __syncthreads_count(in && upd_success),
  };
  if (threadIdx.x < kNStats && counts[threadIdx.x] > 0)
    atomicAdd(a.stats + threadIdx.x,
              static_cast<unsigned long long>(counts[threadIdx.x]));
}

int grid_of(int n, int threads) { return (n + threads - 1) / threads; }

}  // namespace

extern "C" int lsd_epl_prepare(const LsdEplPtrs* a, const LsdEplParams* p,
                               void* stream) {
  epl_prepare_kernel<<<grid_of(p->n_pix, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lsd_epl_stereo(const LsdEplPtrs* a, const LsdEplParams* p,
                              void* stream) {
  if (p->budget <= 0) return 0;
  epl_stereo_kernel<<<grid_of(p->budget, kStereoThreads), kStereoThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a, *p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lsd_observe_fuse(const LsdEplPtrs* a, const LsdEplParams* p,
                                void* stream) {
  observe_fuse_kernel<<<grid_of(p->n_pix, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a, *p);
  return static_cast<int>(cudaGetLastError());
}
