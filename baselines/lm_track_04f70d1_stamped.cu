// An earlier lsd_slam_tpu_torch/csrc/lm_track.cu, kept to be measured
// against the current kernel: commit 04f70d1's kernel (one thread block
// per lane) with only the phase stamps of the current kernel added (a
// `long long* stamps` argument after `its_out`, null or an int64 buffer
// where lane 0's thread 0 writes clock64() at the start, the end of the
// sweep and the end of the fold of every pass, and at the end). Built and
// bound by `chip_smoke.py --baseline-lm-cu baselines/<this file>`, which
// checks its sha256; the package never builds it.
//
// One pyramid level's Levenberg-Marquardt loop of the SE(3) and quick
// trackers on Hopper: every trial of every lane, on the device, in one
// launch.
//
// Replaces the XLA `lax.while_loop` programs of the JAX package (no Pallas
// kernel): `_track_level` (lsd_slam_tpu/tracking/se3_tracker.py:184-253)
// and the loop of `_quick_impl` (lsd_slam_tpu/tracking/quick_tracker.py:
// 66-104), with their passes `_residual_pass` (:73), `_weights_pass`
// (:141) and `_normal_equations` (:163). Its plain version is
// lsd_slam_tpu_torch/tracking/lm.py `level_plain`, which repeats these
// steps in torch ops.
//
// One thread block per lane (a grid of B blocks, B = 1 on the main path).
// The block runs the JAX loop itself:
//   pass(pose)                      -> A, g, last_err, diverged0, affine
//   while (iter < max_its && !done && trials < max_trials):
//     thread 0: inc = solve(A + lam diag(diag A) + 1e-12 I, g),
//               new_pose = se3_mul(se3_exp(inc), pose)
//     all:      pass(new_pose)      -> A', g', err, diverged, affine'
//     thread 0: accept = err < last_err && !diverged, the lambda
//               schedule, the done / diverged updates, and the select of
//               the state on accept
// Every thread reads the loop condition from shared memory after a
// barrier, so the early exit happens on the device and a lane never waits
// on another block: no grid-wide barrier, no cooperative launch.
//
// One pass is one sweep over the points, each thread striding over them:
// warp the point, one 48-byte gather of the quad row [I, gx, gy] x 4 taps,
// the bilinear sample, the residual, the affine moments (min(1, 5/|r|)
// weights), the variance-weighted Huber weight and the Jacobian; it adds
// 21 upper-triangle entries of A, 6 of g, the error sum and the five
// moments (33 sums) and the in-image count. The per-point terms are f32
// and written as the plain version writes them; the file is compiled with
// -fmad=false, so no product is contracted into an FMA. The sums are f64:
// each thread adds its points in order, the warp folds with shuffles in a
// fixed tree, thread k folds the 16 warps' k-th sums in order, and each
// total is rounded to f32 once. The result does not depend on scheduling
// (a second pass gives the same bits) and lies nearer the exact sum than an
// f32 reduction. A is symmetric here; the plain version's matmul may
// differ from its transpose in the last bit.
//
// The tail runs on thread 0 in f32: a 6x6 LU solve with partial pivoting
// (the first largest |pivot|, as LAPACK's getrf), then se3_exp (the
// 16-term Horner series of W), se3_mul and quat_to_matrix as
// lsd_slam_tpu_torch/lie/groups.py writes them, both branches of the
// small-angle selects included. (fail_fac ** k is a product of k factors:
// exact for the default 2.)
//
// Bound (PERF.md): the bytes of one pass are 21 B of point fields (int64
// index, three f32, the valid byte) and one 48 B quad row per point, so a
// level at 640x480 (38,400 points at level 1) moves 2.6 MB per trial,
// 0.8 us at 3.35 TB/s; the f64 adds (~33 per point) bound it at one SM's
// f64 rate, not the card's. In practice the chain of trials on one SM
// sets the floor: each trial is a pass, two block barriers, a reduction
// and thread 0's serial tail, and the next trial starts after it. Splitting
// a level over a cluster of blocks (the sums through distributed shared
// memory) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

// The launch's constants, by value. Outside the unnamed namespace: the
// C entry takes a pointer to it and must keep external linkage. Must
// match ops/lm_track.py `Params`.
struct LsdLmParams {
  long long pts_stride;   // elements between lanes' point fields (0: shared)
  long long quad_stride;  // floats between lanes' quad layouts (0: shared)
  int n_points;           // points per lane
  int quad_rows;          // rows of one quad layout (H * W)
  int w, h;
  float fx, fy, cx, cy;
  float u_hi, v_hi;       // f32(w - 1.001), f32(h - 1.001): the clamp
  float var_weight, sigma2, huber_half;
  float min_points;
  float conv_eps, step_min;
  float lam0, success_fac, fail_fac;
  int max_its, max_trials;
  int quick;              // 1: the quick schedule, 0: the SE(3) one
  int use_affine;
};

namespace {

using Params = LsdLmParams;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// sums: A's upper triangle (21), g (6), the error, the affine moments
// sxx, syy, sx, sy, sw (5)
constexpr int kErr = 27;
constexpr int kMom = 28;
constexpr int kSums = 33;

struct State {
  float pose[7];
  float new_pose[7];
  float rot[9], trans[3];  // of the pose the next pass evaluates
  float a, b;              // the affine pair the passes use
  float A[36], g[6];
  float last_err, lam, inc_sq;
  int iter, inc_try, trials, done, diverged;
};

// torch.clamp_min / jnp.maximum: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// XLA's f32 -> s32: truncate, NaN -> 0, saturate (interp.trunc_int)
__device__ __forceinline__ long long trunc_int(float x) {
  if (x != x) return 0;
  if (x >= 2147483647.0f) return 2147483647LL;
  if (x <= -2147483648.0f) return -2147483648LL;
  return (long long)x;
}

__device__ void quat_to_matrix(const float* q, float* r) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.0f - 2.0f * (yy + zz);
  r[1] = 2.0f * (xy - wz);
  r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz);
  r[4] = 1.0f - 2.0f * (xx + zz);
  r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy);
  r[7] = 2.0f * (yz + wx);
  r[8] = 1.0f - 2.0f * (xx + yy);
}

__device__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// lie.se3_exp: q = so3_exp(omega), t = W(omega, 0) @ upsilon
__device__ void se3_exp(const float* tan, float* out) {
  const float* ups = tan;
  const float* om = tan + 3;
  float theta_sq = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  float theta = sqrtf(theta_sq);
  float half = 0.5f * theta;
  bool small = theta_sq < 1e-6f;
  float k, qw;
  if (small) {
    k = 0.5f - theta_sq / 48.0f;
    qw = 1.0f - theta_sq / 8.0f;
  } else {
    k = sinf(half) / theta;
    qw = cosf(half);
  }
  out[0] = qw;
  out[1] = k * om[0];
  out[2] = k * om[1];
  out[3] = k * om[2];
  // M = sigma I + hat(omega) with sigma = 0 (the same values up to the
  // sign of a zero); W = I, then W = I + (M @ W) / (k + 1) for k = 16..1
  const float m[9] = {0.0f, -om[2], om[1], om[2], 0.0f, -om[0],
                      -om[1], om[0], 0.0f};
  float wm[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  for (int kk = 16; kk >= 1; --kk) {
    float div = (float)(kk + 1);
    float nw[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        float s = m[i * 3 + 0] * wm[0 * 3 + j] + m[i * 3 + 1] * wm[1 * 3 + j]
                  + m[i * 3 + 2] * wm[2 * 3 + j];
        nw[i * 3 + j] = (i == j ? 1.0f : 0.0f) + s / div;
      }
    for (int i = 0; i < 9; ++i) wm[i] = nw[i];
  }
  for (int i = 0; i < 3; ++i)
    out[4 + i] = wm[i * 3 + 0] * ups[0] + wm[i * 3 + 1] * ups[1]
                 + wm[i * 3 + 2] * ups[2];
}

// lie.se3_mul(a, b): q = normalize(qa * qb), t = rotate(qa, tb) + ta
__device__ void se3_mul(const float* a, const float* b, float* out) {
  float aw = a[0], ax = a[1], ay = a[2], az = a[3];
  float bw = b[0], bx = b[1], by = b[2], bz = b[3];
  float q[4];
  q[0] = aw * bw - ax * bx - ay * by - az * bz;
  q[1] = aw * bx + ax * bw + ay * bz - az * by;
  q[2] = aw * by - ax * bz + ay * bw + az * bx;
  q[3] = aw * bz + ax * by - ay * bx + az * bw;
  float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) out[i] = q[i] / nrm;
  // quat_rotate(qa, tb): p + 2 * (w * (v x p) + v x (v x p))
  const float* v = a + 1;
  const float* p = b + 4;
  float vxp[3], vvxp[3];
  cross(v, p, vxp);
  cross(v, vxp, vvxp);
  for (int i = 0; i < 3; ++i)
    out[4 + i] = (p[i] + 2.0f * (aw * vxp[i] + vvxp[i])) + a[4 + i];
}

// A x = g with partial pivoting; m is overwritten, x holds g in, x out
__device__ void solve6(float* m, float* x) {
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(m[k * 6 + k]);
    for (int r = k + 1; r < 6; ++r) {
      float v = fabsf(m[r * 6 + k]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    if (piv != k) {
      for (int c = 0; c < 6; ++c) {
        float t = m[k * 6 + c];
        m[k * 6 + c] = m[piv * 6 + c];
        m[piv * 6 + c] = t;
      }
      float t = x[k];
      x[k] = x[piv];
      x[piv] = t;
    }
    for (int r = k + 1; r < 6; ++r) {
      float l = m[r * 6 + k] / m[k * 6 + k];
      for (int c = k + 1; c < 6; ++c) m[r * 6 + c] = m[r * 6 + c] - l * m[k * 6 + c];
      x[r] = x[r] - l * x[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float s = x[k];
    for (int c = k + 1; c < 6; ++c) s = s - m[k * 6 + c] * x[c];
    x[k] = s / m[k * 6 + k];
  }
}

struct Lane {
  const int64_t* idx;
  const float* ival;
  const float* idp;
  const float* ivr;
  const uint8_t* valid;
  const float* quad;
};

// One pass over the lane's points at the pose whose rotation and
// translation are in `st` (the residual, weights and normal-equation
// passes); the block's totals land in `tot` / `*cnt`.
__device__ void pass(const Params& p, const Lane& ln, const State& st,
                     double (*red)[kSums], int* redc, double* tot, int* cnt,
                     long long* stamp) {
  if (stamp) stamp[0] = clock64();
  const float r00 = st.rot[0], r01 = st.rot[1], r02 = st.rot[2];
  const float r10 = st.rot[3], r11 = st.rot[4], r12 = st.rot[5];
  const float r20 = st.rot[6], r21 = st.rot[7], r22 = st.rot[8];
  const float t0 = st.trans[0], t1 = st.trans[1], t2 = st.trans[2];
  const float aa = st.a, bb = st.b;
  const float wm2 = (float)(p.w - 2), hm2 = (float)(p.h - 2);
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  int count = 0;

  for (int i = threadIdx.x; i < p.n_points; i += kThreads) {
    // flat pixel indices are below 2^31 (the wrapper checks H * W)
    const int id = (int)ln.idx[i];
    const bool vld = ln.valid[i] != 0;
    const float idpv = ln.idp[i];
    const float xs = (float)(id % p.w);
    const float ys = (float)(id / p.w);
    const float safe_id = vld ? idpv : 1.0f;
    const float z_ref = 1.0f / safe_id;
    const float px = (xs - p.cx) / p.fx * z_ref;
    const float py = (ys - p.cy) / p.fy * z_ref;
    const float wx = r00 * px + r01 * py + r02 * z_ref + t0;
    const float wy = r10 * px + r11 * py + r12 * z_ref + t1;
    const float wz = r20 * px + r21 * py + r22 * z_ref + t2;
    const float safe_wz = wz == 0.0f ? 1e-9f : wz;
    const float u = wx / safe_wz * p.fx + p.cx;
    const float v = wy / safe_wz * p.fy + p.cy;
    const bool in_img = (u > 1.0f) & (v > 1.0f) & (u < wm2) & (v < hm2) & vld;

    // quad_sample: clamp, floor, one row of 12 floats
    const float uc = clamp_nan(u, 0.0f, p.u_hi);
    const float vc = clamp_nan(v, 0.0f, p.v_hi);
    const float u0 = floorf(uc), v0 = floorf(vc);
    long long row = trunc_int(v0) * p.w + trunc_int(u0);
    row = row < 0 ? 0 : (row > p.quad_rows - 1 ? p.quad_rows - 1 : row);
    const float fu = uc - u0, fv = vc - v0;
    const float4* q4 = reinterpret_cast<const float4*>(ln.quad + row * 12);
    const float4 q0 = __ldg(q4), q1 = __ldg(q4 + 1), q2 = __ldg(q4 + 2);
    const float w00 = (1.0f - fu) * (1.0f - fv);
    const float w01 = fu * (1.0f - fv);
    const float w10 = (1.0f - fu) * fv;
    const float w11 = fu * fv;
    // row = [I gx gy | I gx gy (x+1) | (y+1) | (x+1, y+1)]
    const float i_new = q0.x * w00 + q0.w * w01 + q1.z * w10 + q2.y * w11;
    const float gxn = q0.y * w00 + q1.x * w01 + q1.w * w10 + q2.z * w11;
    const float gyn = q0.z * w00 + q1.y * w01 + q2.x * w10 + q2.w * w11;

    const float c1 = aa * ln.ival[i] + bb;
    const float r = c1 - i_new;
    const float ar = fabsf(r);
    const float wa = in_img ? (ar < 5.0f ? 1.0f : 5.0f / clamp_min(ar, 1e-6f))
                            : 0.0f;
    acc[kMom + 0] += (double)(c1 * c1 * wa);
    acc[kMom + 1] += (double)(i_new * i_new * wa);
    acc[kMom + 2] += (double)(c1 * wa);
    acc[kMom + 3] += (double)(i_new * wa);
    acc[kMom + 4] += (double)wa;
    count += in_img ? 1 : 0;

    // weights (calcWeightsAndResidual)
    const float pz = in_img ? wz : 1.0f;
    const float d = in_img ? idpv : 1.0f;
    const float g0 = (t0 * pz - t2 * wx) / (pz * pz * d);
    const float g1 = (t1 * pz - t2 * wy) / (pz * pz * d);
    const float dx = p.fx * gxn;
    const float dy = p.fy * gyn;
    const float drpdd = dx * g0 + dy * g1;
    const float s = p.var_weight * ln.ivr[i];
    const float w_p = 1.0f / (p.sigma2 + s * drpdd * drpdd);
    const float wrp = fabsf(r) * sqrtf(w_p);
    const float wh = wrp < p.huber_half
                         ? 1.0f : p.huber_half / clamp_min(wrp, 1e-9f);
    const float weight = in_img ? wh * w_p : 0.0f;
    acc[kErr] += (double)(weight * r * r);

    // Jacobian [tx ty tz rx ry rz] (calculateWarpUpdate)
    const float z = 1.0f / pz;
    const float z2 = z * z;
    float j[6];
    j[0] = z * dx;
    j[1] = z * dy;
    j[2] = -wx * z2 * dx - wy * z2 * dy;
    j[3] = -wx * wy * z2 * dx - (1.0f + wy * wy * z2) * dy;
    j[4] = (1.0f + wx * wx * z2) * dx + wx * wy * z2 * dy;
    j[5] = -wy * z * dx + wx * z * dy;
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float jw = j[a] * weight;
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += (double)(jw * j[b]);
      acc[21 + a] += (double)(jw * r);
    }
  }

  if (stamp) stamp[1] = clock64();
  // fixed-shape block tree: warp shuffles, then thread k folds the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kSums; ++k)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[warp][k] = acc[k];
    redc[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = 0.0;
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp][threadIdx.x];
    tot[threadIdx.x] = s;
  } else if (threadIdx.x == kSums) {
    int c = 0;
    for (int wp = 0; wp < kWarps; ++wp) c += redc[wp];
    *cnt = c;
  }
  __syncthreads();
  if (stamp) stamp[2] = clock64();
}

// A, g, the error and the updated affine pair from a pass's totals
__device__ void finish(const double* tot, int cnt, const State& st, float* A,
                       float* g, float* err, float* a_new, float* b_new) {
  const float n = cnt > 0 ? (float)cnt : 1.0f;
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      const float v = (float)tot[k++] / n;
      A[a * 6 + b] = v;
      A[b * 6 + a] = v;
    }
  for (int a = 0; a < 6; ++a) g[a] = (float)tot[21 + a] / n;
  *err = (float)tot[kErr] / n;
  const float sxx = (float)tot[kMom + 0], syy = (float)tot[kMom + 1];
  const float sx = (float)tot[kMom + 2], sy = (float)tot[kMom + 3];
  const float sw = (float)tot[kMom + 4];
  const float var_c1 = clamp_min(sxx - sx * sx / sw, 1e-6f);
  const float var_c2 = clamp_min(syy - sy * sy / sw, 1e-6f);
  const float a_inc = sqrtf(var_c2 / var_c1);
  const float b_inc = (sy - a_inc * sx) / sw;
  *a_new = a_inc * st.a;
  *b_new = a_inc * st.b + b_inc;
}

__global__ void __launch_bounds__(kThreads, 1)
lm_level_kernel(const int64_t* __restrict__ idx, const float* __restrict__ ival,
                const float* __restrict__ idp, const float* __restrict__ ivr,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ quad,
                const float* __restrict__ pose_in,
                const float* __restrict__ aff_a_in,
                const float* __restrict__ aff_b_in, float* __restrict__ pose_out,
                float* __restrict__ aff_a_out, float* __restrict__ aff_b_out,
                float* __restrict__ err_out, uint8_t* __restrict__ div_out,
                int* __restrict__ trials_out, int* __restrict__ its_out,
                long long* __restrict__ stamps, Params p) {
  __shared__ State st;
  __shared__ double red[kWarps][kSums];
  __shared__ int redc[kWarps];
  __shared__ double tot[kSums];
  __shared__ int cnt;
  const int b = blockIdx.x;
  // the phase stamps: lane 0's thread 0 only
  long long* const stamp =
      (stamps != nullptr && b == 0 && threadIdx.x == 0) ? stamps : nullptr;
  int n_pass = 0;
  const long long po = (long long)b * p.pts_stride;
  const Lane ln = {idx + po, ival + po, idp + po, ivr + po, valid + po,
                   quad + (long long)b * p.quad_stride};

  if (threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) st.pose[i] = pose_in[b * 7 + i];
    quat_to_matrix(st.pose, st.rot);
    for (int i = 0; i < 3; ++i) st.trans[i] = st.pose[4 + i];
    st.a = aff_a_in[b];
    st.b = aff_b_in[b];
  }
  __syncthreads();
  pass(p, ln, st, red, redc, tot, &cnt, stamp);
  if (threadIdx.x == 0) {
    float a_new, b_new;
    finish(tot, cnt, st, st.A, st.g, &st.last_err, &a_new, &b_new);
    const int div = (float)cnt < p.min_points;
    if (p.use_affine) {
      st.a = a_new;
      st.b = b_new;
    }
    st.lam = p.lam0;
    st.iter = st.inc_try = st.trials = 0;
    st.done = st.diverged = div;
  }
  __syncthreads();

  while (st.iter < p.max_its && !st.done && st.trials < p.max_trials) {
    __syncthreads();  // every thread has read the condition
    if (threadIdx.x == 0) {
      float m[36], inc[6];
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          const float a = st.A[r * 6 + c];
          const float damp = st.lam * (r == c ? a : 0.0f);
          m[r * 6 + c] = (a + damp) + (r == c ? 1e-12f : 0.0f);
        }
      for (int i = 0; i < 6; ++i) inc[i] = st.g[i];
      solve6(m, inc);
      float e[7];
      se3_exp(inc, e);
      se3_mul(e, st.pose, st.new_pose);
      st.inc_sq = inc[0] * inc[0] + inc[1] * inc[1] + inc[2] * inc[2]
                  + inc[3] * inc[3] + inc[4] * inc[4] + inc[5] * inc[5];
      quat_to_matrix(st.new_pose, st.rot);
      for (int i = 0; i < 3; ++i) st.trans[i] = st.new_pose[4 + i];
    }
    __syncthreads();
    ++n_pass;
    pass(p, ln, st, red, redc, tot, &cnt, stamp ? stamp + 3 * n_pass : nullptr);
    if (threadIdx.x == 0) {
      float A_new[36], g_new[6], err, a_new, b_new;
      finish(tot, cnt, st, A_new, g_new, &err, &a_new, &b_new);
      const bool div = (float)cnt < p.min_points;
      const bool accept = (err < st.last_err) && !div;
      const bool conv = err / clamp_min(st.last_err, 1e-12f) > p.conv_eps;
      const bool small = st.inc_sq < p.step_min;
      const float lam = st.lam;
      float lam_acc, lam_rej;
      if (p.quick) {
        lam_acc = clamp_min(lam * 0.5f, 0.0f);
        lam_rej = lam == 0.0f ? 0.2f : lam * 4.0f;
      } else {
        float f = 1.0f;
        for (int k = 0; k <= st.inc_try; ++k) f = f * p.fail_fac;
        lam_acc = lam <= 0.2f ? 0.0f : lam * p.success_fac;
        lam_rej = lam == 0.0f ? 0.2f : lam * f;
      }
      if (accept) {
        for (int i = 0; i < 7; ++i) st.pose[i] = st.new_pose[i];
        if (p.use_affine) {
          st.a = a_new;
          st.b = b_new;
        }
        for (int i = 0; i < 36; ++i) st.A[i] = A_new[i];
        for (int i = 0; i < 6; ++i) st.g[i] = g_new[i];
        st.last_err = err;
        st.lam = lam_acc;
        st.iter += 1;
        st.inc_try = 0;
      } else {
        st.lam = lam_rej;
        st.inc_try += 1;
      }
      st.trials += 1;
      st.done = st.done | div | (accept & conv) | (!accept & small);
      st.diverged = st.diverged | div;
      // the next trial's pass sees the (possibly unchanged) pose; the
      // solve overwrites rot/trans before it
    }
    __syncthreads();
  }

  if (stamp) stamp[3 * (p.max_trials + 1)] = clock64();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) pose_out[b * 7 + i] = st.pose[i];
    aff_a_out[b] = st.a;
    aff_b_out[b] = st.b;
    err_out[b] = st.last_err;
    div_out[b] = st.diverged ? 1 : 0;
    trials_out[b] = st.trials;
    its_out[b] = st.iter;
  }
}

}  // namespace

// B lanes, one block each; returns the launch's cudaError_t.
extern "C" int lsd_lm_level(const int64_t* idx, const float* ival,
                            const float* idp, const float* ivr,
                            const uint8_t* valid, const float* quad,
                            const float* pose_in, const float* aff_a_in,
                            const float* aff_b_in, float* pose_out,
                            float* aff_a_out, float* aff_b_out,
                            float* err_out, uint8_t* div_out, int* trials_out,
                            int* its_out, long long* stamps, int lanes,
                            const LsdLmParams* params, void* stream) {
  lm_level_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(
      idx, ival, idp, ivr, valid, quad, pose_in, aff_a_in, aff_b_in, pose_out,
      aff_a_out, aff_b_out, err_out, div_out, trials_out, its_out, stamps,
      *params);
  return (int)cudaGetLastError();
}
