// An earlier lsd_slam_tpu_torch/csrc/sim3_track.cu, kept to be measured
// against the current kernel: commit 681971f's kernel (one launch per
// direction of a constraint stage and per level, the final pass a launch
// of its own) with only the phase stamps of the current kernel added (a
// `long long* stamps` argument after `final_out`, null or an int64 buffer
// where lane 0's leader thread writes clock64() at the start, the end of
// its own sweep and the end of the fold of every pass, 3 slots a pass,
// and at the loop's end in slot 3 * (max_trials + 1)). Built and bound by
// `chip_smoke.py --baseline-sim3-cu baselines/<this file>`, which checks
// its sha256; the package never builds it.
//
// One pyramid level's Levenberg-Marquardt loop of the Sim(3) tracker on
// Hopper: every trial of every lane of a constraint stage, on the device,
// in one launch, each lane's level spread over a thread-block cluster.
//
// Replaces the XLA `lax.while_loop` of the JAX package's `_sim3_impl`
// (lsd_slam_tpu/tracking/sim3_tracker.py:265-314; no Pallas kernel) with
// its passes `_sim3_residual_pass` (:61), `_sim3_weights` (:140) and
// `_sim3_normal_equations` (:177). Its plain version is
// lsd_slam_tpu_torch/tracking/sim3_tracker.py `level_plain`, which repeats
// these steps in torch ops. A launch with no trials (max_trials = 0) is
// one pass at the given pose: the tracker's final pass (:321-350), whose
// totals it returns in `final_out`.
//
// The design is lm_track.cu's (the SE(3) and quick loops), widened to the
// Sim(3) pass. One cluster of C blocks per lane (a grid of B * C blocks;
// the wrapper picks C, a power of two up to 16). The cluster runs the loop:
//   pass(pose)                      -> A, g, n, last_err, diverged0, affine
//   while (iter < max_its && !done && trials < max_trials):
//     leader: inc = solve(A/n + lam diag(diag A/n) + 1e-12 I, g/n),
//             blown = !(|inc|^2 in [0, 1)),
//             new_pose = sim3_mul(sim3_exp(inc), pose)
//     all:    pass(new_pose)        -> A', g', n', err, diverged, affine'
//     leader: accept = err < last_err && !(diverged || blown), the lambda
//             schedule, the done / diverged updates, the select of the state
// A trial is: every block sweeps its points and folds them into one
// partial; cluster.sync(); warp 0 of block 0 (the leader) folds the C
// partials through distributed shared memory and runs the tail; it writes
// the next pose's scaled rotation, translation, the ESM roll matrix, the
// affine pair and the loop flag into every block's shared memory;
// cluster.sync(). Every block reads the flag from its own shared memory:
// no grid-wide barrier, and no lane waits on another.
//
// One pass, per point: the Sim(3) warp, one 80-byte gather of the quad
// row [I, gx, gy, idepth, idepth_var] x 4 taps (five float4 loads), the
// bilinear sample, the ESM gradient (the mean of the frame's gradient and
// the reference's turned by the roll matrix), the residual, the affine
// moments (min(1, 2/|r|) weights), the depth residual at the nearest tap,
// the coupled Huber weights, and J6 (photometric) and J4 (depth, at
// dimensions 2, 3, 4, 6) folded into LGS7. It adds 43 f32 terms: A7's
// upper triangle (28; each term the J6 product plus the J4 product where
// both dimensions have one), g7 (7), the photometric and depth error sums,
// the five moments and the usage; and two counts (in image, with depth)
// by ballot. The per-point terms are written as the plain version writes
// them; the file is compiled with -fmad=false, so no product is
// contracted into an FMA.
//
// The sums are f64 in an order that does not depend on C, as in
// lm_track.cu: T = `leaves` chunks of `chunk` consecutive points (from the
// point count alone); a warp sums a chunk in rounds of 32 points, one a
// lane, each lane writing its point's terms to its row of the warp's tile
// (32 rows of 43 floats), then lane k adding column k, and lanes 0-10 also
// column 32 + k, in point order; the chunk sums fold along a fixed binary
// tree over the chunk index (block r folds its aligned subtree, the leader
// the top log2(C) levels). So every power of two C gives the same bits.
// Each total is rounded to f32 once.
//
// Each block stages its share of the point fields in shared memory once
// per launch (int32 index, five f32, the valid byte: 25 B a point); where
// a share exceeds `staged`, the rest is read from device memory. The
// fields may be strided (`pts_step`: the tracker runs levels 1 and 2 on
// every second point) and shared by every lane or one set per lane; the
// quad layout too.
//
// The tail runs on the leader's warp 0 in f32 registers: the 7x7 LU with
// partial pivoting with row r on lane r (the pivot, the first largest
// |m_rk| as LAPACK's getrf, found by a scan every lane repeats),
// sim3_exp's 16-term Horner series of W with W's nine entries on nine
// lanes (IEEE divisions by k + 1), sim3_mul, quat_to_matrix, the roll
// matrix and the schedule, every lane alike. (fail_fac ** k is a product
// of k factors: exact for the default 2.) No array of this file is indexed
// at run time.
//
// Bound (PERF.md): a pass reads 29 B of point fields as given (int64 index,
// five f32, the valid byte) and one 80 B quad row per point.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The launch's constants, by value; must match ops/lm_track.py
// `Sim3Params` (tests/test_torch_sim3_lm.py parses this struct).
struct LsdSim3Params {
  long long pts_stride;   // elements between lanes' point fields (0: shared)
  long long quad_stride;  // floats between lanes' quad layouts (0: shared)
  long long pts_step;     // elements between consecutive points
  int n_points;           // points per lane
  int quad_rows;          // rows of one quad layout (H * W)
  int w, h;
  float fx, fy, cx, cy;
  float fx_half, fy_half; // f32(fx * 0.5), f32(fy * 0.5): the ESM factor
  float u_hi, v_hi;       // f32(w - 1.001), f32(h - 1.001): the clamp
  float var_weight, sigma2, huber_d;
  float min_points;
  float conv_eps, step_min;
  float lam0, success_fac, fail_fac;
  int max_its, max_trials;
  int use_esm;
  int chunk;              // points per chunk
  int leaves;             // chunks of the sum tree, max(T, C)
  int staged;             // points a block stages in shared memory
};

namespace {

using Params = LsdSim3Params;

// 8 warps a block: at 16 the launch bound caps a thread at 128 registers
// and this kernel spills there (56 B); at 8 it takes 168, none spilled
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// f32 sums: A7's upper triangle (28), g7 (7), then
constexpr int kG = 28;
constexpr int kSumP = 35;   // photometric error sum
constexpr int kSumD = 36;   // depth error sum
constexpr int kMom = 37;    // sxx, syy, sx, sy, sw
constexpr int kUsage = 42;
constexpr int kSums = 43;
// then the counts: in image, with depth
constexpr int kCols = kSums + 2;
constexpr int kMaxCluster = 16;
// group roots pending in the binary-counter merge: log2(groups) + 1
constexpr int kStack = 8;
// what a final pass writes per lane: mean, mean_d, mean_p, usage, A (7x7)
constexpr int kFinal = 4 + 49;
// the warps' tiles: 32 rows of kSums f32 terms each
constexpr int kTileBytes = kWarps * 32 * kSums * 4;

// What the leader hands every block for the next pass.
struct Bcast {
  float rot[9], trans[3];  // s R and t of the pose the next pass evaluates
  float roll[4];           // the roll matrix's [0][0], [0][1], [1][0], [1][1]
  float a, b;              // the affine pair the passes use
  int cont;                // the loop goes on
};

// The loop's state, on the leader only.
struct State {
  float pose[8];
  float new_pose[8];
  float A[49], g[7];
  float n;
  float a, b;
  float last_err, lam, inc_sq;
  float mean_d, mean_p, usage;
  int blown;
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

__device__ __forceinline__ void quat_to_matrix(const float* q, float* r) {
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

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// What the blocks need of a pose: s R, t and the roll matrix
// (sim3_tracker._roll_matrix: the rotation taking R's optical axis back to
// -z, times R; rows 0 and 1, columns 0 and 1)
__device__ __forceinline__ void pose_bcast(const float* pose, Bcast& out) {
  float r[9];
  quat_to_matrix(pose, r);
  const float s = pose[7];
#pragma unroll
  for (int k = 0; k < 9; ++k) out.rot[k] = r[k] * s;
#pragma unroll
  for (int k = 0; k < 3; ++k) out.trans[k] = pose[4 + k];
  // rf = R (0, 0, -1) = -R[:, 2]; d = rf . (0, 0, -1) = R[2][2];
  // axis = rf x (0, 0, -1) = (R[1][2], -R[0][2], 0)
  const float d = r[8];
  float q[4] = {1.0f + d, r[5], -r[2], 0.0f};
  const float nrm = clamp_min(
      sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-9f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / nrm;
  float m[9];
  quat_to_matrix(q, m);
  out.roll[0] = m[0] * r[0] + m[1] * r[3] + m[2] * r[6];
  out.roll[1] = m[0] * r[1] + m[1] * r[4] + m[2] * r[7];
  out.roll[2] = m[3] * r[0] + m[4] * r[3] + m[5] * r[6];
  out.roll[3] = m[3] * r[1] + m[4] * r[4] + m[5] * r[7];
}

// lie.sim3_exp: q = so3_exp(omega), t = W(omega, sigma) @ upsilon,
// s = exp(sigma); `tan` is the same in every lane, W's entry (i, j) lives
// on lane 3 i + j, and every lane gets the result
__device__ __forceinline__ void sim3_exp_warp(const float* tan, float* out,
                                              int lane) {
  const float* ups = tan;
  const float* om = tan + 3;
  const float sigma = tan[6];
  const float theta_sq = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  const float theta = sqrtf(theta_sq);
  const float half = 0.5f * theta;
  const bool small = theta_sq < 1e-6f;
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
  // M = sigma I + hat(omega); W = I, then W = I + (M @ W) / (k + 1) for
  // k = 16..1
  const int e = lane < 9 ? lane : 0;
  const int i = e / 3, j = e - 3 * (e / 3);
  const float mi0 = i == 0 ? sigma : (i == 1 ? om[2] : -om[1]);
  const float mi1 = i == 0 ? -om[2] : (i == 1 ? sigma : om[0]);
  const float mi2 = i == 0 ? om[1] : (i == 1 ? -om[0] : sigma);
  const float diag = i == j ? 1.0f : 0.0f;
  float w = diag;
#pragma unroll
  for (int kk = 16; kk >= 1; --kk) {
    const float div = (float)(kk + 1);
    const float w0 = __shfl_sync(kFull, w, j);
    const float w1 = __shfl_sync(kFull, w, 3 + j);
    const float w2 = __shfl_sync(kFull, w, 6 + j);
    const float s = mi0 * w0 + mi1 * w1 + mi2 * w2;
    w = diag + s / div;
  }
  const int ri = lane < 3 ? lane : 0;
  const float wi0 = __shfl_sync(kFull, w, 3 * ri);
  const float wi1 = __shfl_sync(kFull, w, 3 * ri + 1);
  const float wi2 = __shfl_sync(kFull, w, 3 * ri + 2);
  const float t = wi0 * ups[0] + wi1 * ups[1] + wi2 * ups[2];
  out[4] = __shfl_sync(kFull, t, 0);
  out[5] = __shfl_sync(kFull, t, 1);
  out[6] = __shfl_sync(kFull, t, 2);
  out[7] = expf(sigma);
}

// lie.sim3_mul(a, b): q = normalize(qa * qb), t = sa rotate(qa, tb) + ta,
// s = sa sb
__device__ __forceinline__ void sim3_mul(const float* a, const float* b,
                                         float* out) {
  float aw = a[0], ax = a[1], ay = a[2], az = a[3];
  float bw = b[0], bx = b[1], by = b[2], bz = b[3];
  float q[4];
  q[0] = aw * bw - ax * bx - ay * by - az * bz;
  q[1] = aw * bx + ax * bw + ay * bz - az * by;
  q[2] = aw * by - ax * bz + ay * bw + az * bx;
  q[3] = aw * bz + ax * by - ay * bx + az * bw;
  float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = q[i] / nrm;
  // quat_rotate(qa, tb): p + 2 * (w * (v x p) + v x (v x p))
  const float* v = a + 1;
  const float* p = b + 4;
  float vxp[3], vvxp[3];
  cross(v, p, vxp);
  cross(v, vxp, vvxp);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[4 + i] = a[7] * (p[i] + 2.0f * (aw * vxp[i] + vvxp[i])) + a[4 + i];
  out[7] = a[7] * b[7];
}

// m x = x0 with partial pivoting, row r of m and x0[r] on lane r < 7; every
// lane gets the solution in xs
__device__ __forceinline__ void solve7_warp(float (&m)[7], float x,
                                            float (&xs)[7], int lane) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float colk = m[k];
    int piv = k;
    float best = fabsf(__shfl_sync(kFull, colk, k));
#pragma unroll
    for (int r = k + 1; r < 7; ++r) {
      const float v = fabsf(__shfl_sync(kFull, colk, r));
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    // row k after the swap is row piv before it
    float mk[7];
#pragma unroll
    for (int c = k; c < 7; ++c) mk[c] = __shfl_sync(kFull, m[c], piv);
    const float xk = __shfl_sync(kFull, x, piv);
    if (piv != k) {  // the same in every lane
      const int src = lane == k ? piv : (lane == piv ? k : lane);
#pragma unroll
      for (int c = 0; c < 7; ++c) m[c] = __shfl_sync(kFull, m[c], src);
      x = __shfl_sync(kFull, x, src);
    }
    if (lane > k && lane < 7) {
      const float l = m[k] / mk[k];
#pragma unroll
      for (int c = k + 1; c < 7; ++c) m[c] = m[c] - l * mk[c];
      x = x - l * xk;
    }
  }
#pragma unroll
  for (int k = 6; k >= 0; --k) {
    float s = __shfl_sync(kFull, x, k);
#pragma unroll
    for (int c = k + 1; c < 7; ++c)
      s = s - __shfl_sync(kFull, m[c], k) * xs[c];
    xs[k] = s / __shfl_sync(kFull, m[k], k);
  }
}

// The lane's fields in device memory. Kept in shared memory (`lane_s`)
// and read where used, not held in registers through the sweep: the
// points come from the staged copy, and only the quad row and the points
// past the staged share are read through these.
struct Lane {
  const int64_t* idx;
  const float* ival;
  const float* gx;
  const float* gy;
  const float* idp;
  const float* ivr;
  const uint8_t* valid;
  const float* quad;
  long long step;
};

// Dynamic shared memory: the warps' tiles (kTileBytes), then the block's
// staged point fields, `staged` entries each: int32 index, ival, gx, gy,
// idp, ivr (f32), the valid byte. Addressed from this base and
// `Params::staged`, so no pointer to them lives in a register.
extern __shared__ __align__(16) unsigned char dyn_smem[];

// upper-triangle index of A7[a][b], a <= b
__host__ __device__ constexpr int tri7(int a, int b) {
  return a * 7 - (a * (a - 1)) / 2 + (b - a);
}

// One point's terms at the pose in `bc`: the 43 sums into `out` (the
// lane's row of the warp's tile), the in-image and with-depth flags.
// `first` and `count`: the lane's index of the block's first point and
// the points it staged.
__device__ __forceinline__ void point_terms(const Params& p, const Lane& ln,
                                            int first, int count, int i,
                                            const Bcast& bc, float* out,
                                            bool& in_out, bool& depth_out) {
  const int j = i - first;
  int id;
  bool vld;
  float idpv, ivalv, gxv, gyv, ivrv;
  if (j < count) {
    const int n = p.staged;
    const float* f = reinterpret_cast<const float*>(dyn_smem + kTileBytes);
    id = reinterpret_cast<const int*>(f)[j];
    ivalv = f[n + j];
    gxv = f[2 * n + j];
    gyv = f[3 * n + j];
    idpv = f[4 * n + j];
    ivrv = f[5 * n + j];
    vld = reinterpret_cast<const uint8_t*>(f + 6 * n)[j] != 0;
  } else {
    const long long gi = (long long)i * ln.step;
    // flat pixel indices are below 2^31 (the wrapper checks H * W)
    id = (int)ln.idx[gi];
    vld = ln.valid[gi] != 0;
    idpv = ln.idp[gi];
    ivalv = ln.ival[gi];
    gxv = ln.gx[gi];
    gyv = ln.gy[gi];
    ivrv = ln.ivr[gi];
  }
  const float wm2 = (float)(p.w - 2), hm2 = (float)(p.h - 2);
  const float xs = (float)(id % p.w);
  const float ys = (float)(id / p.w);
  const float safe_id = vld ? idpv : 1.0f;
  const float z_ref = 1.0f / safe_id;
  const float px = (xs - p.cx) / p.fx * z_ref;
  const float py = (ys - p.cy) / p.fy * z_ref;
  const float* rt = bc.rot;
  const float wx = rt[0] * px + rt[1] * py + rt[2] * z_ref + bc.trans[0];
  const float wy = rt[3] * px + rt[4] * py + rt[5] * z_ref + bc.trans[1];
  const float wz = rt[6] * px + rt[7] * py + rt[8] * z_ref + bc.trans[2];
  const float safe_wz = wz == 0.0f ? 1e-9f : wz;
  const float u = wx / safe_wz * p.fx + p.cx;
  const float v = wy / safe_wz * p.fy + p.cy;
  const bool in_img = (u > 1.0f) & (v > 1.0f) & (u < wm2) & (v < hm2) & vld;

  // quad_sample: clamp, floor, one row of 20 floats
  const float uc = clamp_nan(u, 0.0f, p.u_hi);
  const float vc = clamp_nan(v, 0.0f, p.v_hi);
  const float u0 = floorf(uc), v0 = floorf(vc);
  long long row = trunc_int(v0) * p.w + trunc_int(u0);
  row = row < 0 ? 0 : (row > p.quad_rows - 1 ? p.quad_rows - 1 : row);
  const float fu = uc - u0, fv = vc - v0;
  const float4* q4 = reinterpret_cast<const float4*>(ln.quad + row * 20);
  const float4 q0 = __ldg(q4), q1 = __ldg(q4 + 1), q2 = __ldg(q4 + 2);
  const float4 q3 = __ldg(q4 + 3), q4v = __ldg(q4 + 4);
  const float w00 = (1.0f - fu) * (1.0f - fv);
  const float w01 = fu * (1.0f - fv);
  const float w10 = (1.0f - fu) * fv;
  const float w11 = fu * fv;
  // row = [I gx gy id var | the same at (x+1) | (y+1) | (x+1, y+1)]
  const float i_new = q0.x * w00 + q1.y * w01 + q2.z * w10 + q3.w * w11;
  const float gxn = q0.y * w00 + q1.z * w01 + q2.w * w10 + q4v.x * w11;
  const float gyn = q0.z * w00 + q1.w * w01 + q3.x * w10 + q4v.y * w11;
  // quad_nearest: the tap right of / below the sample past the half pixel
  const bool right = fu > 0.5f, down = fv > 0.5f;
  const float f_id = down ? (right ? q4v.z : q3.y) : (right ? q2.x : q0.w);
  const float f_var = down ? (right ? q4v.w : q3.z) : (right ? q2.y : q1.x);

  float dx, dy;
  if (p.use_esm) {
    const float rgx = bc.roll[0] * gxv + bc.roll[1] * gyv;
    const float rgy = bc.roll[2] * gxv + bc.roll[3] * gyv;
    dx = p.fx_half * (gxn + rgx);
    dy = p.fy_half * (gyn + rgy);
  } else {
    dx = p.fx * gxn;
    dy = p.fy * gyn;
  }

  const float c1 = bc.a * ivalv + bc.b;
  const float rp = c1 - i_new;
  const float arp = fabsf(rp);
  const float wa = in_img ? (arp < 2.0f ? 1.0f : 2.0f / clamp_min(arp, 1e-6f))
                          : 0.0f;
  out[kMom + 0] = c1 * c1 * wa;
  out[kMom + 1] = i_new * i_new * wa;
  out[kMom + 2] = c1 * wa;
  out[kMom + 3] = i_new * wa;
  out[kMom + 4] = wa;

  const bool has_depth = in_img & (f_var > 0.0f);
  const float rd = has_depth ? 1.0f / safe_wz - f_id : 0.0f;
  const float ratio = z_ref / (in_img ? safe_wz : 1.0f);
  out[kUsage] = in_img ? (ratio > 1.0f ? 1.0f : ratio) : 0.0f;
  in_out = in_img;
  depth_out = has_depth;

  // weights (calcSim3WeightsAndResidual)
  const float t0 = bc.trans[0], t1 = bc.trans[1], t2 = bc.trans[2];
  const float pz = in_img ? wz : 1.0f;
  const float d = in_img ? idpv : 1.0f;
  const float g0 = (t0 * pz - t2 * wx) / (pz * pz * d);
  const float g1 = (t1 * pz - t2 * wy) / (pz * pz * d);
  const float g2 = (pz - t2) / (pz * pz * d);
  const float s = p.var_weight * ivrv;
  const float sv = p.var_weight * f_var;
  const float drpdd = dx * g0 + dy * g1;
  const float w_p = 1.0f / (p.sigma2 + s * drpdd * drpdd);
  const float w_d = 1.0f / clamp_min(sv + g2 * g2 * s, 1e-12f);
  const float wrd = fabsf(rd) * sqrtf(w_d);
  const float wrp = fabsf(rp) * sqrtf(w_p);
  const float w_abs = has_depth ? wrd + wrp : wrp;
  // huber_d / w as torch evaluates a Python float over a tensor: the
  // tensor's reciprocal times the float
  const float wh = w_abs < p.huber_d
                       ? 1.0f : (1.0f / clamp_min(w_abs, 1e-9f)) * p.huber_d;
  const float weight_p = in_img ? wh * w_p : 0.0f;
  const float weight_d = has_depth ? wh * w_d : 0.0f;
  out[kSumP] = weight_p * rp * rp;
  out[kSumD] = weight_d * rd * rd;

  // J6 [tx ty tz rx ry rz] and J4 (LGS4 at dimensions 2, 3, 4, 6)
  const float z = 1.0f / pz;
  const float z2 = z * z;
  float j6[6], j4[4];
  j6[0] = z * dx;
  j6[1] = z * dy;
  j6[2] = -wx * z2 * dx - wy * z2 * dy;
  j6[3] = -wx * wy * z2 * dx - (1.0f + wy * wy * z2) * dy;
  j6[4] = (1.0f + wx * wx * z2) * dx + wx * wy * z2 * dy;
  j6[5] = -wy * z * dx + wx * z * dy;
  j4[0] = z2;
  j4[1] = z2 * wy;
  j4[2] = -z2 * wx;
  j4[3] = z;
  // dimension k of LGS7 is J4's remap[k] (or -1); row a's weighted
  // Jacobian entries j6[a] * weight_p and j4[ra] * weight_d are formed in
  // its turn, so only the ten Jacobian entries stay live
#pragma unroll
  for (int a = 0; a < 7; ++a) {
    const int ra = a == 2 ? 0 : (a == 3 ? 1 : (a == 4 ? 2 : (a == 6 ? 3 : -1)));
    const float j6w = a < 6 ? j6[a] * weight_p : 0.0f;
    const float j4w = ra >= 0 ? j4[ra] * weight_d : 0.0f;
#pragma unroll
    for (int b = a; b < 7; ++b) {
      const int rb =
          b == 2 ? 0 : (b == 3 ? 1 : (b == 4 ? 2 : (b == 6 ? 3 : -1)));
      float t = 0.0f;
      if (a < 6 && b < 6) t = j6w * j6[b];
      if (ra >= 0 && rb >= 0) {
        const float t4 = j4w * j4[rb];
        t = (a < 6 && b < 6) ? t + t4 : t4;
      }
      out[tri7(a, b)] = t;
    }
    float ga = 0.0f;
    if (a < 6) ga = j6w * rp;
    if (ra >= 0) {
      const float g4 = j4w * rd;
      ga = a < 6 ? ga + g4 : g4;
    }
    out[kG + a] = ga;
  }
}

// One pass of this block over its chunks at the pose in `bc`; the block's
// subtree root lands in stk[0]. A warp sums a chunk in rounds of 32 points,
// one a lane: each lane writes its point's terms to its row of the warp's
// tile (`tiles`, 32 rows of kSums floats: an odd stride, so rows and
// columns are free of bank conflicts), then lane k adds column k, and lane
// k < kSums - 32 column 32 + k, in point order into its f64 sums; the
// counts come from ballots.
__device__ void block_pass(const Params& p, const Lane& ln, int first,
                           int count, const Bcast& bc, int rank, int C,
                           double (*cs)[kCols], double (*stk)[kCols],
                           long long* stamp) {
  if (stamp) stamp[0] = clock64();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const tile = reinterpret_cast<float*>(dyn_smem) + warp * 32 * kSums;
  const int per_block = p.leaves / C;
  const int group = per_block < kWarps ? per_block : kWarps;
  const int groups = per_block / group;
  const bool two = lane < kSums - 32;
  for (int gi = 0; gi < groups; ++gi) {
    if (warp < group) {
      const long long leaf = (long long)rank * per_block + gi * group + warp;
      const long long b0 = leaf * p.chunk;
      const int beg = (int)(b0 < p.n_points ? b0 : p.n_points);
      const long long e0 = b0 + p.chunk;
      const int end = (int)(e0 < p.n_points ? e0 : p.n_points);
      double acc = 0.0, acc2 = 0.0;
      int n_in = 0, n_depth = 0;
      for (int base = beg; base < end; base += 32) {
        const int rows = end - base < 32 ? end - base : 32;
        bool in_img = false, has_depth = false;
        if (lane < rows)
          point_terms(p, ln, first, count, base + lane, bc,
                      tile + lane * kSums, in_img, has_depth);
        n_in += __popc(__ballot_sync(kFull, in_img));
        n_depth += __popc(__ballot_sync(kFull, has_depth));
        __syncwarp();
        for (int r = 0; r < rows; ++r) {
          acc += (double)tile[r * kSums + lane];
          if (two) acc2 += (double)tile[r * kSums + 32 + lane];
        }
        __syncwarp();  // the next round writes the tile again
      }
      cs[warp][lane] = acc;
      if (two) cs[warp][32 + lane] = acc2;
      if (lane == 0) {
        cs[warp][kSums] = (double)n_in;
        cs[warp][kSums + 1] = (double)n_depth;
      }
    }
    if (stamp && gi == groups - 1) stamp[1] = clock64();
    __syncthreads();
    if (threadIdx.x < kCols) {
      // the group's subtree (left + right at every node), then the
      // binary-counter merge with the roots of the groups before it
      const int k = threadIdx.x;
      for (int s = 1; s < group; s *= 2)
        for (int i = 0; i < group; i += 2 * s) cs[i][k] = cs[i][k] + cs[i + s][k];
      double root = cs[0][k];
      const int sp = __popc(gi);
      const int merges = __ffs(gi + 1) - 1;
      for (int m = 1; m <= merges; ++m) root = stk[sp - m][k] + root;
      stk[sp - merges][k] = root;
    }
    __syncthreads();
  }
}

// The leader warp's fold of the C block roots (the top levels of the tree,
// padded to 16 with zeros): lane k gets total k in `lo`, lanes k < 13 total
// 32 + k in `hi`.
__device__ __forceinline__ void cluster_fold(cg::cluster_group& cluster,
                                             int C, double (*stk)[kCols],
                                             int lane, double& lo,
                                             double& hi) {
  const int col_hi = lane < kCols - 32 ? 32 + lane : 32;
  double v[kMaxCluster], u[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    const double* root = cluster.map_shared_rank(&stk[0][0], r < C ? r : 0);
    v[r] = r < C ? root[lane] : 0.0;
    u[r] = r < C ? root[col_hi] : 0.0;
  }
#pragma unroll
  for (int s = 1; s < kMaxCluster; s *= 2)
#pragma unroll
    for (int i = 0; i < kMaxCluster; i += 2 * s) {
      v[i] = v[i] + v[i + s];
      u[i] = u[i] + u[i + s];
    }
  lo = v[0];
  hi = u[0];
}

// The leader warp after a pass: the totals' f32 values, the first pass's
// set-up or the trial's accept and schedule, and when the loop goes on the
// next trial's solve and pose. The state is read once into registers (the
// same values in every lane; row r of A on lane r), updated there and
// written back; `next` gets what the blocks need (in every lane).
__device__ void leader_tail(const Params& p, State& st, double lo, double hi,
                            bool first, int lane, Bcast& next) {
  const int r = lane < 7 ? lane : 0;
  float A_cur[7], pose[8], new_pose[8];
#pragma unroll
  for (int c = 0; c < 7; ++c) A_cur[c] = st.A[r * 7 + c];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pose[i] = st.pose[i];
    new_pose[i] = st.new_pose[i];
  }
  float g_cur = st.g[r], n_cur = st.n, aff_a = st.a, aff_b = st.b;
  float last_err = st.last_err, lam = st.lam;
  float mean_d = st.mean_d, mean_p = st.mean_p, usage = st.usage;
  const float inc_sq = st.inc_sq;
  const int blown = st.blown;
  int iter = st.iter, inc_try = st.inc_try, trials = st.trials;
  int done = st.done, diverged = st.diverged;

  // the pass's values: lane k holds total k (lo) and 32 + k (hi)
  const float vlo = (float)lo, vhi = (float)hi;
  const int cnt_in = (int)__shfl_sync(kFull, hi, kSums - 32);
  const int cnt_depth = (int)__shfl_sync(kFull, hi, kSums + 1 - 32);
  const float sum_p = __shfl_sync(kFull, vhi, kSumP - 32);
  const float sum_d = __shfl_sync(kFull, vhi, kSumD - 32);
  const float n_d = clamp_min((float)cnt_depth, 1.0f);
  const float n_p = clamp_min((float)cnt_in, 1.0f);
  const float err = (sum_d + sum_p) / (n_d + n_p);
  const float new_mean_d = sum_d / n_d, new_mean_p = sum_p / n_p;
  const int n_all = cnt_in + cnt_depth;
  const float n_new = (float)(n_all > 1 ? n_all : 1);
  const float sxx = __shfl_sync(kFull, vhi, kMom + 0 - 32);
  const float syy = __shfl_sync(kFull, vhi, kMom + 1 - 32);
  const float sx = __shfl_sync(kFull, vhi, kMom + 2 - 32);
  const float sy = __shfl_sync(kFull, vhi, kMom + 3 - 32);
  const float sw = clamp_min(__shfl_sync(kFull, vhi, kMom + 4 - 32), 1e-6f);
  const float new_usage = __shfl_sync(kFull, vhi, kUsage - 32);
  const float var_c1 = clamp_min(sxx - sx * sx / sw, 1e-6f);
  const float var_c2 = clamp_min(syy - sy * sy / sw, 1e-6f);
  const float a_inc = sqrtf(var_c2 / var_c1);
  const float b_inc = (sy - a_inc * sx) / sw;
  const float a_new = a_inc * aff_a;
  const float b_new = a_inc * aff_b + b_inc;
  // row r of A_new and g_new[r] on lane r < 7
  float A_row[7];
#pragma unroll
  for (int c = 0; c < 7; ++c)
    A_row[c] = __shfl_sync(kFull, vlo, r <= c ? tri7(r, c) : tri7(c, r));
  const float g_lo = __shfl_sync(kFull, vlo, kG + (r < 4 ? r : 0));
  const float g_hi = __shfl_sync(kFull, vhi, kG + (r < 4 ? 4 : r) - 32);
  const float g_r = r < 4 ? g_lo : g_hi;
  const int div_pass = (float)cnt_in < p.min_points;

  bool take = first;  // A, g, n and the affine pair come from this pass
  if (first) {
    last_err = err;
    lam = p.lam0;
    iter = inc_try = trials = 0;
    done = diverged = div_pass;
  } else {
    const int div = div_pass | blown;
    const bool accept = (err < last_err) && !div;
    const bool conv = err / clamp_min(last_err, 1e-12f) > p.conv_eps;
    const bool small = inc_sq < p.step_min;
    float f = 1.0f;
    for (int k = 0; k <= inc_try; ++k) f = f * p.fail_fac;
    const float lam_acc = lam <= 0.2f ? 0.0f : lam * p.success_fac;
    const float lam_rej = lam == 0.0f ? 0.2f : lam * f;
    take = accept;
    if (accept) {
#pragma unroll
      for (int i = 0; i < 8; ++i) pose[i] = new_pose[i];
      last_err = err;
      lam = lam_acc;
      iter += 1;
      inc_try = 0;
    } else {
      lam = lam_rej;
      inc_try += 1;
    }
    trials += 1;
    done = done | div | (accept & conv) | (!accept & small);
    diverged = diverged | div;
  }
  if (take) {
#pragma unroll
    for (int c = 0; c < 7; ++c) A_cur[c] = A_row[c];
    g_cur = g_r;
    n_cur = n_new;
    aff_a = a_new;
    aff_b = b_new;
    mean_d = new_mean_d;
    mean_p = new_mean_p;
    usage = new_usage;
  }
  __syncwarp();  // every lane has read the state
  if (lane < 7) {
#pragma unroll
    for (int c = 0; c < 7; ++c) st.A[r * 7 + c] = A_cur[c];
    st.g[r] = g_cur;
  }
  if (lane == 0) {
    for (int i = 0; i < 8; ++i) st.pose[i] = pose[i];
    st.n = n_cur;
    st.a = aff_a;
    st.b = aff_b;
    st.last_err = last_err;
    st.lam = lam;
    st.mean_d = mean_d;
    st.mean_p = mean_p;
    st.usage = usage;
    st.iter = iter;
    st.inc_try = inc_try;
    st.trials = trials;
    st.done = done;
    st.diverged = diverged;
  }

  const int cont = iter < p.max_its && !done && trials < p.max_trials;
  next.cont = cont;
  next.a = aff_a;
  next.b = aff_b;
  if (!cont) return;
  // the next trial: the damped system, the increment and the new pose
  float m[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    const float a = A_cur[c] / n_cur;
    const float damp = lam * (r == c ? a : 0.0f);
    m[c] = (a + damp) + (r == c ? 1e-12f : 0.0f);
  }
  float inc[7];
  solve7_warp(m, g_cur / n_cur, inc, lane);
  const float isq = inc[0] * inc[0] + inc[1] * inc[1] + inc[2] * inc[2]
                    + inc[3] * inc[3] + inc[4] * inc[4] + inc[5] * inc[5]
                    + inc[6] * inc[6];
  float e[8], np[8];
  sim3_exp_warp(inc, e, lane);
  sim3_mul(e, pose, np);
  if (lane == 0) {
    for (int i = 0; i < 8; ++i) st.new_pose[i] = np[i];
    st.inc_sq = isq;
    st.blown = !((isq >= 0.0f) & (isq < 1.0f));
  }
  pose_bcast(np, next);
}

__global__ void __launch_bounds__(kThreads, 1)
sim3_level_kernel(const int64_t* __restrict__ idx,
                  const float* __restrict__ ival,
                  const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ idp,
                  const float* __restrict__ ivr,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ quad,
                  const float* __restrict__ pose_in,
                  const float* __restrict__ aff_a_in,
                  const float* __restrict__ aff_b_in,
                  float* __restrict__ pose_out, float* __restrict__ aff_a_out,
                  float* __restrict__ aff_b_out, float* __restrict__ err_out,
                  uint8_t* __restrict__ div_out, int* __restrict__ trials_out,
                  int* __restrict__ its_out, float* __restrict__ final_out,
                  long long* __restrict__ stamps, Params p) {
  __shared__ double cs[kWarps][kCols];
  __shared__ double stk[kStack][kCols];
  __shared__ Bcast bc;
  __shared__ State st;
  __shared__ Lane lane_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const bool leader = rank == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long po = (long long)b * p.pts_stride;
  long long* const stamp = (stamps != nullptr && b == 0 && leader
                            && threadIdx.x == 0) ? stamps : nullptr;
  if (threadIdx.x == 0)
    lane_s = {idx + po, ival + po, gx + po, gy + po, idp + po, ivr + po,
              valid + po, quad + (long long)b * p.quad_stride, p.pts_step};

  // stage the block's share of the points
  const long long share = (long long)(p.leaves / C) * p.chunk;
  const long long f0 = rank * share;
  const int first = (int)(f0 < p.n_points ? f0 : p.n_points);
  const long long l0 = f0 + share;
  const int last = (int)(l0 < p.n_points ? l0 : p.n_points);
  const int n_st = last - first < p.staged ? last - first : p.staged;
  {
    const int n = p.staged;
    float* f = reinterpret_cast<float*>(dyn_smem + kTileBytes);
    uint8_t* v = reinterpret_cast<uint8_t*>(f + 6 * n);
    for (int j = threadIdx.x; j < n_st; j += kThreads) {
      const long long gj = (long long)(first + j) * p.pts_step + po;
      reinterpret_cast<int*>(f)[j] = (int)idx[gj];
      f[n + j] = ival[gj];
      f[2 * n + j] = gx[gj];
      f[3 * n + j] = gy[gj];
      f[4 * n + j] = idp[gj];
      f[5 * n + j] = ivr[gj];
      v[j] = valid[gj];
    }
  }
  if (threadIdx.x == 0) {
    float pose[8];
    for (int i = 0; i < 8; ++i) pose[i] = pose_in[b * 8 + i];
    pose_bcast(pose, bc);
    bc.a = aff_a_in[b];
    bc.b = aff_b_in[b];
    bc.cont = 1;
    if (leader) {
      for (int i = 0; i < 8; ++i) st.pose[i] = pose[i];
      st.a = bc.a;
      st.b = bc.b;
    }
  }
  __syncthreads();

  for (int q = 0;; ++q) {
    block_pass(p, lane_s, first, n_st, bc, rank, C, cs, stk,
               stamp ? stamp + 3 * q : nullptr);
    cluster.sync();  // every block's root is written
    if (leader && warp == 0) {
      double lo, hi;
      cluster_fold(cluster, C, stk, lane, lo, hi);
      if (stamp) stamp[3 * q + 2] = clock64();
      Bcast next;
      leader_tail(p, st, lo, hi, q == 0, lane, next);
      if (lane < C) {
        Bcast* dst = cluster.map_shared_rank(&bc, lane);
        if (next.cont) {
          for (int i = 0; i < 9; ++i) dst->rot[i] = next.rot[i];
          for (int i = 0; i < 3; ++i) dst->trans[i] = next.trans[i];
          for (int i = 0; i < 4; ++i) dst->roll[i] = next.roll[i];
        }
        dst->a = next.a;
        dst->b = next.b;
        dst->cont = next.cont;
      }
    }
    cluster.sync();  // the next pass's pose is in every block
    if (!bc.cont) break;
  }

  if (stamp) stamp[3 * (p.max_trials + 1)] = clock64();
  if (leader && threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) pose_out[b * 8 + i] = st.pose[i];
    aff_a_out[b] = st.a;
    aff_b_out[b] = st.b;
    err_out[b] = st.last_err;
    div_out[b] = st.diverged ? 1 : 0;
    trials_out[b] = st.trials;
    its_out[b] = st.iter;
    if (final_out != nullptr) {
      // the accepted pass's residual means, usage and A (made symmetric)
      float* f = final_out + (long long)b * kFinal;
      f[0] = st.last_err;
      f[1] = st.mean_d;
      f[2] = st.mean_p;
      f[3] = st.usage;
      for (int r = 0; r < 7; ++r)
        for (int c = 0; c < 7; ++c)
          f[4 + r * 7 + c] = r <= c ? st.A[r * 7 + c] : st.A[c * 7 + r];
    }
  }
}

// The kernel's attributes, once per device and size: clusters of 16
// (beyond the portable 8) and the dynamic shared memory beyond 48 KB
// (`ready` holds the size set, plus one).
cudaError_t prepare(int smem_max) {
  static int ready[64];
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 64 && ready[dev] > smem_max) return cudaSuccess;
  rc = cudaFuncSetAttribute(sim3_level_kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(sim3_level_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem_max);
  if (rc == cudaSuccess && dev < 64) ready[dev] = smem_max + 1;
  return rc;
}

cudaLaunchConfig_t cluster_config(int lanes, int c, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lanes * c, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The largest power-of-two cluster (up to 16) of which the card can hold
// at least one at `smem` bytes of dynamic shared memory a block; 0 if
// none, or minus a cudaError_t.
extern "C" int lsd_sim3_max_cluster(int smem) {
  cudaError_t rc = prepare(smem);
  if (rc != cudaSuccess) return -(int)rc;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, c, smem, 0, &attr);
    int n = 0;
    rc = cudaOccupancyMaxActiveClusters(&n, (void*)sim3_level_kernel, &cfg);
    if (rc == cudaSuccess && n > 0) return c;
    cudaGetLastError();  // a refused size is an answer, not a fault
  }
  return 0;
}

// B lanes, a cluster of `cluster` blocks each, `smem` bytes of dynamic
// shared memory a block; returns the launch's cudaError_t.
extern "C" int lsd_sim3_level(const int64_t* idx, const float* ival,
                              const float* gx, const float* gy,
                              const float* idp, const float* ivr,
                              const uint8_t* valid, const float* quad,
                              const float* pose_in, const float* aff_a_in,
                              const float* aff_b_in, float* pose_out,
                              float* aff_a_out, float* aff_b_out,
                              float* err_out, uint8_t* div_out,
                              int* trials_out, int* its_out, float* final_out,
                              long long* stamps, int lanes, int cluster,
                              int smem,
                              const LsdSim3Params* params, void* stream) {
  cudaError_t rc = prepare(smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(lanes, cluster, smem, (cudaStream_t)stream, &attr);
  rc = cudaLaunchKernelEx(&cfg, sim3_level_kernel, idx, ival, gx, gy, idp, ivr,
                          valid, quad, pose_in, aff_a_in, aff_b_in, pose_out,
                          aff_a_out, aff_b_out, err_out, div_out, trials_out,
                          its_out, final_out, stamps, *params);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
