// One pyramid level's Levenberg-Marquardt loop of the SE(3) and quick
// trackers on Hopper: every trial of every lane, on the device, in one
// launch, each lane's level spread over a thread-block cluster.
//
// Replaces the XLA `lax.while_loop` programs of the JAX package (no Pallas
// kernel): `_track_level` (lsd_slam_tpu/tracking/se3_tracker.py:184-253)
// and the loop of `_quick_impl` (lsd_slam_tpu/tracking/quick_tracker.py:
// 66-104), with their passes `_residual_pass` (:73), `_weights_pass`
// (:141) and `_normal_equations` (:163). Its plain version is
// lsd_slam_tpu_torch/tracking/lm.py `level_plain`, which repeats these
// steps in torch ops.
//
// One cluster of C blocks per lane (a grid of B * C blocks; the wrapper
// picks C, a power of two up to 16). The cluster runs the JAX loop itself:
//   pass(pose)                      -> A, g, last_err, diverged0, affine
//   while (iter < max_its && !done && trials < max_trials):
//     leader: inc = solve(A + lam diag(diag A) + 1e-12 I, g),
//             new_pose = se3_mul(se3_exp(inc), pose)
//     all:    pass(new_pose)        -> A', g', err, diverged, affine'
//     leader: accept = err < last_err && !diverged, the lambda schedule,
//             the done / diverged updates, the select of the state
// A trial is: every block sweeps its points and folds them into one
// partial; cluster.sync(); warp 0 of block 0 (the leader) folds the C
// partials through distributed shared memory and runs the tail; it writes
// the next pose's rotation, translation, the affine pair and the loop
// flag into every block's shared memory; cluster.sync(). Every block reads
// the flag from its own shared memory, so the early exit stays on the
// device and no lane waits on another: no grid-wide barrier.
//
// One pass, per point: warp the point, one 48-byte gather of the quad row
// [I, gx, gy] x 4 taps, the bilinear sample, the residual, the affine
// moments (min(1, 5/|r|) weights), the variance-weighted Huber weight and
// the Jacobian; it adds 21 upper-triangle entries of A, 6 of g, the error
// sum and the five moments (33 sums) and the in-image count. The per-point
// terms are f32 and written as the plain version writes them; the file is
// compiled with -fmad=false, so no product is contracted into an FMA.
//
// The sums are f64 in an order that does not depend on C. The points are
// cut into T = `leaves` chunks of `chunk` consecutive points (from the
// point count alone: one point a lane, 32 a chunk, until there are 256
// chunks, then larger chunks; T a power of two). A warp sums a chunk in
// rounds of 32 points, one a lane: each lane writes its point's terms to
// its row of the warp's tile in shared memory, then lane k adds column k
// into its f64 sum in point order (the 33rd sum through a fixed shuffle
// tree per round): no per-lane f64 accumulators, no 33-column shuffle
// tree. The chunk sums fold along a fixed binary tree over the chunk index
// (T padded to max(T, C) with zero chunks; x + 0.0 is x): block r owns the
// aligned leaves [r T/C, (r+1) T/C) and folds that subtree (in groups of
// 16, a chunk a warp, the group roots merged as a binary counter merges),
// and the leader folds the top log2(C) levels. So every power of two C
// gives the same tree and the same bits, and a second launch the first
// one's. Each total is rounded to f32 once.
//
// Each block stages its share of the point fields in shared memory once
// per launch (int32 index, three f32, the valid byte: 17 B a point), so
// every trial reads them there and only the quad gather goes to L2; where
// a share exceeds `staged`, the rest is read from device memory.
//
// The tail runs on the leader's warp 0 in f32 registers: `finish` with
// one lane per total, the 6x6 LU with partial pivoting with row r on lane
// r (the pivot, the first largest |m_rk| as LAPACK's getrf, found by a
// scan of shuffled values every lane repeats), se3_exp's 16-term Horner
// series of W with W's nine entries on nine lanes, then se3_mul,
// quat_to_matrix and the schedule, every lane alike. Each value comes from
// the same operations in the same order as in the one-thread tail this
// replaced, so the tail gives its bits on the same totals. (fail_fac ** k
// is a product of k factors: exact for the default 2.) No array of this
// file is indexed at run time; the 32-byte stack frame ptxas reports is
// sinf / cosf's reduction of arguments above 105615, kept for those bits.
//
// Bound (PERF.md): a pass reads 21 B of point fields (int64 index, three
// f32, the valid byte) and one 48 B quad row per point, so a level at
// 640x480 (38,400 points at level 1) moves 2.6 MB per trial, 0.8 us at
// 3.35 TB/s. In practice the chain of trials sets the floor: a pass's
// sweep is latency-bound at the small levels, and each trial pays a fold
// and the serial tail. The one-block-per-lane kernel this replaced ran the
// sweep on one SM of 132 (121 us a pass at level 1), read the point fields
// from device memory every trial, and paid 11.5 us a trial for thread 0's
// tail (the LU's pivot indexed a local array) behind three block barriers.
// Here the sweep spreads over C SMs (11 us at level 1 with C = 16, 2 us at
// level 4), the fields come from shared memory, and a trial pays a local
// fold and two cluster barriers (1.4-2.1 us) and the warp's tail (3.7 us).
//
// `stamps` (null on every engine path) takes the leader thread's clock64()
// at the start, the end of its own sweep and the end of the fold of every
// pass (3 slots a pass), and the launch's end, for the first lane.
//
// The SE(3) track (tracking/se3_tracker.py `track`) launches this kernel
// once a level and nothing else, so a launch also does what the track did
// around its loops in torch ops:
//   * `invert`: `pose_in` holds frame_to_ref, the level starts at its
//     inverse (lie.se3_inverse, written as the plain version writes it);
//   * null affine inputs: the pair starts at (1, 0);
//   * `div_in` (null, or the previous level's flags): `div_out` is their
//     OR with this level's flag, the track's `diverged`;
//   * `fin` (the track's last level; its pointers null on every other
//     launch): after the loop, the final pass of `track_plain`
//     (`final_pass_plain`: `_residual_pass` and `_weights_pass` at the
//     loop's pose and affine pair) over the points the cluster staged. Per
//     point it adds the usage term, the good and bad flags (f64 sums of
//     0 / 1: exact) and the error to the sum tree in place of A's first
//     three entries, and writes the good flag into the level's (H, W)
//     grid, which the cluster filled with 1 before its first pass (pixels
//     outside the point set stay good; padding slots write nothing). The
//     leader's tail then writes the track's outputs: the in-image, good
//     and bad counts, tracking_good and the 23-entry pack in the order of
//     se3_tracker.HOST_PACK (the pose, identity where diverged; its
//     inverse; diverged; tracking_good; the final error; the point usage;
//     the good and bad counts; the affine pair; the initial residual).
// The final pass adds one pass of time at the track's last level and no
// trial; the quick tracker's launches pass none of these and run as
// before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The launch's constants, by value. Outside the unnamed namespace: the
// C entry takes a pointer to it and must keep external linkage. Must
// match ops/lm_track.py `Params` (tests/test_torch_lm_cluster.py parses
// this struct and compares).
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
  int chunk;              // points per chunk
  int leaves;             // chunks of the sum tree, max(T, C)
  int staged;             // points a block stages in shared memory
  int invert;             // 1: pose_in holds the inverse of the start pose
  float max_diff_const, max_diff_grad;  // the final pass's good-point test
  float min_gpa, min_gpgb;  // tracking_good: good / pixels, good / (g + b)
};

// The final pass's outputs, one row a lane; every pointer null on a launch
// without it. Must match ops/lm_track.py `Final`.
struct LsdLmFinal {
  uint8_t* good_mask;      // (B, h * w) bool: the good-pixel grid
  float* pack;             // (B, 23): se3_tracker.HOST_PACK's order
  uint8_t* tracking_good;  // (B,) bool
  long long* counts;       // (B, 3): in-image, good, bad
  const float* n_valid;    // the point set's valid count, per lane or shared
  long long n_valid_stride;  // elements between lanes' n_valid (0: shared)
};

namespace {

using Params = LsdLmParams;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// sums: A's upper triangle (21), g (6), the error, the affine moments
// sxx, syy, sx, sy, sw (5); then the in-image count
constexpr int kErr = 27;
constexpr int kMom = 28;
constexpr int kSums = 33;
// the final pass's sums, in place of A's first three entries
constexpr int kUsage = 0;
constexpr int kGood = 1;
constexpr int kBad = 2;
constexpr int kPack = 23;
constexpr int kCols = kSums + 1;
constexpr int kMaxCluster = 16;
// group roots pending in the binary-counter merge: log2(groups) + 1
constexpr int kStack = 24;

// What the leader hands every block for the next pass.
struct Bcast {
  float rot[9], trans[3];  // of the pose the next pass evaluates
  float a, b;              // the affine pair the passes use
  int cont;                // the loop goes on
};

// The loop's state, on the leader only.
struct State {
  float pose[7];
  float new_pose[7];
  float A[36], g[6];
  float a, b;
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

// lie.se3_exp: q = so3_exp(omega), t = W(omega, 0) @ upsilon; `tan` is
// the same in every lane, W's entry (i, j) lives on lane 3 i + j, and
// every lane gets the result
__device__ __forceinline__ void se3_exp_warp(const float* tan, float* out,
                                             int lane) {
  const float* ups = tan;
  const float* om = tan + 3;
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
  // M = sigma I + hat(omega) with sigma = 0 (the same values up to the
  // sign of a zero); W = I, then W = I + (M @ W) / (k + 1) for k = 16..1
  const int e = lane < 9 ? lane : 0;
  const int i = e / 3, j = e - 3 * (e / 3);
  const float mi0 = i == 0 ? 0.0f : (i == 1 ? om[2] : -om[1]);
  const float mi1 = i == 0 ? -om[2] : (i == 1 ? 0.0f : om[0]);
  const float mi2 = i == 0 ? om[1] : (i == 1 ? -om[0] : 0.0f);
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
}

// lie.se3_mul(a, b): q = normalize(qa * qb), t = rotate(qa, tb) + ta
__device__ __forceinline__ void se3_mul(const float* a, const float* b,
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
    out[4 + i] = (p[i] + 2.0f * (aw * vxp[i] + vvxp[i])) + a[4 + i];
}

// lie.se3_inverse(g): the conjugate and -quat_rotate(conjugate, t)
__device__ __forceinline__ void se3_inverse(const float* g, float* out) {
  out[0] = g[0];
  out[1] = -g[1];
  out[2] = -g[2];
  out[3] = -g[3];
  float vxp[3], vvxp[3];
  cross(out + 1, g + 4, vxp);
  cross(out + 1, vxp, vvxp);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[4 + i] = -(g[4 + i] + 2.0f * (out[0] * vxp[i] + vvxp[i]));
}

// m x = x0 with partial pivoting, row r of m and x0[r] on lane r < 6; every
// lane gets the solution in xs
__device__ __forceinline__ void solve6_warp(float (&m)[6], float x,
                                            float (&xs)[6], int lane) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float colk = m[k];
    int piv = k;
    float best = fabsf(__shfl_sync(kFull, colk, k));
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float v = fabsf(__shfl_sync(kFull, colk, r));
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    // row k after the swap is row piv before it
    float mk[6];
#pragma unroll
    for (int c = k; c < 6; ++c) mk[c] = __shfl_sync(kFull, m[c], piv);
    const float xk = __shfl_sync(kFull, x, piv);
    if (piv != k) {  // the same in every lane
      const int src = lane == k ? piv : (lane == piv ? k : lane);
#pragma unroll
      for (int c = 0; c < 6; ++c) m[c] = __shfl_sync(kFull, m[c], src);
      x = __shfl_sync(kFull, x, src);
    }
    if (lane > k && lane < 6) {
      const float l = m[k] / mk[k];
#pragma unroll
      for (int c = k + 1; c < 6; ++c) m[c] = m[c] - l * mk[c];
      x = x - l * xk;
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float s = __shfl_sync(kFull, x, k);
#pragma unroll
    for (int c = k + 1; c < 6; ++c)
      s = s - __shfl_sync(kFull, m[c], k) * xs[c];
    xs[k] = s / __shfl_sync(kFull, m[k], k);
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

// A block's staged point fields (dynamic shared memory).
struct Staged {
  const int* idx;
  const float* ival;
  const float* idp;
  const float* ivr;
  const uint8_t* valid;
  int first;  // the lane's index of the block's first point
  int count;  // points staged
};

// One point's terms at the pose in `rt` (rotation, translation) and the
// affine pair: sums 0-31 into `out` (the lane's row of the warp's tile),
// the 33rd (the moment weight) into `w_out`, the in-image flag into
// `in_out`. In the final pass (`kFinal`) the usage term and the good and
// bad flags replace sums 0-2, and a valid point's good flag goes to its
// pixel of `grid`.
template <bool kFinal>
__device__ __forceinline__ void point_terms(
    const Params& p, const Lane& ln, const Staged& sm, int i,
    const float (&rt)[12], float aa, float bb, float* out, float& w_out,
    bool& in_out, uint8_t* grid) {
  const int j = i - sm.first;
  const bool st = j < sm.count;
  // flat pixel indices are below 2^31 (the wrapper checks H * W)
  const int id = st ? sm.idx[j] : (int)ln.idx[i];
  const bool vld = (st ? sm.valid[j] : ln.valid[i]) != 0;
  const float idpv = st ? sm.idp[j] : ln.idp[i];
  const float ivalv = st ? sm.ival[j] : ln.ival[i];
  const float ivrv = st ? sm.ivr[j] : ln.ivr[i];
  const float wm2 = (float)(p.w - 2), hm2 = (float)(p.h - 2);
  const float xs = (float)(id % p.w);
  const float ys = (float)(id / p.w);
  const float safe_id = vld ? idpv : 1.0f;
  const float z_ref = 1.0f / safe_id;
  const float px = (xs - p.cx) / p.fx * z_ref;
  const float py = (ys - p.cy) / p.fy * z_ref;
  const float wx = rt[0] * px + rt[1] * py + rt[2] * z_ref + rt[9];
  const float wy = rt[3] * px + rt[4] * py + rt[5] * z_ref + rt[10];
  const float wz = rt[6] * px + rt[7] * py + rt[8] * z_ref + rt[11];
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

  const float c1 = aa * ivalv + bb;
  const float r = c1 - i_new;
  const float ar = fabsf(r);
  const float wa = in_img ? (ar < 5.0f ? 1.0f : 5.0f / clamp_min(ar, 1e-6f))
                          : 0.0f;
  out[kMom + 0] = c1 * c1 * wa;
  out[kMom + 1] = i_new * i_new * wa;
  out[kMom + 2] = c1 * wa;
  out[kMom + 3] = i_new * wa;
  w_out = wa;  // kMom + 4
  in_out = in_img;

  // weights (calcWeightsAndResidual)
  const float t0 = rt[9], t1 = rt[10], t2 = rt[11];
  const float pz = in_img ? wz : 1.0f;
  const float d = in_img ? idpv : 1.0f;
  const float g0 = (t0 * pz - t2 * wx) / (pz * pz * d);
  const float g1 = (t1 * pz - t2 * wy) / (pz * pz * d);
  const float dx = p.fx * gxn;
  const float dy = p.fy * gyn;
  const float drpdd = dx * g0 + dy * g1;
  const float s = p.var_weight * ivrv;
  const float w_p = 1.0f / (p.sigma2 + s * drpdd * drpdd);
  const float wrp = fabsf(r) * sqrtf(w_p);
  const float wh = wrp < p.huber_half
                       ? 1.0f : p.huber_half / clamp_min(wrp, 1e-9f);
  const float weight = in_img ? wh * w_p : 0.0f;
  out[kErr] = weight * r * r;

  // Jacobian [tx ty tz rx ry rz] (calculateWarpUpdate)
  const float z = 1.0f / pz;
  const float z2 = z * z;
  float jac[6];
  jac[0] = z * dx;
  jac[1] = z * dy;
  jac[2] = -wx * z2 * dx - wy * z2 * dy;
  jac[3] = -wx * wy * z2 * dx - (1.0f + wy * wy * z2) * dy;
  jac[4] = (1.0f + wx * wx * z2) * dx + wx * wy * z2 * dy;
  jac[5] = -wy * z * dx + wx * z * dy;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float jw = jac[a] * weight;
#pragma unroll
    for (int b = a; b < 6; ++b) out[k++] = jw * jac[b];
    out[21 + a] = jw * r;
  }
  if (kFinal) {
    // _residual_pass's good test and usage term (SE3Tracker.cpp:475-484)
    const float den = p.max_diff_const
                      + p.max_diff_grad * (gxn * gxn + gyn * gyn);
    const bool good = (r * r / den) < 1.0f;
    const float uz = z_ref / (in_img ? safe_wz : 1.0f);
    out[kUsage] = in_img ? (uz > 1.0f ? 1.0f : uz) : 0.0f;  // NaN passes
    out[kGood] = good && in_img ? 1.0f : 0.0f;
    out[kBad] = !good && in_img ? 1.0f : 0.0f;
    if (vld) grid[id] = good && in_img ? 1 : 0;
  }
}

// One pass of this block over its chunks at the pose in `bc`; the block's
// subtree root lands in stk[0]. A warp sums a chunk in rounds of 32 points,
// one a lane: each lane writes its point's terms to its row of the warp's
// tile (`tiles`, 32 rows of kSums floats: an odd stride, so rows and
// columns are free of bank conflicts), then lane k adds column k (k < 32)
// in point order into its f64 sum; the 33rd sum goes through a fixed f64
// shuffle tree per round, the in-image count through a ballot.
// `stamp`: the leader thread's slots; `kFinal` / `grid`: the final pass
// (`point_terms`).
template <bool kFinal>
__device__ void block_pass(const Params& p, const Lane& ln, const Staged& sm,
                           const Bcast& bc, int rank, int C, float* tiles,
                           double (*cs)[kCols], double (*stk)[kCols],
                           long long* stamp, uint8_t* grid) {
  if (stamp) stamp[0] = clock64();
  float rt[12];
#pragma unroll
  for (int k = 0; k < 9; ++k) rt[k] = bc.rot[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) rt[9 + k] = bc.trans[k];
  const float aa = bc.a, bb = bc.b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* const tile = tiles + warp * 32 * kSums;
  const int per_block = p.leaves / C;
  const int group = per_block < kWarps ? per_block : kWarps;
  const int groups = per_block / group;
  for (int gi = 0; gi < groups; ++gi) {
    if (warp < group) {
      const long long leaf = (long long)rank * per_block + gi * group + warp;
      const long long b0 = leaf * p.chunk;
      const int beg = (int)(b0 < p.n_points ? b0 : p.n_points);
      const long long e0 = b0 + p.chunk;
      const int end = (int)(e0 < p.n_points ? e0 : p.n_points);
      double acc = 0.0, acc_w = 0.0;
      int count = 0;
      for (int base = beg; base < end; base += 32) {
        const int rows = end - base < 32 ? end - base : 32;
        float w = 0.0f;
        bool in_img = false;
        if (lane < rows)
          point_terms<kFinal>(p, ln, sm, base + lane, rt, aa, bb,
                              tile + lane * kSums, w, in_img, grid);
        count += __popc(__ballot_sync(kFull, in_img));
        double wd = (double)w;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          wd += __shfl_down_sync(kFull, wd, off);
        acc_w += wd;  // lane 0's is the round's total
        __syncwarp();
        for (int j = 0; j < rows; ++j)
          acc += (double)tile[j * kSums + lane];
        __syncwarp();  // the next round writes the tile again
      }
      cs[warp][lane] = acc;
      if (lane == 0) {
        cs[warp][kSums - 1] = acc_w;
        cs[warp][kSums] = (double)count;
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
// padded to 16 with zeros): lane k gets total k, lanes 0 and 1 also totals
// 32 and 33 in `hi`.
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

// upper-triangle index of A[a][b], a <= b
__device__ __forceinline__ int tri(int a, int b) {
  return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

// The leader warp after a pass: `finish` on the totals, the first pass's
// set-up or the trial's accept and schedule, and when the loop goes on the
// next trial's solve and pose. The state is read once into registers (the
// same values in every lane; row r of A on lane r), updated there and
// written back; `next` gets what the blocks need (in every lane).
__device__ void leader_tail(const Params& p, State& st, double lo, double hi,
                            bool first, int lane, Bcast& next) {
  const int r = lane < 6 ? lane : 0;
  float A_cur[6], pose[7], new_pose[7];
#pragma unroll
  for (int c = 0; c < 6; ++c) A_cur[c] = st.A[r * 6 + c];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pose[i] = st.pose[i];
    new_pose[i] = st.new_pose[i];
  }
  float g_cur = st.g[r], aff_a = st.a, aff_b = st.b;
  float last_err = st.last_err, lam = st.lam;
  const float inc_sq = st.inc_sq;
  int iter = st.iter, inc_try = st.inc_try, trials = st.trials;
  int done = st.done, diverged = st.diverged;

  // finish: A, g, the error and the updated affine pair
  const int cnt = (int)__shfl_sync(kFull, hi, 1);
  const float n = cnt > 0 ? (float)cnt : 1.0f;
  const float v = (float)lo / n;  // lane k < 28: A's entry k, g, the error
  const float err = __shfl_sync(kFull, v, kErr);
  const float sxx = __shfl_sync(kFull, (float)lo, kMom + 0);
  const float syy = __shfl_sync(kFull, (float)lo, kMom + 1);
  const float sx = __shfl_sync(kFull, (float)lo, kMom + 2);
  const float sy = __shfl_sync(kFull, (float)lo, kMom + 3);
  const float sw = __shfl_sync(kFull, (float)hi, 0);
  const float var_c1 = clamp_min(sxx - sx * sx / sw, 1e-6f);
  const float var_c2 = clamp_min(syy - sy * sy / sw, 1e-6f);
  const float a_inc = sqrtf(var_c2 / var_c1);
  const float b_inc = (sy - a_inc * sx) / sw;
  const float a_new = a_inc * aff_a;
  const float b_new = a_inc * aff_b + b_inc;
  // row r of A_new and g_new[r] on lane r < 6
  float A_row[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    A_row[c] = __shfl_sync(kFull, v, r <= c ? tri(r, c) : tri(c, r));
  const float g_r = __shfl_sync(kFull, v, 21 + r);
  const int div = (float)cnt < p.min_points;

  bool take = first;  // A, g and the affine pair come from this pass
  if (first) {
    last_err = err;
    lam = p.lam0;
    iter = inc_try = trials = 0;
    done = diverged = div;
  } else {
    const bool accept = (err < last_err) && !div;
    const bool conv = err / clamp_min(last_err, 1e-12f) > p.conv_eps;
    const bool small = inc_sq < p.step_min;
    float lam_acc, lam_rej;
    if (p.quick) {
      lam_acc = clamp_min(lam * 0.5f, 0.0f);
      lam_rej = lam == 0.0f ? 0.2f : lam * 4.0f;
    } else {
      float f = 1.0f;
      for (int k = 0; k <= inc_try; ++k) f = f * p.fail_fac;
      lam_acc = lam <= 0.2f ? 0.0f : lam * p.success_fac;
      lam_rej = lam == 0.0f ? 0.2f : lam * f;
    }
    take = accept;
    if (accept) {
#pragma unroll
      for (int i = 0; i < 7; ++i) pose[i] = new_pose[i];
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
    for (int c = 0; c < 6; ++c) A_cur[c] = A_row[c];
    g_cur = g_r;
    if (p.use_affine) {
      aff_a = a_new;
      aff_b = b_new;
    }
  }
  __syncwarp();  // every lane has read the state
  if (lane < 6) {
#pragma unroll
    for (int c = 0; c < 6; ++c) st.A[r * 6 + c] = A_cur[c];
    st.g[r] = g_cur;
  }
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) st.pose[i] = pose[i];
    st.a = aff_a;
    st.b = aff_b;
    st.last_err = last_err;
    st.lam = lam;
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
  float m[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float a = A_cur[c];
    const float damp = lam * (r == c ? a : 0.0f);
    m[c] = (a + damp) + (r == c ? 1e-12f : 0.0f);
  }
  float inc[6];
  solve6_warp(m, g_cur, inc, lane);
  float e[7], np[7];
  se3_exp_warp(inc, e, lane);
  se3_mul(e, pose, np);
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) st.new_pose[i] = np[i];
    st.inc_sq = inc[0] * inc[0] + inc[1] * inc[1] + inc[2] * inc[2]
                + inc[3] * inc[3] + inc[4] * inc[4] + inc[5] * inc[5];
  }
  quat_to_matrix(np, next.rot);
#pragma unroll
  for (int i = 0; i < 3; ++i) next.trans[i] = np[4 + i];
}

// The leader warp, after the loop's last pass: the final pass's pose (the
// accepted one) and affine pair into every block of the cluster (the loop
// flag stays as the blocks read it).
__device__ __forceinline__ void final_bcast(cg::cluster_group& cluster,
                                            int C, const State& st,
                                            Bcast& bc, int lane) {
  float pose[7], rot[9];
#pragma unroll
  for (int i = 0; i < 7; ++i) pose[i] = st.pose[i];
  quat_to_matrix(pose, rot);
  if (lane < C) {
    Bcast* dst = cluster.map_shared_rank(&bc, lane);
    for (int i = 0; i < 9; ++i) dst->rot[i] = rot[i];
    for (int i = 0; i < 3; ++i) dst->trans[i] = pose[4 + i];
    dst->a = st.a;
    dst->b = st.b;
  }
}

// The leader warp after the final pass: track_plain's tail on the totals
// (`final_pass_plain` and the lines after it), lane 0 writing lane `b`'s
// outputs. `div` is the track's diverged flag (every level's OR).
__device__ void final_tail(const Params& p, const State& st,
                           const LsdLmFinal& f, int b, bool div, double lo,
                           double hi, int lane) {
  const double usage_d = __shfl_sync(kFull, lo, kUsage);
  const double good_d = __shfl_sync(kFull, lo, kGood);
  const double bad_d = __shfl_sync(kFull, lo, kBad);
  const double err_d = __shfl_sync(kFull, lo, kErr);
  const double cnt_d = __shfl_sync(kFull, hi, 1);
  if (lane != 0) return;
  const int cnt = (int)cnt_d;
  const float n = cnt > 0 ? (float)cnt : 1.0f;
  const float err = (float)err_d / n;
  const float good = (float)good_d, bad = (float)bad_d;
  const float n_valid = f.n_valid[(long long)b * f.n_valid_stride];
  const float usage = (float)usage_d / clamp_min(n_valid, 1.0f);
  const bool tracking_good =
      (good / (float)(p.w * p.h) > p.min_gpa)
      & (good / clamp_min(good + bad, 1.0f) > p.min_gpgb) & !div;
  float pose[7], inv[7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
    pose[i] = div ? (i == 0 ? 1.0f : 0.0f) : st.pose[i];
  se3_inverse(pose, inv);
  float* pk = f.pack + (long long)b * kPack;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pk[i] = pose[i];
    pk[7 + i] = inv[i];
  }
  pk[14] = div ? 1.0f : 0.0f;
  pk[15] = tracking_good ? 1.0f : 0.0f;
  pk[16] = err;
  pk[17] = usage;
  pk[18] = good;
  pk[19] = bad;
  pk[20] = st.a;
  pk[21] = st.b;
  pk[22] = err / clamp_min(usage, 1e-6f);
  f.tracking_good[b] = tracking_good ? 1 : 0;
  long long* c = f.counts + (long long)b * 3;
  c[0] = cnt;
  c[1] = (long long)good_d;
  c[2] = (long long)bad_d;
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
                long long* __restrict__ stamps,
                const uint8_t* __restrict__ div_in, LsdLmFinal fin,
                Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double cs[kWarps][kCols];
  __shared__ double stk[kStack][kCols];
  __shared__ Bcast bc;
  __shared__ State st;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const bool leader = rank == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long po = (long long)b * p.pts_stride;
  const Lane ln = {idx + po, ival + po, idp + po, ivr + po, valid + po,
                   quad + (long long)b * p.quad_stride};
  long long* const stamp = (stamps != nullptr && b == 0 && leader
                            && threadIdx.x == 0) ? stamps : nullptr;
  uint8_t* const grid = fin.good_mask == nullptr ? nullptr
                        : fin.good_mask + (long long)b * p.w * p.h;
  if (grid != nullptr) {
    // every pixel good until the final pass writes the points' flags;
    // the loop's cluster barriers order these stores before those
    const int hw = p.w * p.h;
    for (int j = rank * kThreads + threadIdx.x; j < hw; j += C * kThreads)
      grid[j] = 1;
    __threadfence();
  }

  // stage the block's share of the points
  const long long share = (long long)(p.leaves / C) * p.chunk;
  const long long f0 = rank * share;
  const int first = (int)(f0 < p.n_points ? f0 : p.n_points);
  const long long l0 = f0 + share;
  const int last = (int)(l0 < p.n_points ? l0 : p.n_points);
  const int n_st = last - first < p.staged ? last - first : p.staged;
  float* tiles = reinterpret_cast<float*>(smem);
  int* s_idx = reinterpret_cast<int*>(tiles + kWarps * 32 * kSums);
  float* s_ival = reinterpret_cast<float*>(s_idx + p.staged);
  float* s_idp = s_ival + p.staged;
  float* s_ivr = s_idp + p.staged;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_ivr + p.staged);
  for (int j = threadIdx.x; j < n_st; j += kThreads) {
    s_idx[j] = (int)ln.idx[first + j];
    s_ival[j] = ln.ival[first + j];
    s_idp[j] = ln.idp[first + j];
    s_ivr[j] = ln.ivr[first + j];
    s_valid[j] = ln.valid[first + j];
  }
  const Staged sm = {s_idx, s_ival, s_idp, s_ivr, s_valid, first, n_st};
  if (threadIdx.x == 0) {
    float given[7], pose[7];
    for (int i = 0; i < 7; ++i) given[i] = pose_in[b * 7 + i];
    if (p.invert) {
      se3_inverse(given, pose);
    } else {
      for (int i = 0; i < 7; ++i) pose[i] = given[i];
    }
    quat_to_matrix(pose, bc.rot);
    for (int i = 0; i < 3; ++i) bc.trans[i] = pose[4 + i];
    bc.a = aff_a_in != nullptr ? aff_a_in[b] : 1.0f;
    bc.b = aff_b_in != nullptr ? aff_b_in[b] : 0.0f;
    bc.cont = 1;
    if (leader) {
      for (int i = 0; i < 7; ++i) st.pose[i] = pose[i];
      st.a = bc.a;
      st.b = bc.b;
    }
  }
  __syncthreads();

  for (int q = 0;; ++q) {
    block_pass<false>(p, ln, sm, bc, rank, C, tiles, cs, stk,
                      stamp ? stamp + 3 * q : nullptr, nullptr);
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
        }
        dst->a = next.a;
        dst->b = next.b;
        dst->cont = next.cont;
      }
    }
    cluster.sync();  // the next pass's pose is in every block
    if (!bc.cont) break;
  }

  const bool div = st.diverged || (div_in != nullptr && div_in[b] != 0);
  if (leader && threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) pose_out[b * 7 + i] = st.pose[i];
    aff_a_out[b] = st.a;
    aff_b_out[b] = st.b;
    err_out[b] = st.last_err;
    div_out[b] = div ? 1 : 0;
    trials_out[b] = st.trials;
    its_out[b] = st.iter;
  }
  if (grid != nullptr) {
    // the final pass at the pose and affine pair just written
    if (leader && warp == 0) final_bcast(cluster, C, st, bc, lane);
    cluster.sync();
    block_pass<true>(p, ln, sm, bc, rank, C, tiles, cs, stk, nullptr, grid);
    cluster.sync();  // every block's root is written
    if (leader && warp == 0) {
      double lo, hi;
      cluster_fold(cluster, C, stk, lane, lo, hi);
      final_tail(p, st, fin, b, div, lo, hi, lane);
    }
    cluster.sync();  // the leader has read every block's root
  }
  if (stamp) stamp[3 * (p.max_trials + 1)] = clock64();
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
  rc = cudaFuncSetAttribute(lm_level_kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(lm_level_kernel,
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
extern "C" int lsd_lm_max_cluster(int smem) {
  cudaError_t rc = prepare(smem);
  if (rc != cudaSuccess) return -(int)rc;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, c, smem, 0, &attr);
    int n = 0;
    rc = cudaOccupancyMaxActiveClusters(&n, (void*)lm_level_kernel, &cfg);
    if (rc == cudaSuccess && n > 0) return c;
    cudaGetLastError();  // a refused size is an answer, not a fault
  }
  return 0;
}

// B lanes, a cluster of `cluster` blocks each, `smem` bytes of dynamic
// shared memory a block; `aff_a_in` / `aff_b_in` null: the pair starts at
// (1, 0); `div_in` null or B flags to OR into `div_out`; `fin` null or the
// final pass's outputs. Returns the launch's cudaError_t.
extern "C" int lsd_lm_level(const int64_t* idx, const float* ival,
                            const float* idp, const float* ivr,
                            const uint8_t* valid, const float* quad,
                            const float* pose_in, const float* aff_a_in,
                            const float* aff_b_in, float* pose_out,
                            float* aff_a_out, float* aff_b_out,
                            float* err_out, uint8_t* div_out, int* trials_out,
                            int* its_out, long long* stamps, int lanes,
                            int cluster, int smem, const LsdLmParams* params,
                            void* stream, const uint8_t* div_in,
                            const LsdLmFinal* fin) {
  cudaError_t rc = prepare(smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(lanes, cluster, smem, (cudaStream_t)stream, &attr);
  LsdLmFinal none = {};
  rc = cudaLaunchKernelEx(&cfg, lm_level_kernel, idx, ival, idp, ivr, valid,
                          quad, pose_in, aff_a_in, aff_b_in, pose_out,
                          aff_a_out, aff_b_out, err_out, div_out, trials_out,
                          its_out, stamps, div_in,
                          fin != nullptr ? *fin : none, *params);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
