// 5x5 depth-regularization stencil: the five accumulators of
// regularizeDepthMap (DepthMap.cpp:788-846) for every pixel, on Hopper.
//
// Replaces the TPU kernel `regularize_accumulators` (body `_kernel`) of
// lsd_slam_tpu/ops/pallas_stencil.py. For each pixel one sweep of its 5x5
// neighbourhood, in the lattice order dy outer, dx inner
// (lsd_slam_tpu/depth/regularize.py:50-51), gives
//   sum_id    = sum s_id * ivar * use      ivar = 1/(s_var + dist(dx,dy))
//   sum_ivar  = sum ivar * use             use  = valid & compatible
//   val_sum   = sum validity * use         compatible =
//   n_occ     = sum [valid & !compatible & s_id > c_id]
//   n_not_occ = sum use                      diff_fac*(s_id-c_id)^2 <= s_var+c_var
// Taps outside the image read idepth 0, var 1.0, valid 0, validity 0 — the
// padding the TPU wrapper built with four jnp.pad copies is produced here
// while the halo tile is staged, so no padded copy exists in device memory.
//
// Bound: memory. The function reads four (H, W) f32 planes once and writes
// five: 9 * H * W * 4 B = 11.06 MB at 640x480, ~3.3 us at 3.35 TB/s. The
// arithmetic, 25 taps * ~12 flops * H * W ~ 92 MFLOP, is far below the
// card's f32 rate. Design: one thread per output pixel in 32x8 blocks; each
// block stages a (8+4) x (32+4) halo tile of each input plane into shared
// memory (6.9 KB), so every input element is read from device memory about
// 1.6 times (halo overlap, mostly served by L2) and every output written
// once, in coalesced rows.
//
// Numerics follow the JAX lattice bit for bit: the six distance constants
// float(dx^2+dy^2) * reg_dist_var are rounded to f32 on the host exactly
// as JAX rounds the Python double, the file is compiled with -fmad=false
// so no multiply-add is contracted into an FMA, 1/x is IEEE division, and
// the accumulation order is the lattice order.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kR = 2;
constexpr int kSX = kTX + 2 * kR;
constexpr int kSY = kTY + 2 * kR;

struct DistConsts {
  float d[6];  // dx^2+dy^2 = 0, 1, 2, 4, 5, 8
};

__host__ __device__ constexpr int dist_slot(int d2) {
  return d2 == 0 ? 0 : d2 == 1 ? 1 : d2 == 2 ? 2 : d2 == 4 ? 3 : d2 == 5 ? 4 : 5;
}

__global__ void __launch_bounds__(kTX * kTY)
regularize_accumulators_kernel(const float* __restrict__ idp,
                               const float* __restrict__ var,
                               const float* __restrict__ val,
                               const float* __restrict__ vdy,
                               float* __restrict__ o_sid,
                               float* __restrict__ o_sivar,
                               float* __restrict__ o_vsum,
                               float* __restrict__ o_nocc,
                               float* __restrict__ o_nnot,
                               int h, int w, DistConsts dc, float diff_fac) {
  __shared__ float s_id[kSY][kSX];
  __shared__ float s_var[kSY][kSX];
  __shared__ float s_val[kSY][kSX];
  __shared__ float s_vdy[kSY][kSX];

  const int x0 = blockIdx.x * kTX - kR;
  const int y0 = blockIdx.y * kTY - kR;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int i = tid; i < kSY * kSX; i += kTX * kTY) {
    const int ly = i / kSX;
    const int lx = i - ly * kSX;
    const int gy = y0 + ly;
    const int gx = x0 + lx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const size_t o = in ? (size_t)gy * (size_t)w + (size_t)gx : 0;
    s_id[ly][lx] = in ? idp[o] : 0.0f;
    s_var[ly][lx] = in ? var[o] : 1.0f;
    s_val[ly][lx] = in ? val[o] : 0.0f;
    s_vdy[ly][lx] = in ? vdy[o] : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= w || y >= h) return;

  const int cy = threadIdx.y + kR;
  const int cx = threadIdx.x + kR;
  const float c_id = s_id[cy][cx];
  const float c_var = s_var[cy][cx];

  float sid = 0.0f, sivar = 0.0f, vsum = 0.0f, nocc = 0.0f, nnot = 0.0f;
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx) {
      const float si = s_id[cy + dy][cx + dx];
      const float sv = s_var[cy + dy][cx + dx];
      const float sl = s_val[cy + dy][cx + dx];
      const float sd = s_vdy[cy + dy][cx + dx];

      const float diff = si - c_id;
      const bool compatible = diff_fac * diff * diff <= sv + c_var;
      const bool valid = sl > 0.0f;
      const bool use = valid && compatible;

      nocc += (valid && !compatible && si > c_id) ? 1.0f : 0.0f;
      nnot += use ? 1.0f : 0.0f;

      // x * use is select(use, x, 0) in the JAX lattice (XLA rewrites the
      // product), so a masked-out tap with ivar == inf adds 0, not NaN
      const float ivar = 1.0f / (sv + dc.d[dist_slot(dx * dx + dy * dy)]);
      sid += use ? si * ivar : 0.0f;
      sivar += use ? ivar : 0.0f;
      vsum += use ? sd : 0.0f;
    }
  }
  const size_t o = (size_t)y * (size_t)w + (size_t)x;
  o_sid[o] = sid;
  o_sivar[o] = sivar;
  o_vsum[o] = vsum;
  o_nocc[o] = nocc;
  o_nnot[o] = nnot;
}

}  // namespace

// Plain C entry point (loaded with ctypes). `dist` is a host array of the six
// f32 distance constants in dist_slot order. Launches on `stream` and
// returns cudaGetLastError() (0 == cudaSuccess).
extern "C" int lsd_regularize_accumulators(
    const float* idp, const float* var, const float* val, const float* vdy,
    float* o_sid, float* o_sivar, float* o_vsum, float* o_nocc, float* o_nnot,
    int h, int w, const float* dist, float diff_fac, void* stream) {
  DistConsts dc;
  for (int i = 0; i < 6; ++i) dc.d[i] = dist[i];
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY);
  regularize_accumulators_kernel<<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      idp, var, val, vdy, o_sid, o_sivar, o_vsum, o_nocc, o_nnot, h, w, dc,
      diff_fac);
  return static_cast<int>(cudaGetLastError());
}
