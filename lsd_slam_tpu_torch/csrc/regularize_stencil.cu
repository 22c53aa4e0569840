// 5x5 depth-regularization stencil on Hopper: the five accumulators of
// regularizeDepthMap (DepthMap.cpp:788-846) for every pixel, and the same
// sweep fused with the deletion / keep epilogue of regularize().
//
// Replaces the TPU kernel `regularize_accumulators` (body `_kernel`) of
// lsd_slam_tpu/ops/pallas_stencil.py, and with it the elementwise epilogue
// of lsd_slam_tpu/depth/regularize.py:99-118. For each pixel one sweep of
// its 5x5 neighbourhood, in the lattice order dy outer, dx inner
// (lsd_slam_tpu/depth/regularize.py:50-51), gives
//   sum_id    = sum s_id * ivar * use      ivar = 1/(s_var + dist(dx,dy))
//   sum_ivar  = sum ivar * use             use  = valid & compatible
//   val_sum   = sum validity * use         compatible =
//   n_occ     = sum [valid & !compatible & s_id > c_id]
//   n_not_occ = sum use                      diff_fac*(s_id-c_id)^2 <= s_var+c_var
// Taps outside the image read idepth 0, var 1.0, valid 0, validity 0: that
// padding is produced while the halo tile is staged, so no padded copy
// exists in device memory.
//
// Two entries share the kernel body (template flag kFused):
//   lsd_regularize_accumulators  writes the five accumulator planes;
//   lsd_regularize_fused         keeps them in registers and writes the new
//                                valid, blacklisted, idepth_smoothed and
//                                var_smoothed planes (the whole regularize()).
//
// Bound: memory. The accumulators read four f32 planes and write five,
// 36 B/px = 11.06 MB at 640x480, 3.30 us at 3.35 TB/s; the fused entry reads
// 25 B/px (four f32 planes, the valid bytes, the two smoothed planes, the
// i32 blacklist) and writes 13 B/px, 11.67 MB, 3.48 us. The arithmetic,
// ~25 taps x ~12 flops per pixel, is far below the card's f32 rate, but the
// instruction issue and shared-memory rates are not, so the design cuts
// instructions and shared-memory bytes per output:
//   * Per staged source pixel, not per tap: the six reciprocals
//     1/(s_var + d_k) (one per distance dx^2+dy^2 in {0,1,2,4,5,8}) and the
//     six products s_id * ivar_k, each the same IEEE operation on the same
//     operands as the per-tap version, so the sums are bit-identical. A
//     pixel that is not valid (or lies off the image) gets none: its staged
//     s_id is NaN, which makes `compatible` and `s_id > c_id` false, so the
//     tap adds nothing, exactly as valid = 0 does.
//   * Packed shared memory: per pixel one float4 {s_id or NaN, s_var,
//     validity, raw s_id} and six float2 {ivar_k, s_id*ivar_k} planes.
//     Threads of a warp read consecutive pixels of one row (no conflicts).
//   * Each thread computes a column of kRows outputs and walks the kRows+4
//     source rows once: a source pixel is loaded once per (row, dx) and
//     serves up to five outputs; each output still accumulates in lattice
//     order (source rows top down, dx inner).
//   * Tile 32 x 40 (8 warps x 5 rows): 240 blocks at 640x480, two per SM
//     (99 KB of shared memory each), so the grid is one wave of 264 slots.
//   * Staging: 16-byte loads of 4 pixels when rows are 16-byte aligned
//     (w % 4 == 0 and aligned planes), scalar loads otherwise.
//   * Branch-free taps: counts in int registers, masked adds as predicated
//     adds (a skipped `+ 0.0f` is the same value: the sums start at +0 and
//     never become -0).
//   * Fused epilogue: its inputs are prefetched into L2 at the start, and
//     all of them are loaded before the first store.
// What still limits it (PERF.md): the launch of this grid, the staging with
// its reciprocals, and the taps' shared-memory reads run one after another
// in the single wave.
//
// Numerics follow the JAX lattice bit for bit: the six distance constants
// float(dx^2+dy^2) * reg_dist_var are rounded to f32 on the host exactly
// as JAX rounds the Python double, the file is compiled with -fmad=false
// so no multiply-add is contracted into an FMA, 1/x and the epilogue's
// divisions are IEEE divisions, and the accumulation order is the lattice
// order. The epilogue's clamp is written `s < eps ? eps : s`, which passes
// NaN through as torch.clamp_min and jnp.maximum do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 2;                   // stencil radius
constexpr int kTX = 32;                 // tile width: one warp across
constexpr int kWarps = 8;               // warps per block, stacked in y
constexpr int kRows = 5;                // output rows per thread
constexpr int kTH = kWarps * kRows;     // tile height
constexpr int kSX = kTX + 2 * kR;       // staged columns
constexpr int kSY = kTH + 2 * kR;       // staged rows
constexpr int kGroups = (kTX + 8) / 4;  // 4-pixel groups per staged row
constexpr int kThreads = kTX * kWarps;
constexpr int kSlots = 6;
constexpr size_t kBaseBytes = sizeof(float4) * kSY * kSX;
constexpr size_t kSmemBytes = kBaseBytes + sizeof(float2) * kSlots * kSY * kSX;
constexpr float kDivEps = 1e-10f;

struct DistConsts {
  float d[kSlots];  // dx^2+dy^2 = 0, 1, 2, 4, 5, 8
};

__host__ __device__ constexpr int dist_slot(int d2) {
  return d2 == 0 ? 0 : d2 == 1 ? 1 : d2 == 2 ? 2 : d2 == 4 ? 3 : d2 == 5 ? 4 : 5;
}

struct Args {
  const float* idp;
  const float* var;
  const void* valid;  // f32 1.0/0.0 (accumulators) or bool bytes (fused)
  const float* vdy;
  // accumulators
  float* o_sid;
  float* o_sivar;
  float* o_vsum;
  float* o_nocc;
  float* o_nnot;
  // fused
  const float* id_sm;
  const float* var_sm;
  const int* bl;
  uint8_t* o_valid;
  int* o_bl;
  float* o_id_sm;
  float* o_var_sm;
  float validity_th;
  int remove_occ;
  // both
  int h, w;
  int vec;  // rows are 16-byte aligned: stage with vector loads
  DistConsts dc;
  float diff_fac;
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Src {
  const float* idp;
  const float* var;
  const void* valid;
  const float* vdy;
  int h, w, vec;
};

// Four pixels gy, gx..gx+3 (gx a multiple of 4) of the three f32 planes and
// the valid flags as a bit mask (bit i set: on the image and valid).
template <bool kFused>
__device__ __forceinline__ void load4(const Src p, int gy, int gx,
                                      float4& id, float4& vr, float4& vd,
                                      unsigned& vm) {
  id = make_float4(0.f, 0.f, 0.f, 0.f);
  vr = make_float4(1.f, 1.f, 1.f, 1.f);
  vd = id;
  vm = 0;
  if (gy < 0 || gy >= p.h) return;
  const size_t row = (size_t)gy * (size_t)p.w;
  if (p.vec) {
    if (gx < 0 || gx >= p.w) return;  // w % 4 == 0: all four or none
    const size_t o = row + gx;
    id = *reinterpret_cast<const float4*>(p.idp + o);
    vr = *reinterpret_cast<const float4*>(p.var + o);
    vd = *reinterpret_cast<const float4*>(p.vdy + o);
    if (kFused) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(p.valid) + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) vm |= ((b >> (8 * i)) & 0xffu) ? 1u << i : 0u;
    } else {
      const float4 v = *reinterpret_cast<const float4*>(
          static_cast<const float*>(p.valid) + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) vm |= comp(v, i) > 0.0f ? 1u << i : 0u;
    }
    return;
  }
  float t_id[4] = {0.f, 0.f, 0.f, 0.f}, t_vr[4] = {1.f, 1.f, 1.f, 1.f};
  float t_vd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = gx + i;
    if (x < 0 || x >= p.w) continue;
    const size_t o = row + x;
    t_id[i] = p.idp[o];
    t_vr[i] = p.var[o];
    t_vd[i] = p.vdy[o];
    const bool v = kFused ? static_cast<const uint8_t*>(p.valid)[o] != 0
                          : static_cast<const float*>(p.valid)[o] > 0.0f;
    vm |= v ? 1u << i : 0u;
  }
  id = make_float4(t_id[0], t_id[1], t_id[2], t_id[3]);
  vr = make_float4(t_vr[0], t_vr[1], t_vr[2], t_vr[3]);
  vd = make_float4(t_vd[0], t_vd[1], t_vd[2], t_vd[3]);
}

// Stage the halo tile: per pixel the packed float4 and, for a valid pixel,
// its six {ivar_k, s_id * ivar_k}.
template <bool kFused>
__device__ __forceinline__ void stage(const Src src, float4 (*s_base)[kSX],
                                      float2 (*s_slot)[kSY][kSX],
                                      const DistConsts dc, int x0, int y0,
                                      int tid) {
  const float nan = __int_as_float(0x7fffffff);
  for (int it = tid; it < kSY * kGroups; it += kThreads) {
    const int ly = it / kGroups;
    const int q = it - ly * kGroups;
    float4 id, vr, vd;
    unsigned vm;
    load4<kFused>(src, y0 - kR + ly, x0 - 4 + 4 * q, id, vr, vd, vm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lx = 4 * q - kR + i;  // staged column of pixel i
      if (lx < 0 || lx >= kSX) continue;
      const float pid = comp(id, i), pvr = comp(vr, i);
      const bool v = (vm >> i) & 1u;
      s_base[ly][lx] = make_float4(v ? pid : nan, pvr, comp(vd, i), pid);
      if (v) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const float iv = 1.0f / (pvr + dc.d[k]);
          s_slot[k][ly][lx] = make_float2(iv, pid * iv);
        }
      }
    }
  }
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
    regularize_kernel(const Args a) {
  extern __shared__ float4 smem[];
  float4 (*s_base)[kSX] = reinterpret_cast<float4 (*)[kSX]>(smem);
  float2 (*s_slot)[kSY][kSX] = reinterpret_cast<float2 (*)[kSY][kSX]>(
      reinterpret_cast<char*>(smem) + kBaseBytes);

  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTH;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const Src src = {a.idp, a.var, a.valid, a.vdy, a.h, a.w, a.vec};
  const float diff_fac = a.diff_fac;

  if (kFused) {
    // the epilogue's inputs of this tile into L2 while the halo is staged
    // and the taps run: one thread per (row, plane), each a 32-pixel row
    // segment (128 bytes of f32, 32 of bytes)
    for (int l = tid; l < kTH * 4; l += kThreads) {
      const int y = y0 + l / 4;
      if (y >= a.h || x0 >= a.w) continue;
      const size_t o = (size_t)y * (size_t)a.w + (size_t)x0;
      const int plane = l % 4;
      const void* ptr = plane == 0 ? (const void*)(a.id_sm + o)
                        : plane == 1 ? (const void*)(a.var_sm + o)
                        : plane == 2 ? (const void*)(a.bl + o)
                                     : (const void*)((const uint8_t*)a.valid
                                                     + o);
      asm volatile("prefetch.global.L2 [%0];" ::"l"(ptr));
    }
  }

  // ---- stage the halo tile, with the per-pixel reciprocals ----
  stage<kFused>(src, s_base, s_slot, a.dc, x0, y0, tid);
  __syncthreads();

  // ---- a column of kRows outputs per thread ----
  const int lane = threadIdx.x;
  const int r0 = threadIdx.y * kRows;  // first output row (tile coords)
  float cid[kRows], cvar[kRows];
  float sid[kRows], sivar[kRows], vsum[kRows];
  int nocc[kRows], nnot[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float4 c = s_base[r0 + j + kR][lane + kR];
    cid[j] = c.w;
    cvar[j] = c.y;
    sid[j] = sivar[j] = vsum[j] = 0.0f;
    nocc[j] = nnot[j] = 0;
  }
#pragma unroll
  for (int rr = 0; rr < kRows + 2 * kR; ++rr) {  // source rows, top down
    const int s = r0 + rr;
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx) {
      const int c = lane + kR + dx;
      const float4 b = s_base[s][c];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int dy = rr - kR - j;  // source row = output row j + dy
        if (dy < -kR || dy > kR) continue;
        // unconditional load: the compiler shares it between the outputs
        // with the same |dy| and schedules it ahead of the compare
        const float2 p = s_slot[dist_slot(dx * dx + dy * dy)][s][c];
        const float diff = b.x - cid[j];
        const bool use = diff_fac * diff * diff <= b.y + cvar[j];
        const bool occ = !use && b.x > cid[j];
        nnot[j] += use;
        nocc[j] += occ;
        if (use) {  // predicated adds, no branch
          sid[j] += p.y;
          sivar[j] += p.x;
          vsum[j] += b.z;
        }
      }
    }
  }

  const int x = x0 + lane;
  if (x >= a.w) return;
  if constexpr (!kFused) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + r0 + j;
      if (y >= a.h) return;
      const size_t o = (size_t)y * (size_t)a.w + (size_t)x;
      a.o_sid[o] = sid[j];
      a.o_sivar[o] = sivar[j];
      a.o_vsum[o] = vsum[j];
      a.o_nocc[o] = (float)nocc[j];
      a.o_nnot[o] = (float)nnot[j];
    }
  } else {
    // fused epilogue: every input load before the first store (the planes
    // are not declared disjoint, so a load after a store would wait for it)
    bool v[kRows];
    float id_sm[kRows], var_sm[kRows];
    int bl[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + r0 + j;
      const size_t o = (size_t)min(y, a.h - 1) * (size_t)a.w + (size_t)x;
      v[j] = static_cast<const uint8_t*>(a.valid)[o] != 0;
      id_sm[j] = a.id_sm[o];
      var_sm[j] = a.var_sm[o];
      bl[j] = a.bl[o];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + r0 + j;
      if (y >= a.h) return;
      const size_t o = (size_t)y * (size_t)a.w + (size_t)x;
      const bool interior = y >= kR && y < a.h - kR && x >= kR && x < a.w - kR;
      const bool touched = v[j] && interior;
      const bool del_val = touched && vsum[j] < a.validity_th;
      const bool del_occ =
          a.remove_occ && touched && !del_val && nocc[j] > nnot[j];
      const bool keep = touched && !del_val && !del_occ;
      const float safe = sivar[j] < kDivEps ? kDivEps : sivar[j];
      a.o_id_sm[o] = keep ? sid[j] / safe : id_sm[j];
      a.o_var_sm[o] = keep ? 1.0f / safe : var_sm[j];
      a.o_valid[o] = (v[j] && !del_val && !del_occ) ? 1 : 0;
      a.o_bl[o] = bl[j] - (del_val ? 1 : 0);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Opt in to the kernel's dynamic shared memory, once per device.
template <bool kFused>
int configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(regularize_kernel<kFused>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(regularize_kernel<kFused>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

template <bool kFused>
int launch(Args& a, const float* dist, void* stream) {
  const int rc = configure<kFused>();
  if (rc != 0) return rc;
  for (int i = 0; i < kSlots; ++i) a.dc.d[i] = dist[i];
  a.vec = a.w % 4 == 0 && aligned16(a.idp) && aligned16(a.var) &&
          aligned16(a.vdy) && aligned16(a.valid);
  const dim3 block(kTX, kWarps);
  const dim3 grid((a.w + kTX - 1) / kTX, (a.h + kTH - 1) / kTH);
  regularize_kernel<kFused>
      <<<grid, block, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). `dist` is a host array of the
// six f32 distance constants in dist_slot order. Each launches on `stream`
// and returns cudaGetLastError() (0 == cudaSuccess).

extern "C" int lsd_regularize_accumulators(
    const float* idp, const float* var, const float* val, const float* vdy,
    float* o_sid, float* o_sivar, float* o_vsum, float* o_nocc, float* o_nnot,
    int h, int w, const float* dist, float diff_fac, void* stream) {
  Args a = {};
  a.idp = idp;
  a.var = var;
  a.valid = val;
  a.vdy = vdy;
  a.o_sid = o_sid;
  a.o_sivar = o_sivar;
  a.o_vsum = o_vsum;
  a.o_nocc = o_nocc;
  a.o_nnot = o_nnot;
  a.h = h;
  a.w = w;
  a.diff_fac = diff_fac;
  return launch<false>(a, dist, stream);
}

// `valid` and `o_valid` are bool planes (one byte per pixel), `bl` and
// `o_bl` int32.
extern "C" int lsd_regularize_fused(
    const float* idp, const float* var, const uint8_t* valid, const float* vdy,
    const float* id_sm, const float* var_sm, const int* bl, uint8_t* o_valid,
    int* o_bl, float* o_id_sm, float* o_var_sm, int h, int w,
    const float* dist, float diff_fac, float validity_th, int remove_occ,
    void* stream) {
  Args a = {};
  a.idp = idp;
  a.var = var;
  a.valid = valid;
  a.vdy = vdy;
  a.id_sm = id_sm;
  a.var_sm = var_sm;
  a.bl = bl;
  a.o_valid = o_valid;
  a.o_bl = o_bl;
  a.o_id_sm = o_id_sm;
  a.o_var_sm = o_var_sm;
  a.validity_th = validity_th;
  a.remove_occ = remove_occ;
  a.h = h;
  a.w = w;
  a.diff_fac = diff_fac;
  return launch<true>(a, dist, stream);
}

