// Hole filling on Hopper: fillDepthHoles (DepthMap.cpp:656-754) for every
// pixel, in two launches.
//
// Replaces no Pallas kernel: the JAX package computes this step as XLA-fused
// jnp code, `fill_holes` at lsd_slam_tpu/depth/regularize.py:121, and the
// port first ran it as 413 PyTorch kernel launches a call (the plain
// version, `fill_holes_plain` in ops/regularize_stencil.py). Per pixel:
//   vc      = valid ? validity : 0
//   I       = the integral image of vc (rows scanned first, then columns)
//   val5    = ((I(y+2,x+2) - I(y-3,x+2)) - I(y+2,x-3)) + I(y-3,x-3)
//             (I = 0 off the image, as the plain version's zero padding)
//   create  = !valid & region & max_grad >= min_grad & ((blacklisted >=
//             min_blacklist & val5 > create_th) | val5 > unblacklist_th)
//             & sum_ivar > 0,   region = 3 <= y < h-2, 3 <= x < w-2
//   sum_obs = sum over the 5x5 taps (dy outer, dx inner) of id/var, and
//   sum_ivar  of 1/var, at valid taps on the image (0 elsewhere)
// and the six output planes take the created hypothesis where `create`
// holds and the input elsewhere.
//
// Same bits as the plain version. Validity is fractional, so the integral
// image's rounding can move val5 across the integer thresholds; each scan
// therefore repeats the plain version's `_cumsum_last` order (XLA's cumsum
// on the CPU): 16-wide blocks summed sequentially from +0 with zero
// padding, the block totals scanned the same way recursively, then added as
// exclusive offsets (+0 to the first block); rows first, then columns. The
// taps add in lattice order; id/var and 1/var are IEEE divisions, the
// same operation on the same operands as the plain version's per-tap ones,
// so each source pixel computes them once. Built with -fmad=false (nothing
// here would contract anyway).
//
// Bound: memory. Any implementation reads valid (1 B) and validity,
// idepth, var, blacklisted, max_grad, idepth_smoothed, var_smoothed (4 B
// each), 29 B a pixel, and writes 21 B (valid 1, five f32 planes): 15.36 MB
// at 640x480, 4.59 us at 3.35 TB/s. About 195 f32 operations a pixel (the
// taps' divisions, selects and adds, the scans, the window sum, the
// epilogue) take 0.89 us at 67 TFLOP/s. The design:
//   * Launch 1, a block per band of 16 rows (the scan's block height), a
//     warp a row: vc of the band into shared memory (four pixels a load
//     where w % 4 == 0, kBatch loads a thread in flight; rows padded one
//     slot in 16, so a warp's lanes, one 16-block each, hit distinct
//     banks), each row scanned by its warp, then each column's sums within
//     the band from the top; writes those sums (`inner`, h x w) and each
//     band's column totals (`totals`, h/16 x w). The row scan never leaves
//     shared memory.
//   * Launch 2, a block per 32x32 tile, launched as launch 1's
//     programmatic dependent (Hopper): its blocks start while launch 1
//     runs and load what the caller gave (each thread's four pixels and
//     the 36x36 window of {id/var, 1/var}) before they wait for launch 1;
//     then the band totals of the tile's 37 integral columns and the 37x37
//     window of `inner`. One thread a column scans its band totals (30 at
//     480 rows), the window adds its bands' offsets, and each pixel takes
//     val5, the 25 taps and the epilogue; every pixel of the six planes is
//     written.
// What the two launches cost over the bound: launch 1's h/16 blocks (30 at
// 480 rows, a quarter of the card's SMs) and its scans' dependent chains
// in shared memory, the wait for its results to land, and the integral
// image's own traffic (4 B a pixel written, ~5.4 read, from L2 at these
// sizes).
//
// tests/test_torch_fill_holes_host.py builds this file with g++ and runs it
// one emulated thread a block: it replaces the `<cuda_runtime.h>` include,
// the three thread-count lines (kLanes, kRowWarps, kFuseThreads), the two
// griddepcontrol lines and the code from the "launches" line to the
// namespace's end with a host `launch`; keep them, or update the test.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 16;        // the scan's block (XLA's cumsum on the CPU)
constexpr int kMaxDepth = 3;    // scan levels above the first: n <= 16^4
constexpr int kLanes = 32;
constexpr int kRowWarps = 16;   // launch 1: a warp a row of the band
constexpr int kRowThreads = kRowWarps * kLanes;
constexpr int kBatch = 8;       // launch 1: loads in flight a thread
constexpr int kTW = 32;         // launch 2's tile
constexpr int kTH = 32;
constexpr int kFuseThreads = 256;
constexpr int kIW = kTW + 5;    // integral window: x-3 .. x+2
constexpr int kIH = kTH + 5;
constexpr int kQW = kTW + 4;    // tap window: x-2 .. x+2
constexpr int kQH = kTH + 4;
// launch 2's work items a thread: pixels, integral and tap window entries
constexpr int kPix = (kTW * kTH + kFuseThreads - 1) / kFuseThreads;
constexpr int kIWin = (kIH * kIW + kFuseThreads - 1) / kFuseThreads;
constexpr int kQWin = (kQH * kQW + kFuseThreads - 1) / kFuseThreads;
constexpr float kDivEps = 1e-10f;

struct Args {
  const uint8_t* valid;
  const float* idepth;
  const float* var;
  const float* validity;
  const int* bl;
  const float* max_grad;
  const float* id_sm;
  const float* var_sm;
  float* inner;   // h x w: column sums within each band of 16 rows
  float* totals;  // nbands x w: each band's column totals
  uint8_t* o_valid;
  float* o_idepth;
  float* o_var;
  float* o_validity;
  float* o_id_sm;
  float* o_var_sm;
  int h, w, nbands;
  int vec;           // w % 4 == 0 and valid, validity 16-byte aligned
  int row_scratch;   // scan levels of a row
  int band_scratch;  // scan levels of a column's band totals
  float min_grad;
  int min_bl;
  float create_th, unbl_th, var_init;
};

// Entries of the levels above the first of a scan of n values.
__host__ __device__ inline int scan_scratch(int n) {
  int s = 0;
  while (n > kBlk) {
    n = (n + kBlk - 1) / kBlk;
    s += n;
  }
  return s;
}

// Row length in shared memory with one pad slot after every 16 values.
__host__ __device__ inline int padded_len(int n) {
  return n + (n + kBlk - 1) / kBlk;
}

struct Padded {
  float* p;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[i + (i >> 4)];
  }
};

struct Strided {
  float* p;
  int s;
  __device__ __forceinline__ float& operator[](int i) const {
    return p[i * s];
  }
  __device__ __forceinline__ Strided after(int n) const {
    return Strided{p + n * s, s};
  }
};

template <bool kWarp>
__device__ __forceinline__ void scan_sync() {
  if constexpr (kWarp) __syncwarp();
}

// Inclusive scan of a[0..n) in place in the order of the plain version's
// `_cumsum_last`, by the `lanes` lanes of a warp (kWarp) or by one thread
// (lane 0 of 1). `scratch` holds the levels above the first.
template <int kDepth, bool kWarp, class A>
__device__ void xla_scan(A a, int n, Strided scratch, int lane, int lanes) {
  if (n <= kBlk) {
    if (lane == 0) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) {
        acc = acc + a[i];
        a[i] = acc;
      }
    }
    scan_sync<kWarp>();
    return;
  }
  const int nb = (n + kBlk - 1) / kBlk;
  for (int b = lane; b < nb; b += lanes) {
    float acc = 0.0f;
    for (int j = 0; j < kBlk; ++j) {
      const int i = b * kBlk + j;
      acc = acc + (i < n ? a[i] : 0.0f);  // the zero padding adds too
      if (i < n) a[i] = acc;
    }
    scratch[b] = acc;
  }
  scan_sync<kWarp>();
  if constexpr (kDepth > 0) {
    xla_scan<kDepth - 1, kWarp>(scratch, nb, scratch.after(nb), lane, lanes);
  } else {
    __trap();  // the entry refuses n > 16^(kMaxDepth + 1)
  }
  for (int i = lane; i < n; i += lanes) {
    const int b = i / kBlk;
    a[i] = a[i] + (b == 0 ? 0.0f : scratch[b - 1]);
  }
  scan_sync<kWarp>();
}

// Programmatic dependent launch (Hopper, PTX griddepcontrol): launch 1
// lets launch 2 start at once, and launch 2 reads only the caller's planes
// until it waits for launch 1's results (its writes are then visible).
__device__ __forceinline__ void start_launch_2() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_launch_1() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch 1, band `band`: vc, the row scans, the column sums within the band.
__device__ void rows_block(const Args& a, float* smem, int band, int tid) {
  const int h = a.h, w = a.w, wp = padded_len(w);
  float* rows = smem;                // [kBlk][wp]
  float* scr = smem + kBlk * wp;     // [kBlk][row_scratch]
  const int y0 = band * kBlk;
  // the band's rows are contiguous; rows past h stay 0, the column scan's
  // zero padding. kBatch loads a thread in flight at once.
  const int n = kBlk * w, n_in = (h - y0 < kBlk ? h - y0 : kBlk) * w;
  const size_t o0 = (size_t)y0 * (size_t)w;
  start_launch_2();
  if (a.vec) {  // w % 4 == 0 and aligned planes: four pixels a load
    for (int base = tid; base < n / 4; base += kBatch * kRowThreads) {
      uchar4 vb[kBatch];
      float4 vv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kRowThreads;
        vb[k] = make_uchar4(0, 0, 0, 0);
        vv[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * i < n_in) {
          vb[k] = reinterpret_cast<const uchar4*>(a.valid + o0)[i];
          vv[k] = reinterpret_cast<const float4*>(a.validity + o0)[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kRowThreads;
        if (4 * i >= n) continue;
        const int r = 4 * i / w, x = 4 * i - r * w;
        const Padded row{rows + r * wp};
        row[x] = vb[k].x ? vv[k].x : 0.0f;
        row[x + 1] = vb[k].y ? vv[k].y : 0.0f;
        row[x + 2] = vb[k].z ? vv[k].z : 0.0f;
        row[x + 3] = vb[k].w ? vv[k].w : 0.0f;
      }
    }
  } else {
    for (int base = tid; base < n; base += kBatch * kRowThreads) {
      uint8_t vb[kBatch];
      float vv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kRowThreads;
        vb[k] = 0;
        vv[k] = 0.0f;
        if (i < n_in) {
          vb[k] = a.valid[o0 + i];
          vv[k] = a.validity[o0 + i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = base + k * kRowThreads;
        if (i < n) {
          const int r = i / w;
          Padded{rows + r * wp}[i - r * w] = vb[k] ? vv[k] : 0.0f;
        }
      }
    }
  }
  __syncthreads();
  const int warp = tid / kLanes, lane = tid % kLanes;
  for (int r = warp; r < kBlk; r += kRowWarps) {
    if (y0 + r >= h) continue;
    xla_scan<kMaxDepth, true>(Padded{rows + r * wp}, w,
                              Strided{scr + r * a.row_scratch, 1}, lane,
                              kLanes);
  }
  __syncthreads();
  for (int x = tid; x < w; x += kRowThreads) {
    float acc = 0.0f;
    for (int r = 0; r < kBlk; ++r) {
      acc = acc + Padded{rows + r * wp}[x];
      if (y0 + r < h) a.inner[o0 + (size_t)(r * w + x)] = acc;
    }
    a.totals[(size_t)band * (size_t)w + (size_t)x] = acc;
  }
}

// One output pixel's inputs.
struct Pixel {
  float idepth, var, validity, grad, id_sm, var_sm;
  int bl;
  bool valid, in;
};

// Launch 2, the tile at (bx, by): the integral window, the taps, the planes.
// Every global load is issued before the first barrier: each thread's
// pixels and the tap window while launch 1 may still run, then the band
// totals and the integral window's inner sums.
__device__ void fuse_block(const Args& a, float* smem, int bx, int by,
                           int tid) {
  const int h = a.h, w = a.w, nb = a.nbands;
  const bool blocked = h > kBlk;  // the column scan ran in 16-row blocks
  float2* q = reinterpret_cast<float2*>(smem);  // [kQH][kQW] {id/var, 1/var}
  float* integ = smem + 2 * kQH * kQW;          // [kIH][kIW]
  float* tot = integ + kIH * kIW;               // [nb][kIW]
  float* lvl = tot + nb * kIW;                  // [band_scratch][kIW]
  const int x0 = bx * kTW, y0 = by * kTH;

  Pixel px[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = tid + k * kFuseThreads;
    const int y = y0 + i / kTW, x = x0 + i % kTW;
    Pixel& p = px[k];
    p.in = i < kTW * kTH && y < h && x < w;
    if (p.in) {
      const size_t o = (size_t)y * (size_t)w + (size_t)x;
      p.valid = a.valid[o] != 0;
      p.idepth = a.idepth[o];
      p.var = a.var[o];
      p.validity = a.validity[o];
      p.grad = a.max_grad[o];
      p.id_sm = a.id_sm[o];
      p.var_sm = a.var_sm[o];
      p.bl = a.bl[o];
    }
  }
#pragma unroll
  for (int k = 0; k < kQWin; ++k) {
    const int i = tid + k * kFuseThreads;
    const int ly = i / kQW, lx = i - ly * kQW;
    const int y = y0 - 2 + ly, x = x0 - 2 + lx;
    if (i >= kQH * kQW) continue;
    float2 v = make_float2(0.0f, 0.0f);
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t o = (size_t)y * (size_t)w + (size_t)x;
      const bool valid = a.valid[o] != 0;
      const float s_id = a.idepth[o], s_var = a.var[o];
      if (valid) v = make_float2(s_id / s_var, 1.0f / s_var);
    }
    q[i] = v;
  }
  wait_for_launch_1();
  if (blocked) {
    for (int i = tid; i < nb * kIW; i += kFuseThreads) {
      const int b = i / kIW, c = i - b * kIW, xx = x0 - 3 + c;
      tot[i] = (xx >= 0 && xx < w) ? a.totals[(size_t)b * (size_t)w + xx]
                                   : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kIWin; ++k) {
    const int i = tid + k * kFuseThreads;
    const int r = i / kIW, c = i - r * kIW;
    const int yy = y0 - 3 + r, xx = x0 - 3 + c;
    if (i < kIH * kIW)
      integ[i] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                     ? a.inner[(size_t)yy * (size_t)w + (size_t)xx]
                     : 0.0f;
  }
  __syncthreads();
  if (blocked) {
    for (int c = tid; c < kIW; c += kFuseThreads)
      xla_scan<kMaxDepth, false>(Strided{tot + c, kIW}, nb,
                                 Strided{lvl + c, kIW}, 0, 1);
    __syncthreads();
    // the window's rows that lie on the image take their band's offset
    for (int i = tid; i < kIH * kIW; i += kFuseThreads) {
      const int r = i / kIW, c = i - r * kIW;
      const int yy = y0 - 3 + r, xx = x0 - 3 + c;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const int b = yy / kBlk;
        integ[i] = integ[i] + (b == 0 ? 0.0f : tot[(b - 1) * kIW + c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const Pixel& p = px[k];
    if (!p.in) continue;
    const int i = tid + k * kFuseThreads;
    const int ly = i / kTW, lx = i % kTW;
    const int y = y0 + ly, x = x0 + lx;

    const float* top = integ + ly * kIW + lx;         // row y-3, column x-3
    const float* bot = integ + (ly + 5) * kIW + lx;   // row y+2
    const float val5 = ((bot[5] - top[5]) - bot[0]) + top[0];
    float sum_obs = 0.0f, sum_ivar = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        const float2 t = q[(ly + dy) * kQW + lx + dx];
        sum_obs = sum_obs + t.x;
        sum_ivar = sum_ivar + t.y;
      }
    }

    const bool region = y >= 3 && y < h - 2 && x >= 3 && x < w - 2;
    bool create = !p.valid && region && p.grad >= a.min_grad &&
                  ((p.bl >= a.min_bl && val5 > a.create_th) ||
                   val5 > a.unbl_th);
    float new_id = sum_obs / (sum_ivar < kDivEps ? kDivEps : sum_ivar);
    new_id = fabsf(new_id) < kDivEps ? kDivEps : new_id;
    create = create && sum_ivar > 0.0f;

    const size_t o = (size_t)y * (size_t)w + (size_t)x;
    a.o_valid[o] = (p.valid || create) ? 1 : 0;
    a.o_idepth[o] = create ? new_id : p.idepth;
    a.o_var[o] = create ? a.var_init : p.var;
    a.o_validity[o] = create ? 0.0f : p.validity;
    a.o_id_sm[o] = create ? -1.0f : p.id_sm;
    a.o_var_sm[o] = create ? -1.0f : p.var_sm;
  }
}

size_t rows_smem(const Args& a) {
  return sizeof(float) * (size_t)kBlk * (size_t)(padded_len(a.w) +
                                                 a.row_scratch);
}

size_t fuse_smem(const Args& a) {
  return sizeof(float) * (2 * kQH * kQW + kIH * kIW +
                          (size_t)(a.nbands + a.band_scratch) * kIW);
}

constexpr size_t kSmemMax = 227u << 10;  // a block's shared memory on Hopper

// ---- launches ----

__global__ void __launch_bounds__(kRowThreads)
    fill_holes_rows_kernel(const Args a) {
  extern __shared__ float smem_rows[];
  rows_block(a, smem_rows, blockIdx.x, threadIdx.x);
}

__global__ void __launch_bounds__(kFuseThreads)
    fill_holes_fuse_kernel(const Args a) {
  extern __shared__ float smem_fuse[];
  fuse_block(a, smem_fuse, blockIdx.x, blockIdx.y, threadIdx.x);
}

// Raise a kernel's dynamic shared memory limit to `bytes` where the default
// 48 KB is short, once per device and size.
template <class K>
int allow_smem(K kernel, size_t bytes, size_t* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes <= (48u << 10) || (dev < 64 && done[dev] >= bytes)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = bytes;
  return 0;
}

int launch(const Args& a, void* stream) {
  static size_t rows_done[64] = {}, fuse_done[64] = {};
  int rc = allow_smem(fill_holes_rows_kernel, rows_smem(a), rows_done);
  if (rc == 0) rc = allow_smem(fill_holes_fuse_kernel, fuse_smem(a), fuse_done);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_holes_rows_kernel<<<a.nbands, kRowThreads, rows_smem(a), s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  cudaLaunchAttribute pdl = {};
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.w + kTW - 1) / kTW, (a.h + kTH - 1) / kTH);
  cfg.blockDim = dim3(kFuseThreads);
  cfg.dynamicSmemBytes = fuse_smem(a);
  cfg.stream = s;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fill_holes_fuse_kernel, a));
}

}  // namespace

// Plain C entry point (loaded with ctypes). `valid` and `o_valid` are bool
// planes (one byte a pixel), `bl` int32, the rest f32, all h x w;
// `scratch` holds h * w + ceil(h / 16) * w floats. Launches both kernels
// on `stream` and returns cudaGetLastError() (0 == cudaSuccess), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int lsd_fill_holes(
    const uint8_t* valid, const float* idepth, const float* var,
    const float* validity, const int* bl, const float* max_grad,
    const float* id_sm, const float* var_sm, float* scratch,
    uint8_t* o_valid, float* o_idepth, float* o_var, float* o_validity,
    float* o_id_sm, float* o_var_sm, int h, int w, float min_grad,
    int min_bl, float create_th, float unbl_th, float var_init,
    void* stream) {
  constexpr int kMaxLen = kBlk * kBlk * kBlk * kBlk;
  if (h < 1 || w < 1 || w > kMaxLen) return cudaErrorInvalidValue;
  Args a = {};
  a.valid = valid;
  a.idepth = idepth;
  a.var = var;
  a.validity = validity;
  a.bl = bl;
  a.max_grad = max_grad;
  a.id_sm = id_sm;
  a.var_sm = var_sm;
  a.inner = scratch;
  a.totals = scratch + (size_t)h * (size_t)w;
  a.o_valid = o_valid;
  a.o_idepth = o_idepth;
  a.o_var = o_var;
  a.o_validity = o_validity;
  a.o_id_sm = o_id_sm;
  a.o_var_sm = o_var_sm;
  a.h = h;
  a.w = w;
  a.nbands = (h + kBlk - 1) / kBlk;
  a.row_scratch = scan_scratch(w);
  a.band_scratch = scan_scratch(a.nbands);
  a.vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(valid) & 15u) == 0 &&
          (reinterpret_cast<uintptr_t>(validity) & 15u) == 0;
  a.min_grad = min_grad;
  a.min_bl = min_bl;
  a.create_th = create_th;
  a.unbl_th = unbl_th;
  a.var_init = var_init;
  if (rows_smem(a) > kSmemMax || fuse_smem(a) > kSmemMax)
    return cudaErrorInvalidValue;
  return launch(a, stream);
}
