// RMSNorm over the last axis: y = x * rsqrt(mean(x^2) + eps) * scale,
// computed in fp32 and cast to x's dtype.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py (`rmsnorm` ->
// `_rmsnorm_kernel`), which holds row blocks of (block_rows, D) in VMEM.
//
// What bounds it here: bytes. Each row is read once and written once
// (2 * D * itemsize bytes), plus the D fp32 scales, so at D = 768 a decode
// launch (8 rows, ~25 KB) is far below what a launch costs: the kernel is
// launch-bound at decode, and only prefill rows (hundreds) move enough
// bytes to see the memory rate.
//
// Design: one warp per row, four rows per 128-thread block. Lanes read the
// row as 16-byte vectors (8 bf16 or 4 fp32 each: 3 vectors a lane at
// D = 768 bf16, 4 at D = 1024) and keep them in registers, with the
// matching scales read as float4, while the fp32 sum of squares is reduced
// with warp shuffles; the output is written from the registers, so the
// row is read from global memory once. Rows longer than the registers
// hold (kCached vectors a lane: D > 2048 bf16, D > 1024 fp32) read the
// rest again. No shared memory and no block barrier. CUDA rather than
// Triton only so that one nvcc build covers all of the port's kernels.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kCached = 8;   // 16-byte vectors a lane keeps in registers

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kScale = kVec / 4;   // float4 scale vectors per row vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const uint4* xr = reinterpret_cast<const uint4*>(x)
                    + static_cast<size_t>(row) * (d / kVec);
  uint4* orow = reinterpret_cast<uint4*>(out)
                + static_cast<size_t>(row) * (d / kVec);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  const int nvec = d / kVec;

  uint4 v[kCached];
  float4 s[kCached][kScale];
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      v[k] = xr[i];
#pragma unroll
      for (int q = 0; q < kScale; ++q) s[k][q] = sc[i * kScale + q];
    }
  }
  float ss = 0.f;
  auto add_squares = [&](const uint4& u) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float f = to_float(e[k]);
      ss = fmaf(f, f, ss);
    }
  };
#pragma unroll
  for (int k = 0; k < kCached; ++k)
    if (lane + 32 * k < nvec) add_squares(v[k]);
  for (int i = lane + 32 * kCached; i < nvec; i += 32) add_squares(xr[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  auto normed = [&](const uint4& u, const float4* sv) {
    const T* e = reinterpret_cast<const T*>(&u);
    const float* f = reinterpret_cast<const float*>(sv);
    uint4 w;
    T* o = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = from_float<T>(to_float(e[k]) * inv * f[k]);
    return w;
  };
#pragma unroll
  for (int k = 0; k < kCached; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) orow[i] = normed(v[k], s[k]);
  }
  for (int i = lane + 32 * kCached; i < nvec; i += 32) {
    float4 sv[kScale];
#pragma unroll
    for (int q = 0; q < kScale; ++q) sv[q] = sc[i * kScale + q];
    orow[i] = normed(xr[i], sv);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- backward
// The gradient of y = x * r * scale, r = rsqrt(mean(x^2) + eps), for dy in
// x's dtype (no TPU counterpart: the JAX package differentiates its XLA
// reference, and its Pallas kernel has no custom_vjp):
//   dx = r * scale * dy - x * r^3 / D * sum_j(dy_j * scale_j * x_j)
//   dscale = sum over rows of dy * x * r                      (fp32)
//
// What bounds it: bytes, like the forward (x and dy read, dx written, a
// (blocks, D) fp32 partial sum written and read again: at 8192 x 768 fp32
// ~76 MB, ~23 us at 3.35 TB/s).
//
// Design: up to kBwdWarps warps a block over a contiguous range of rows,
// one warp a row at a time. Pass 1 reduces sum(x^2) and sum(dy*scale*x) with
// warp shuffles (r is recomputed here, never stored by the forward); pass
// 2 reads the row again (from L1) and writes dx. Each warp adds dy*x*r
// into its own fp32 row of dscale sums in shared memory, each lane only at
// the columns of its own 16-byte vectors, so nothing is shared until the
// block sums its warps in a fixed order into one partial row per block. A
// second launch from this source sums the blocks' partial rows, column by
// column, in block order. No atomics anywhere: the result is the same on
// every run. The warps' rows of sums, warps x D floats, must fit the 227 KB
// a block may take: rows wider than 14,528 (llama3's 16,384) run fewer
// warps a block (3 there, 192 KB), and the widest a block of one warp
// takes is 58,112.
constexpr int kBwdWarps = 4;
constexpr int kMaxBwdSmem = 232448;   // bytes a block may opt in to
constexpr int kMaxBwdD = kMaxBwdSmem / 4;

// warps a block at width d: as many rows of d fp32 sums as fit, up to 4
__host__ __device__ constexpr int bwd_warps(int d) {
  return kMaxBwdSmem / (4 * d) < kBwdWarps ? kMaxBwdSmem / (4 * d)
                                           : kBwdWarps;
}

template <typename T>
__global__ void __launch_bounds__(32 * kBwdWarps)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d,
                       int rows_per_block, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kScale = kVec / 4;
  extern __shared__ float acc[];     // [warps][d]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = d / kVec;
  float* mine = acc + warp * d;
  for (int i = lane; i < nvec; i += 32)
#pragma unroll
    for (int e = 0; e < kVec; ++e) mine[i * kVec + e] = 0.f;
  const float4* sc = reinterpret_cast<const float4*>(scale);
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row0 + rows_per_block);
  for (int row = row0 + warp; row < row_end; row += warps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x)
                      + static_cast<size_t>(row) * nvec;
    const uint4* gr = reinterpret_cast<const uint4*>(dy)
                      + static_cast<size_t>(row) * nvec;
    uint4* dr = reinterpret_cast<uint4*>(dx) + static_cast<size_t>(row) * nvec;
    float ss = 0.f, dot = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      const uint4 xv = xr[i], gv = gr[i];
      float4 sv[kScale];
#pragma unroll
      for (int q = 0; q < kScale; ++q) sv[q] = sc[i * kScale + q];
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      const float* se = reinterpret_cast<const float*>(sv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_float(xe[e]);
        ss = fmaf(xf, xf, ss);
        dot = fmaf(to_float(ge[e]) * se[e], xf, dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = r * r * r * dot / static_cast<float>(d);
    for (int i = lane; i < nvec; i += 32) {
      const uint4 xv = xr[i], gv = gr[i];
      float4 sv[kScale];
#pragma unroll
      for (int q = 0; q < kScale; ++q) sv[q] = sc[i * kScale + q];
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      const float* se = reinterpret_cast<const float*>(sv);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xf = to_float(xe[e]);
        const float gf = to_float(ge[e]);
        o[e] = from_float<T>(r * se[e] * gf - coef * xf);
        mine[i * kVec + e] += gf * xf * r;
      }
      dr[i] = w;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += acc[w * d + c];
    partial[static_cast<size_t>(blockIdx.x) * d + c] = s;
  }
}

// dscale[c] = sum over blocks of partial[block][c], in block order
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ dscale, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * d + c];
  dscale[c] = s;
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
               float* dscale, float* partial, int blocks, int rows, int d,
               float eps, cudaStream_t stream) {
  // once per dtype: allow a block all the shared memory it may take
  static const cudaError_t attr = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int per_block = (rows + blocks - 1) / blocks;
  const int warps = bwd_warps(d);
  const size_t smem = static_cast<size_t>(warps) * d * sizeof(float);
  rmsnorm_bwd_kernel<T><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, per_block, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_reduce_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      partial, dscale, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x, out: (rows, d) contiguous, 16-byte aligned, d a multiple of
// 16 / itemsize; scale: (d,) fp32, 16-byte aligned.
extern "C" int repro_rmsnorm(int dtype, const void* x, const void* scale,
                             void* out, int rows, int d, float eps,
                             void* stream) {
  using namespace repro;
  if (rows <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  if (dtype == kFloat32 && d % 4 == 0)
    return launch<float>(x, sc, out, rows, d, eps, s);
  if (dtype == kBFloat16 && d % 8 == 0)
    return launch<__nv_bfloat16>(x, sc, out, rows, d, eps, s);
  return kBadArgument;
}

// The gradient of repro_rmsnorm. x, dy, dx: (rows, d) contiguous like the
// forward's x; scale: (d,) fp32; dscale: (d,) fp32; partial: (blocks, d)
// fp32 scratch, blocks >= 1 (the wrapper picks how many); d <= 58112.
extern "C" int repro_rmsnorm_backward(int dtype, const void* x,
                                      const void* scale, const void* dy,
                                      void* dx, void* dscale, void* partial,
                                      int blocks, int rows, int d, float eps,
                                      void* stream) {
  using namespace repro;
  if (rows <= 0 || blocks <= 0 || d <= 0 || d > kMaxBwdD)
    return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* ds = static_cast<float*>(dscale);
  auto* pt = static_cast<float*>(partial);
  if (dtype == kFloat32 && d % 4 == 0)
    return launch_bwd<float>(x, sc, dy, dx, ds, pt, blocks, rows, d, eps, s);
  if (dtype == kBFloat16 && d % 8 == 0)
    return launch_bwd<__nv_bfloat16>(x, sc, dy, dx, ds, pt, blocks, rows, d,
                                     eps, s);
  return kBadArgument;
}
