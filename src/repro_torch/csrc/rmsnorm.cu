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
