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
#include <type_traits>

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
// What bounds it: bytes. x and dy are read and dx written once a row
// (3 D itemsize bytes: at 8192 x 16384 fp32 1.61 GB, 0.48 ms at 3.35
// TB/s); dscale and the blocks' partial rows of it are a few MB at most.
// Reading a row twice, or a shared-memory read-modify-write of a dscale
// sum for every element, costs more than the row's own bytes.
//
// Design: a team of `tpr` threads a row (tpr a multiple of 32, chosen
// from D by the wrapper: a warp up to 8 fp32 or 4 bf16 16-byte vectors a
// lane, more warps for wider rows, 512 threads at 16,384). Thread t of a
// team owns the row's vectors t, t + tpr, ... (at most V, 32 columns), so
// the whole row sits in the team's registers: one read of x and dy. The
// two row sums (x^2 and dy * scale * x) are reduced with warp shuffles
// and, across a team's warps, through a small double-buffered array in
// shared memory (one barrier a row); dx is then written from the
// registers. A thread's columns are the same in every row, so its dscale
// terms gather in its own registers across all the rows its block visits.
// The grid is sized to the card (blocks a wave, each over a contiguous
// range of rows, its teams taking the range's rows in turn). At the end
// each block sums its teams' partial rows in team order through shared
// memory (teams x D floats, once) into one partial row of (blocks, D),
// and a second grid, chained by programmatic dependent launch, sums those
// in block order. No atomics: the result is the same on every run.
constexpr int kMaxBwdThreads = 512;   // a block; the widest team
constexpr int kBwdCols = 32;          // columns a thread owns at most

template <typename T, int V>
__global__ void __launch_bounds__(kMaxBwdThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d, int tpr,
                       int rows_per_block, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kScale = kVec / 4;
  extern __shared__ float smem[];   // row sums, then the teams' partial rows
  // the dscale sum's grid may launch now; it waits for this one to finish
  griddep_launch_dependents();
  const int nvec = d / kVec;
  const int teams = blockDim.x / tpr, team = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpt = tpr >> 5;         // warps a team
  const float4* sc = reinterpret_cast<const float4*>(scale);
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const int iters = (r1 - r0 + teams - 1) / teams;
  float acc[V][kVec];
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[k][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * teams + team;
    const bool live = row < r1;
    const size_t base = static_cast<size_t>(live ? row : r0) * nvec;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + base;
    const uint4* gr = reinterpret_cast<const uint4*>(dy) + base;
    uint4 xv[V], gv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = t + tpr * k;
      if (live && i < nvec) {
        xv[k] = xr[i];
        gv[k] = gr[i];
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = t + tpr * k;
      if (live && i < nvec) {
        float4 sv[kScale];
#pragma unroll
        for (int q = 0; q < kScale; ++q) sv[q] = __ldg(sc + i * kScale + q);
        const T* xe = reinterpret_cast<const T*>(&xv[k]);
        const T* ge = reinterpret_cast<const T*>(&gv[k]);
        const float* se = reinterpret_cast<const float*>(sv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xf = to_float(xe[e]);
          ss = fmaf(xf, xf, ss);
          dot = fmaf(to_float(ge[e]) * se[e], xf, dot);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (wpt > 1) {   // the same for every thread of the block
      float2* red = reinterpret_cast<float2*>(smem)
                    + (it & 1) * (blockDim.x >> 5);
      if (lane == 0) red[warp] = make_float2(ss, dot);
      __syncthreads();
      ss = 0.f;
      dot = 0.f;
      for (int w = 0; w < wpt; ++w) {
        const float2 v = red[team * wpt + w];
        ss += v.x;
        dot += v.y;
      }
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float coef = r * r * r * dot / static_cast<float>(d);
    uint4* dr = reinterpret_cast<uint4*>(dx) + base;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = t + tpr * k;
      if (i < nvec) {
        float4 sv[kScale];
#pragma unroll
        for (int q = 0; q < kScale; ++q) sv[q] = __ldg(sc + i * kScale + q);
        const T* xe = reinterpret_cast<const T*>(&xv[k]);
        const T* ge = reinterpret_cast<const T*>(&gv[k]);
        const float* se = reinterpret_cast<const float*>(sv);
        uint4 w;
        T* o = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xf = to_float(xe[e]);
          const float gf = to_float(ge[e]);
          o[e] = from_float<T>(r * se[e] * gf - coef * xf);
          acc[k][e] = fmaf(gf * xf, r, acc[k][e]);
        }
        dr[i] = w;
      }
    }
  }
  // the block's partial row of dscale: its teams' registers, in team order
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  if (teams == 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = t + tpr * k;
      if (i < nvec)
#pragma unroll
        for (int q = 0; q < kScale; ++q)
          reinterpret_cast<float4*>(out)[i * kScale + q] = make_float4(
              acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
              acc[k][4 * q + 3]);
    }
    return;
  }
  __syncthreads();   // the row sums' array is free again
  float* mine = smem + static_cast<size_t>(team) * d;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = t + tpr * k;
    if (i < nvec)
#pragma unroll
      for (int e = 0; e < kVec; ++e) mine[i * kVec + e] = acc[k][e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < teams; ++m) s += smem[static_cast<size_t>(m) * d + c];
    out[c] = s;
  }
}

// dscale[c] = sum over blocks of partial[block][c], in block order, once
// the rows' grid has finished: a block of 8 warps takes 32 columns, warp w
// sums the w-th eighth of the blocks' rows in order, and warp 0 adds the
// eight sums in warp order
constexpr int kReduceWarps = 8;

__global__ void __launch_bounds__(32 * kReduceWarps)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kReduceWarps][33];
  griddep_wait();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  const int per = (blocks + kReduceWarps - 1) / kReduceWarps;
  const int b1 = min(blocks, (warp + 1) * per);
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp * per; b < b1; ++b)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) t += sums[w][lane];
    dscale[c] = t;
  }
}

template <typename T, int V>
int launch_bwd_v(const void* x, const float* scale, const void* dy, void* dx,
                 float* dscale, float* partial, int blocks, int threads,
                 int tpr, int rows, int d, float eps, cudaStream_t stream) {
  const int teams = threads / tpr;
  const int per_block = (rows + blocks - 1) / blocks;
  // the row sums' double buffer, or the teams' partial rows at the end
  const size_t red = 2 * static_cast<size_t>(threads / 32) * sizeof(float2);
  const size_t rows_smem = teams > 1 ? teams * static_cast<size_t>(d) * 4 : 0;
  const size_t smem = rows_smem > red ? rows_smem : red;
  // once per instantiation: a block of 512 threads' partial rows may take
  // up to 64 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBwdThreads * kBwdCols * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rmsnorm_bwd_kernel<T, V><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, tpr, per_block, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dependent(
      rmsnorm_bwd_reduce_kernel, dim3((d + 31) / 32), dim3(32 * kReduceWarps),
      0, stream,
      static_cast<const float*>(partial), dscale, blocks, d));
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
               float* dscale, float* partial, int blocks, int threads,
               int tpr, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  // vectors a thread owns: the fewest instantiated that hold the row
  const int need = (nvec + tpr - 1) / tpr;
  auto run = [&](auto vv) {
    return launch_bwd_v<T, decltype(vv)::value>(x, scale, dy, dx, dscale,
                                                partial, blocks, threads, tpr,
                                                rows, d, eps, stream);
  };
  if (need <= 1) return run(std::integral_constant<int, 1>{});
  if (need <= 2) return run(std::integral_constant<int, 2>{});
  if (need <= 4) return run(std::integral_constant<int, 4>{});
  if constexpr (kBwdCols / kVec >= 8) {
    if (need <= 8) return run(std::integral_constant<int, 8>{});
  }
  return kBadArgument;
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
// fp32 scratch. The wrapper picks the plan (kernels/rmsnorm.py
// `backward_plan`): `tpr` threads a row (a multiple of 32 that holds the
// row at 32 columns a thread), `threads` a block (a multiple of tpr, at
// most 512) and `blocks`, each over ceil(rows / blocks) rows.
extern "C" int repro_rmsnorm_backward(int dtype, const void* x,
                                      const void* scale, const void* dy,
                                      void* dx, void* dscale, void* partial,
                                      int blocks, int threads, int tpr,
                                      int rows, int d, float eps,
                                      void* stream) {
  using namespace repro;
  if (rows <= 0 || blocks <= 0 || d <= 0 || tpr <= 0 || tpr % 32 ||
      threads % tpr || threads > kMaxBwdThreads ||
      static_cast<long long>(tpr) * kBwdCols < d ||
      static_cast<long long>(blocks - 1) * ((rows + blocks - 1) / blocks)
          >= rows)
    return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  auto* ds = static_cast<float*>(dscale);
  auto* pt = static_cast<float*>(partial);
  if (dtype == kFloat32 && d % 4 == 0)
    return launch_bwd<float>(x, sc, dy, dx, ds, pt, blocks, threads, tpr,
                             rows, d, eps, s);
  if (dtype == kBFloat16 && d % 8 == 0)
    return launch_bwd<__nv_bfloat16>(x, sc, dy, dx, ds, pt, blocks, threads,
                                     tpr, rows, d, eps, s);
  return kBadArgument;
}
