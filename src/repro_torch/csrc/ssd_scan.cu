// Mamba-2 SSD chunked scan: for each (batch, head), walk the sequence in
// chunks of Q = 64 rows carrying the fp32 (P, N) state, and write
//   y_i = sum_{j<=i in chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . state_in + D x_i
//   state_out = exp(total) state_in + sum_j dt_j exp(total - cum_j) x_j B_j^T
// with cum the inclusive cumsum of dt * A inside the chunk and total its
// last entry. Optionally the final state is written too, as the JAX
// reference `ssd_chunked` returns it.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py (`ssd_scan` ->
// `_ssd_kernel`), whose grid (B, H, T/Q) runs the chunk axis in order and
// carries the state in VMEM scratch from one grid step to the next. GPU
// blocks run in no order, so here the chunk axis is a loop inside one
// block per (b, h) and the state lives in shared memory across it.
//
// What bounds it here: at the prefill shape (B=1, T=512, H=32, P=64,
// N=128) the call moves ~5 MB (bf16) and does ~0.94 GFLOP, so its bound
// is the memory rate (~1.6 us). This first version is far from it: the
// products run on fp32 FMAs from shared memory (no tensor cores), and a
// one-request prefill is 32 blocks on 132 SMs, each walking T/64 chunks
// in order.
//
// Design: 256 threads as a 16 x 16 grid, each owning a 4 x 4 tile (rows
// ty + 16a, columns tx + 16b) of every 64-wide product, 4 x 8 of the
// (P, N) state. Per chunk: (1) stage x, B, C as fp32 (rows past T are
// zeros with dt = 0: they neither decay nor add to the state, and their y
// is not stored) and let warp 0 scan dt * A; (2) C.B^T and C.state^T in
// one pass over N, then the decay mask, taking exp only where j <= i
// (above the diagonal cum_i - cum_j > 0 and can overflow); (3) y = scores
// . x + inter term + D x, stored in x's dtype; (4) the state update, each
// thread rewriting only its own tile. Rows are padded by one float so
// the column reads of a warp fall in distinct banks. Shared memory is
// ~130 KB, above the 48 KB default, so the launch raises the limit first.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kQ = 64;          // chunk length
constexpr int kThreads = 256;   // 16 x 16

template <int P, int N>
constexpr int smem_floats() {
  return kQ * (P + 1) + 2 * kQ * (N + 1) + kQ * (kQ + 1) + P * (N + 1) +
         4 * kQ;
}

// Stage kQ rows of W elements into shared memory as fp32 (row stride
// W + 1). `src(i)` points at row i in device memory (16-byte aligned);
// rows at or past n_rows are zeros. All loads are issued before any is
// converted.
template <typename T, int W, class Src>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows, Src src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  constexpr int kIters = kQ * kPerRow / kThreads;
  static_assert(W % kVec == 0 && (kQ * kPerRow) % kThreads == 0,
                "rows must split into 16-byte vectors over the block");
  uint4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kPerRow;
    buf[k] = r < n_rows
                 ? reinterpret_cast<const uint4*>(src(r))[idx % kPerRow]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    float* row = dst + (idx / kPerRow) * (W + 1) + (idx % kPerRow) * kVec;
    const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
    for (int v = 0; v < kVec; ++v) row[v] = to_float(e[v]);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    T* __restrict__ y, float* __restrict__ final_state,
                    int T_, int H, int G) {
  static_assert(P == 64 && kQ == 64, "16 x 16 threads of 4 x 4 tiles");
  static_assert(N % 16 == 0, "state columns split over 16 threads");
  constexpr int kNB = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;                     // (Q, P + 1)
  float* bs = xs + kQ * (P + 1);        // (Q, N + 1)
  float* cs = bs + kQ * (N + 1);        // (Q, N + 1)
  float* ss = cs + kQ * (N + 1);        // (Q, Q + 1) masked scores
  float* st = ss + kQ * (kQ + 1);       // (P, N + 1) carried state
  float* cum = st + P * (N + 1);        // (Q,) inclusive cumsum of dt * A
  float* dts = cum + kQ;                // (Q,) dt
  float* wts = dts + kQ;                // (Q,) dt_j exp(total - cum_j)
  float* ecum = wts + kQ;               // (Q,) exp(cum_i)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = A[h], dskip = D[h];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int i = tid; i < P * (N + 1); i += kThreads) st[i] = 0.f;
  const size_t row0 = static_cast<size_t>(b) * T_;

  for (int t0 = 0; t0 < T_; t0 += kQ) {
    const int rows = min(kQ, T_ - t0);
    stage_rows<T, P>(xs, rows, [&](int i) {
      return x + ((row0 + t0 + i) * H + h) * P;
    });
    stage_rows<T, N>(bs, rows, [&](int i) {
      return Bm + ((row0 + t0 + i) * G + g) * N;
    });
    stage_rows<T, N>(cs, rows, [&](int i) {
      return Cm + ((row0 + t0 + i) * G + g) * N;
    });
    if (tid < 32) {
      // two rows a lane; warp-inclusive scan of the pair sums
      const int i0 = 2 * tid;
      const float d0 = i0 < rows ? dt[(row0 + t0 + i0) * H + h] : 0.f;
      const float d1 = i0 + 1 < rows ? dt[(row0 + t0 + i0 + 1) * H + h] : 0.f;
      const float v1 = d1 * a;
      float incl = d0 * a + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      const float c0 = incl - v1, c1 = incl;
      cum[i0] = c0;
      cum[i0 + 1] = c1;
      dts[i0] = d0;
      dts[i0 + 1] = d1;
      wts[i0] = d0 * expf(total - c0);
      wts[i0 + 1] = d1 * expf(total - c1);
      ecum[i0] = expf(c0);
      ecum[i0 + 1] = expf(c1);
    }
    __syncthreads();

    // (2) scores = C B^T and the inter-chunk term C state^T, one pass
    float sc[4][4], ya[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[r][q] = ya[r][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float cv[4], bv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * (N + 1) + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bv[q] = bs[(tx + 16 * q) * (N + 1) + k];
        sv[q] = st[(tx + 16 * q) * (N + 1) + k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sc[r][q] = fmaf(cv[r], bv[q], sc[r][q]);
          ya[r][q] = fmaf(cv[r], sv[q], ya[r][q]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tx + 16 * q;
        ss[i * (kQ + 1) + j] =
            j <= i ? sc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        ya[r][q] *= ecum[i];
      }
    }
    __syncthreads();

    // (3) y = scores . x + inter term + D x
#pragma unroll 4
    for (int k = 0; k < kQ; ++k) {
      float sv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = ss[(ty + 16 * r) * (kQ + 1) + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[k * (P + 1) + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) ya[r][q] = fmaf(sv[r], xv[q], ya[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i < rows) {
        T* yr = y + ((row0 + t0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          yr[p] = from_float<T>(ya[r][q] + dskip * xs[i * (P + 1) + p]);
        }
      }
    }

    // (4) state = exp(total) state + sum_j w_j x_j B_j^T, own tile only
    const float decay = expf(cum[kQ - 1]);
    float acc[4][kNB];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kNB; ++q)
        acc[r][q] = st[(ty + 16 * r) * (N + 1) + tx + 16 * q] * decay;
#pragma unroll 4
    for (int k = 0; k < kQ; ++k) {
      const float w = wts[k];
      float xv[4], bv[kNB];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[k * (P + 1) + ty + 16 * r] * w;
#pragma unroll
      for (int q = 0; q < kNB; ++q) bv[q] = bs[k * (N + 1) + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < kNB; ++q)
          acc[r][q] = fmaf(xv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kNB; ++q)
        st[(ty + 16 * r) * (N + 1) + tx + 16 * q] = acc[r][q];
    __syncthreads();
  }

  if (final_state != nullptr) {
    float* out = final_state + static_cast<size_t>(blockIdx.x) * P * N;
    for (int e = tid; e < P * N; e += kThreads)
      out[e] = st[(e / N) * (N + 1) + e % N];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, void* y, float* final_state,
           int B, int T_, int H, int G, cudaStream_t stream) {
  constexpr int kBytes = smem_floats<P, N>() * static_cast<int>(sizeof(float));
  // once per instantiation (and process): allow more than 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ssd_scan_kernel<T, P, N><<<B * H, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), final_state, T_, H,
      G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, void* y, float* final_state,
             int B, int T_, int H, int G, int P, int N, cudaStream_t s) {
  // mamba2-370m's (head_dim, state_dim); add an instantiation when a
  // ported config needs one
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, Bm, Cm, D, y, final_state, B, T_, H,
                              G, s);
  return kBadArgument;
}

}  // namespace
}  // namespace repro

// x, y: (B, T, H, P); dt: (B, T, H) fp32; A, D: (H,) fp32; Bm, Cm:
// (B, T, G, N) of x's dtype; final_state: (B, H, P, N) fp32 or null. All
// contiguous and 16-byte aligned; H % G == 0; (P, N) == (64, 128).
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt,
                              const void* A, const void* Bm, const void* Cm,
                              const void* D, void* y, void* final_state,
                              int B, int T_, int H, int G, int P, int N,
                              void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return 0;
  if (T_ < 0 || G <= 0 || H % G != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Df = static_cast<const float*>(D);
  auto* fs = static_cast<float*>(final_state);
  if (dtype == kFloat32)
    return dispatch<float>(x, dtf, Af, Bm, Cm, Df, y, fs, B, T_, H, G, P, N,
                           s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, y, fs, B, T_, H, G,
                                   P, N, s);
  return kBadArgument;
}
