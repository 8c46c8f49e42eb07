// Mamba-2 SSD chunked scan: with the sequence cut into chunks of Q = 64
// rows, cum the inclusive cumsum of dt * A inside a chunk and total its
// last entry,
//   y_i = sum_{j<=i in chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . entering_c + D x_i
//   S_c = sum_j dt_j exp(total - cum_j) x_j B_j^T          (chunk state)
//   entering_0 = 0, entering_{c+1} = exp(total_c) entering_c + S_c
// and the final state is the state entering the chunk after the last, as
// the JAX reference `ssd_chunked` returns it.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py (`ssd_scan` ->
// `_ssd_kernel`), whose grid (B, H, T/Q) runs the chunk axis in order and
// carries the state in VMEM scratch from one grid step to the next. GPU
// blocks run in no order, so the chunk axis is taken apart into three
// grids, chained on the stream by programmatic dependent launch:
//   1. chunk states: one block per (P-slice of 16, head, batch x chunk)
//      writes S_c's slice to an fp32 scratch (B, nC, H, P, N), and
//      exp(total_c) to a second one (B, nC, H);
//   2. state passing: per (batch, head), each thread walks the chunks in
//      order for 4 of the P x N state elements, overwriting S_c with
//      entering_c in place (one buffer, mostly L2-resident), and writes
//      the final state on request;
//   3. chunk scan: one block per (P-slice, head, batch x chunk) computes
//      the intra-chunk term, then waits for grid 2 and adds the term of
//      the entering state. The intra-chunk part (C B^T, recomputed per
//      P-slice, and its product with x) runs before the wait, while grid
//      2 still runs.
// No atomics: every output element has one writer, so results do not
// depend on the run. Rows past T are staged as zeros with dt = 0: they
// neither decay nor add to a state, and their y is not stored.
//
// What bounds it here: at the prefill shape (B=1, T=512, H=32, P=64,
// N=128) the call moves ~5 MB (bf16) and does ~0.94 GFLOP, so its bound
// is the memory rate (~1.6 us). What the kernel waits on instead: three
// dependent grids that run nearly in series, each block a short chain of
// loads from L2, products and stores; the scratch round trip (~8.4 MB
// written, read, rewritten, read again; in L2 at this size); and every
// (head, P-slice) block reloading its chunk's B and C (one group serves
// all heads). The chunk axis gives the card its parallelism: 4 P-slices
// x 8 chunks x 32 heads are 1,024 blocks a grid at that shape.
//
// bf16 (tensor cores): the three products run as mma.sync.m16n8k16 bf16
// -> fp32 with ldmatrix operands from swizzled shared memory. x, B and C
// enter as they are in memory. Of the operands computed in fp32, the
// masked scores and entering_c are rounded to bf16 once (y stays within
// its bf16 tolerance), but diag(w) x enters as a hi + lo pair of bf16 (two
// products into one accumulator): rounded once it would put the final
// state ~4e-4 off, past its 1e-4 tolerance (kernels/ssd_scan.py
// `_ssd_chunk_parallel_plain` and its CPU test measure both).
//
// fp32 (FMAs; TF32 would break the fp32 tolerance): the same three grids,
// the products as per-thread register tiles over fp32 shared memory.
//
// The gradient (repro_ssd_scan_backward, training) is the last part of the
// file: three grids of its own.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kQ = 64;          // chunk length
// P columns of a block (its P-slice). In bf16, slices of 32 and 64 were
// within 8% at T = 512 and slower at T = 64 (H100 80GB HBM3, 700 W), so
// both dtypes take 16.
constexpr int kPS = 16;
constexpr int kThreads = 128;   // chunk-state and chunk-scan blocks
constexpr int kPassThreads = 256;
// bf16 x tile row: kPS + 8 elements, so the 8 rows an ldmatrix reads fall
// in distinct banks
constexpr int kXLd = kPS + 8;

// One warp: the inclusive cumsum of dt * a over a chunk's kQ rows, two
// rows a lane (rows at or past n_rows have dt = 0). Stores cum_i and dt_i
// and, with `wts`, w_i = dt_i exp(total - cum_i); returns total.
__device__ __forceinline__ float chunk_cumsum(const float* dt, int stride,
                                              int n_rows, float a, int lane,
                                              float* cum, float* dts,
                                              float* wts) {
  const int i0 = 2 * lane;
  const float d0 = i0 < n_rows ? dt[static_cast<size_t>(i0) * stride] : 0.f;
  const float d1 =
      i0 + 1 < n_rows ? dt[static_cast<size_t>(i0 + 1) * stride] : 0.f;
  const float v1 = d1 * a;
  float incl = d0 * a + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  const float c0 = incl - v1, c1 = incl;
  cum[i0] = c0;
  cum[i0 + 1] = c1;
  dts[i0] = d0;
  dts[i0 + 1] = d1;
  if (wts != nullptr) {
    wts[i0] = d0 * expf(total - c0);
    wts[i0 + 1] = d1 * expf(total - c1);
  }
  return total;
}

// Where a block's chunk lies: blockIdx = (P-slice, head, b * nC + c).
struct ChunkPos {
  int ps, h, b, c, bc, rows, g;
  size_t row0;   // sequence row (b * T + c * kQ) of the chunk's first row

  __device__ __forceinline__ ChunkPos(int T_, int H, int G, int nC) {
    ps = blockIdx.x;
    h = blockIdx.y;
    bc = blockIdx.z;
    b = bc / nC;
    c = bc % nC;
    rows = min(kQ, T_ - c * kQ);
    g = h / (H / G);
    row0 = static_cast<size_t>(b) * T_ + static_cast<size_t>(c) * kQ;
  }
};

// Stage ROWS rows of W fp32 into shared memory (row stride LD); rows at
// or past n_rows are zeros. `src(r)` points at row r (16-byte aligned).
// All loads are issued before any is stored.
template <int ROWS, int W, int LD, class Src>
__device__ __forceinline__ void stage_f32(float* dst, int n_rows, Src src) {
  constexpr int kPerRow = W / 4;
  static_assert((ROWS * kPerRow) % kThreads == 0, "rows split over the block");
  constexpr int kIters = ROWS * kPerRow / kThreads;
  float4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kPerRow;
    buf[k] = r < n_rows
                 ? reinterpret_cast<const float4*>(src(r))[idx % kPerRow]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    float* row = dst + (idx / kPerRow) * LD + (idx % kPerRow) * 4;
    row[0] = buf[k].x;
    row[1] = buf[k].y;
    row[2] = buf[k].z;
    row[3] = buf[k].w;
  }
}

// Copy kQ rows of W bf16 into a swizzled [kQ][W] tile with cp.async
// (rows at or past n_rows are zeros); the caller commits and waits.
template <int W, class Src>
__device__ __forceinline__ void load_tile(bf16* dst, int n_rows, Src src) {
  constexpr int kChunks = W / 8;
  static_assert((kQ * kChunks) % kThreads == 0, "rows split over the block");
#pragma unroll
  for (int k = 0; k < kQ * kChunks / kThreads; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kChunks, cc = idx % kChunks;
    const bool ok = r < n_rows;
    cp_async16(smem_u32(&dst[swz<W>(r, cc)]), src(ok ? r : 0) + cc * 8, ok);
  }
}

// The block's kQ x kPS slice of x into a [kQ][kXLd] tile.
__device__ __forceinline__ void load_x_slice(bf16* dst, int n_rows,
                                             const bf16* x0, int x_stride) {
  constexpr int kChunks = kPS / 8;
  static_assert((kQ * kChunks) % kThreads == 0, "rows split over the block");
#pragma unroll
  for (int k = 0; k < kQ * kChunks / kThreads; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kChunks, cc = idx % kChunks;
    const bool ok = r < n_rows;
    cp_async16(smem_u32(&dst[r * kXLd + cc * 8]),
               x0 + static_cast<size_t>(ok ? r : 0) * x_stride + cc * 8, ok);
  }
}

// v0, v1 as bf16 pairs hi and lo with hi + lo = (v0, v1) to ~2^-16
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// ------------------------------------------------------ 1. chunk states
// S_c[p][n] for the block's 16 p: an M = 16 (p), N = N (n), K = 64 (j)
// product; warp w owns the N / 4 columns from w N / 4 (32 at N = 128, 16
// at N = 64), in n8 tiles taken two at a time. A = (diag(w) x)^T as hi +
// lo fragments built in registers, B = the chunk's B rows via
// ldmatrix.trans.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_mma(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const bf16* __restrict__ Bm,
                        float* __restrict__ states, float* __restrict__ decay,
                        int T_, int H, int G, int nC) {
  static_assert(N % 64 == 0, "four warps of 16-column multiples");
  constexpr int kWN = N / 4;      // state columns a warp owns
  constexpr int kNT = kWN / 8;    // its n8 tiles
  __shared__ __align__(128) bf16 Bs[kQ * N];
  __shared__ __align__(16) bf16 Xs[kQ * kXLd];
  __shared__ float cum[kQ], dts[kQ], wts[kQ];
  // the state-passing grid may launch now; it waits for this one
  griddep_launch_dependents();
  const ChunkPos at(T_, H, G, nC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  load_tile<N>(Bs, at.rows, [&](int r) {
    return Bm + ((at.row0 + r) * G + at.g) * N;
  });
  load_x_slice(Xs, at.rows, x + (at.row0 * H + at.h) * P + at.ps * kPS,
               H * P);
  cp_async_commit();
  if (warp == 0) {
    const float total = chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows,
                                     A[at.h], lane, cum, dts, wts);
    if (lane == 0 && at.ps == 0) decay[at.bc * H + at.h] = expf(total);
  }
  cp_async_wait<0>();
  __syncthreads();

  constexpr int kMT = kPS / 16;   // 16-row tiles of p
  float acc[kMT][kNT][4] = {};
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = mt * 16 + g + 8 * (q & 1);
        const int j = kk * 16 + 2 * t4 + 8 * (q >> 1);
        split_bf16(wts[j] * __bfloat162float(Xs[j * kXLd + p]),
                   wts[j + 1] * __bfloat162float(Xs[(j + 1) * kXLd + p]),
                   ahi[mt][q], alo[mt][q]);
      }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, smem_u32(&Bs[swz<N>(
                            kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            warp * kNT + np * 2 + (lane >> 4))]));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_bf16(acc[mt][2 * np], ahi[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np], alo[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np + 1], ahi[mt], bf[2], bf[3]);
        mma_bf16(acc[mt][2 * np + 1], alo[mt], bf[2], bf[3]);
      }
    }
  }
  float* out = states + (static_cast<size_t>(at.bc) * H + at.h) * P * N
               + static_cast<size_t>(at.ps) * kPS * N;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(out + (mt * 16 + g + 8 * half) * N
                                   + warp * kWN + n * 8 + 2 * t4) =
            make_float2(acc[mt][n][2 * half], acc[mt][n][2 * half + 1]);
}

// fp32: thread (warp w, lane) owns p = 4w .. 4w + 3 of the slice and
// n = lane + 32 q, q < N / 32.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_fma(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        float* __restrict__ states, float* __restrict__ decay,
                        int T_, int H, int G, int nC) {
  static_assert(N % 32 == 0 && kPS == 4 * (kThreads / 32),
                "4 x N / 32 outputs a thread");
  constexpr int kNQ = N / 32;
  __shared__ __align__(16) float Bs[kQ * N];
  __shared__ __align__(16) float Xs[kQ * kPS];
  __shared__ float cum[kQ], dts[kQ], wts[kQ];
  griddep_launch_dependents();
  const ChunkPos at(T_, H, G, nC);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_f32<kQ, N, N>(Bs, at.rows, [&](int r) {
    return Bm + ((at.row0 + r) * G + at.g) * N;
  });
  stage_f32<kQ, kPS, kPS>(Xs, at.rows, [&](int r) {
    return x + ((at.row0 + r) * H + at.h) * P + at.ps * kPS;
  });
  if (warp == 0) {
    const float total = chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows,
                                     A[at.h], lane, cum, dts, wts);
    if (lane == 0 && at.ps == 0) decay[at.bc * H + at.h] = expf(total);
  }
  __syncthreads();
  float acc[4][kNQ] = {};
#pragma unroll 4
  for (int j = 0; j < kQ; ++j) {
    const float w = wts[j];
    float xv[4], bv[kNQ];
#pragma unroll
    for (int r = 0; r < 4; ++r) xv[r] = Xs[j * kPS + 4 * warp + r] * w;
#pragma unroll
    for (int q = 0; q < kNQ; ++q) bv[q] = Bs[j * N + lane + 32 * q];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < kNQ; ++q) acc[r][q] = fmaf(xv[r], bv[q], acc[r][q]);
  }
  float* out = states + (static_cast<size_t>(at.bc) * H + at.h) * P * N
               + static_cast<size_t>(at.ps) * kPS * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
      out[(4 * warp + r) * N + lane + 32 * q] = acc[r][q];
}

// ---------------------------------------------------- 2. state passing
// Grid (P * N / 4 / kPassThreads, B * H): each thread carries 4 state
// elements of one (batch, head) through the chunks in order. The loads of
// a batch of chunks are issued before the chain that uses them.
template <int P, int N>
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass(float* __restrict__ states,
                   const float* __restrict__ decay,
                   float* __restrict__ final_state, int H, int nC) {
  constexpr int kVecs = P * N / 4;
  static_assert(kVecs % kPassThreads == 0, "state splits over the blocks");
  constexpr int kBatch = 8;
  // the chunk-scan grid may launch now and run its intra-chunk part
  griddep_launch_dependents();
  griddep_wait();   // the chunk states are written
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  auto slot = [&](int c) {
    return reinterpret_cast<float4*>(states)
           + ((static_cast<size_t>(b) * nC + c) * H + h) * kVecs + e;
  };
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nC; c0 += kBatch) {
    float4 s[kBatch];
    float d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < nC) {
        s[k] = *slot(c0 + k);
        d[k] = decay[(static_cast<size_t>(b) * nC + c0 + k) * H + h];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = c0 + k;
      if (c < nC) {
        // entering_0 = 0 is never read (the scan skips it), so not stored
        if (c > 0) *slot(c) = run;
        run.x = run.x * d[k] + s[k].x;
        run.y = run.y * d[k] + s[k].y;
        run.z = run.z * d[k] + s[k].z;
        run.w = run.w * d[k] + s[k].w;
      }
    }
  }
  if (final_state != nullptr)
    reinterpret_cast<float4*>(final_state)[static_cast<size_t>(bh) * kVecs
                                           + e] = run;
}

// -------------------------------------------------------- 3. chunk scan
// Warp w owns chunk rows i = 16w .. 16w + 15. Scores (M = 16 i, N = 64 j,
// K = N) from C and B fragments via ldmatrix, only for the j-tiles at or
// left of the diagonal; masked and decayed in registers, rounded to bf16
// as the A operand of the product with x (K = j, N = 16 p,
// ldmatrix.trans). Then, after the wait, C times entering_c^T (B
// fragments straight from the fp32 scratch, rounded once).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan_mma(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ D,
                       const float* __restrict__ states,
                       bf16* __restrict__ y, int T_, int H, int G, int nC) {
  static_assert(N % 64 == 0 && kQ == 64 && kPS % 16 == 0,
                "tile shapes");
  constexpr int kPT = kPS / 8;    // 8-column tiles of p
  __shared__ __align__(128) bf16 Cs[kQ * N];
  __shared__ __align__(128) bf16 Bs[kQ * N];
  __shared__ __align__(16) bf16 Xs[kQ * kXLd];
  __shared__ float cum[kQ], dts[kQ];
  const ChunkPos at(T_, H, G, nC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  load_tile<N>(Cs, at.rows, [&](int r) {
    return Cm + ((at.row0 + r) * G + at.g) * N;
  });
  load_tile<N>(Bs, at.rows, [&](int r) {
    return Bm + ((at.row0 + r) * G + at.g) * N;
  });
  load_x_slice(Xs, at.rows, x + (at.row0 * H + at.h) * P + at.ps * kPS,
               H * P);
  cp_async_commit();
  if (warp == 0)
    chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows, A[at.h], lane, cum,
                 dts, nullptr);
  cp_async_wait<0>();
  __syncthreads();

  const int i0 = 16 * warp;
  uint32_t cf[N / 16][4];   // the warp's C rows as A fragments
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ldsm_x4(cf[kk], smem_u32(&Cs[swz<N>(i0 + (lane & 7)
                                           + ((lane >> 3) & 1) * 8,
                                       kk * 2 + (lane >> 4))]));
  float s[kQ / 8][4];
#pragma unroll
  for (int nt = 0; nt < kQ / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (nt > 2 * warp + 1) continue;   // wholly above the diagonal
#pragma unroll
    for (int kq = 0; kq < N / 32; ++kq) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(&Bs[swz<N>(nt * 8 + (lane & 7),
                                      kq * 4 + (lane >> 3))]));
      mma_bf16(s[nt], cf[2 * kq], bf[0], bf[1]);
      mma_bf16(s[nt], cf[2 * kq + 1], bf[2], bf[3]);
    }
  }
  // s_ij = C_i.B_j exp(cum_i - cum_j) dt_j for j <= i, else 0; the
  // exponent is taken only where j <= i (above the diagonal
  // cum_i - cum_j > 0 and can overflow)
  const float cum_i[2] = {cum[i0 + g], cum[i0 + g + 8]};
#pragma unroll
  for (int nt = 0; nt < kQ / 8; ++nt) {
    if (nt > 2 * warp + 1) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1);
      const int j = nt * 8 + 2 * t4 + (e & 1);
      s[nt][e] = j <= i ? s[nt][e] * expf(cum_i[e >> 1] - cum[j]) * dts[j]
                        : 0.f;
    }
  }
  float acc[kPT][4] = {};
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    if (kk > warp) continue;
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int pp = 0; pp < kPT / 2; ++pp) {
      uint32_t xf[4];
      ldsm_x4_trans(xf, smem_u32(&Xs[(kk * 16 + (lane & 7)
                                      + ((lane >> 3) & 1) * 8) * kXLd
                                     + (pp * 2 + (lane >> 4)) * 8]));
      mma_bf16(acc[2 * pp], pa, xf[0], xf[1]);
      mma_bf16(acc[2 * pp + 1], pa, xf[2], xf[3]);
    }
  }

  griddep_wait();   // entering_c is in the scratch (grid 2 has finished)
  float yi[kPT][4] = {};
  if (at.c > 0) {
    const float* ent = states
                       + (static_cast<size_t>(at.bc) * H + at.h) * P * N
                       + static_cast<size_t>(at.ps) * kPS * N;
    constexpr int kKB = 4;   // k-steps whose entering loads fly together
#pragma unroll
    for (int k0 = 0; k0 < N / 16; k0 += kKB) {
      float2 ev[kKB][kPT][2];
#pragma unroll
      for (int kq = 0; kq < kKB; ++kq)
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            ev[kq][pt][hf] = *reinterpret_cast<const float2*>(
                ent + (pt * 8 + g) * N + (k0 + kq) * 16 + 2 * t4 + 8 * hf);
#pragma unroll
      for (int kq = 0; kq < kKB; ++kq)
#pragma unroll
        for (int pt = 0; pt < kPT; ++pt)
          mma_bf16(yi[pt], cf[k0 + kq],
                   pack_bf16(ev[kq][pt][0].x, ev[kq][pt][0].y),
                   pack_bf16(ev[kq][pt][1].x, ev[kq][pt][1].y));
    }
  }
  const float dskip = D[at.h];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + g + 8 * half;
    if (i >= at.rows) continue;
    const float ecum = expf(cum[i]);
    bf16* yr = y + ((at.row0 + i) * H + at.h) * P + at.ps * kPS;
#pragma unroll
    for (int pt = 0; pt < kPT; ++pt) {
      const int p = pt * 8 + 2 * t4;
      const float v0 = acc[pt][2 * half] + ecum * yi[pt][2 * half]
                       + dskip * __bfloat162float(Xs[i * kXLd + p]);
      const float v1 = acc[pt][2 * half + 1] + ecum * yi[pt][2 * half + 1]
                       + dskip * __bfloat162float(Xs[i * kXLd + p + 1]);
      *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(v0, v1);
    }
  }
}

// fp32: scores as 8 x 4 register tiles (rows ty + 8a, columns tx + 16b of
// a 16 x 8 thread grid) into shared memory, then y as 8 x 1 tiles (rows
// ty + 8a, column tx). Shared memory ~95 KB (dynamic).
template <int N>
struct FmaScanSmem {
  float Cs[kQ * (N + 1)];
  float Bs[kQ * (N + 1)];
  float Ss[kQ * (kQ + 1)];
  float Es[kPS * (N + 1)];
  float Xs[kQ * kPS];
  float cum[kQ], dts[kQ];
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan_fma(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ D,
                       const float* __restrict__ states,
                       float* __restrict__ y, int T_, int H, int G, int nC) {
  static_assert(kThreads == 128 && kQ == 64 && kPS == 16, "thread tiles");
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<FmaScanSmem<N>*>(smem4);
  const ChunkPos at(T_, H, G, nC);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage_f32<kQ, N, N + 1>(sm.Cs, at.rows, [&](int r) {
    return Cm + ((at.row0 + r) * G + at.g) * N;
  });
  stage_f32<kQ, N, N + 1>(sm.Bs, at.rows, [&](int r) {
    return Bm + ((at.row0 + r) * G + at.g) * N;
  });
  stage_f32<kQ, kPS, kPS>(sm.Xs, at.rows, [&](int r) {
    return x + ((at.row0 + r) * H + at.h) * P + at.ps * kPS;
  });
  if (tid < 32)
    chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows, A[at.h], tid, sm.cum,
                 sm.dts, nullptr);
  __syncthreads();

  float sc[8][4] = {};
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    float cv[8], bv[4];
#pragma unroll
    for (int a = 0; a < 8; ++a) cv[a] = sm.Cs[(ty + 8 * a) * (N + 1) + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) bv[q] = sm.Bs[(tx + 16 * q) * (N + 1) + k];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[a][q] = fmaf(cv[a], bv[q], sc[a][q]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ty + 8 * a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + 16 * q;
      sm.Ss[i * (kQ + 1) + j] =
          j <= i ? sc[a][q] * expf(sm.cum[i] - sm.cum[j]) * sm.dts[j] : 0.f;
    }
  }
  __syncthreads();
  float acc[8] = {};
#pragma unroll 4
  for (int j = 0; j < kQ; ++j) {
    const float xv = sm.Xs[j * kPS + tx];
#pragma unroll
    for (int a = 0; a < 8; ++a)
      acc[a] = fmaf(sm.Ss[(ty + 8 * a) * (kQ + 1) + j], xv, acc[a]);
  }

  griddep_wait();   // entering_c is in the scratch (grid 2 has finished)
  float yi[8] = {};
  if (at.c > 0) {
    stage_f32<kPS, N, N + 1>(sm.Es, kPS, [&](int r) {
      return states + (static_cast<size_t>(at.bc) * H + at.h) * P * N
             + static_cast<size_t>(at.ps * kPS + r) * N;
    });
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float ev = sm.Es[tx * (N + 1) + n];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        yi[a] = fmaf(sm.Cs[(ty + 8 * a) * (N + 1) + n], ev, yi[a]);
    }
  }
  const float dskip = D[at.h];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ty + 8 * a;
    if (i < at.rows)
      y[((at.row0 + i) * H + at.h) * P + at.ps * kPS + tx] =
          acc[a] + expf(sm.cum[i]) * yi[a] + dskip * sm.Xs[i * kPS + tx];
  }
}

// ------------------------------------------------------------- launch
template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, void* y, float* final_state,
           float* scratch, int B, int T_, int H, int G, cudaStream_t s) {
  const int nC = (T_ + kQ - 1) / kQ;
  if (static_cast<long long>(B) * nC > 65535 || H > 65535 ||
      static_cast<long long>(B) * H > 65535)
    return kBadArgument;
  float* states = scratch;
  float* decay = scratch + static_cast<size_t>(B) * nC * H * P * N;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const dim3 grid(P / kPS, H, B * nC);
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  if (nC > 0) {
    if constexpr (kBf16)
      ssd_chunk_state_mma<P, N><<<grid, kThreads, 0, s>>>(
          xt, dt, A, bt, states, decay, T_, H, G, nC);
    else
      ssd_chunk_state_fma<P, N><<<grid, kThreads, 0, s>>>(
          xt, dt, A, bt, states, decay, T_, H, G, nC);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // with nC = 0 this only writes the zero final state
  cudaError_t rc = launch_dependent(
      ssd_state_pass<P, N>, dim3(P * N / 4 / kPassThreads, B * H),
      dim3(kPassThreads), 0, s, states, decay, final_state, H, nC);
  if (rc != cudaSuccess || nC == 0) return static_cast<int>(rc);
  if constexpr (kBf16) {
    rc = launch_dependent(ssd_chunk_scan_mma<P, N>, grid, dim3(kThreads), 0,
                          s, xt, dt, A, bt, ct, D, states,
                          static_cast<T*>(y), T_, H, G, nC);
  } else {
    constexpr int kBytes = static_cast<int>(sizeof(FmaScanSmem<N>));
    // once per instantiation (and process): allow more than 48 KB
    static const cudaError_t attr = cudaFuncSetAttribute(
        ssd_chunk_scan_fma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    rc = launch_dependent(ssd_chunk_scan_fma<P, N>, grid, dim3(kThreads),
                          kBytes, s, xt, dt, A, bt, ct, D, states,
                          static_cast<T*>(y), T_, H, G, nC);
  }
  return static_cast<int>(rc);
}

// ------------------------------------------------------------- backward
// The gradient of the scan above for dy and for the final state's
// gradient dfinal (no TPU counterpart: the JAX package differentiates its
// XLA reference `ssd_chunked`, and its Pallas kernel has no custom_vjp).
// kernels/ssd_scan.py `ssd_scan_backward_plain` is its plain version, term
// by term. Per (batch, head, chunk c), with E_c the state entering the
// chunk, w_j = dt_j exp(total - cum_j) and M_ij = (C_i . B_j) L_ij:
//   E_0 = 0, E_{c+1} = exp(total_c) E_c + S_c, S_c = sum_j w_j x_j B_j^T;
//   G = dfinal (or 0), for c down: dS_c = G, G = dE_c + exp(total_c) G,
//   dE_c = sum_i exp(cum_i) dy_i C_i^T                  (1. ssd_bwd_pass)
//   then, chunk by chunk                               (2. ssd_bwd_chunk)
//   dx_j = D dy_j + w_j dS_c B_j + dt_j sum_{i>=j} M_ij dy_i
//   dB_j = sum_h [w_j dS_c^T x_j] + sum_i dM_ij C_i, dC_i = sum_h
//          [exp(cum_i) E_c^T dy_i] + sum_j dM_ij B_j, with dM the sum over
//          the group's heads of (dy_i . x_j) L_ij dt_j (j <= i)
//   dcum from the intra-chunk, inter-chunk and chunk-state terms, the
//   chunk's dtotal (sum_j dw_j w_j + exp(total) <E_c, dS_c>) on its last
//   row, reverse-summed into da: ddt = (intra and w terms) + A da, and
//   per-chunk partial sums of dA (da . dt) and dD (dy . x)
// and the fixed-order sums of a third grid (3. ssd_bwd_sums): dA and dD
// over (batch, chunk), and dB and dC over a group's head-slices when the
// group is split. Grids 2 and 3 are chained to the one before by
// programmatic dependent launch. No atomics: every output element and
// partial sum has one writer and a fixed order, so results do not depend
// on the run. Rows past T are staged as zeros with dt = 0; their
// gradients are not stored.
//
// Grid 1 walks each (batch, head)'s chunks in order, forward for E_c and
// back for dS_c, the running state in registers: S_c and dE_c never reach
// device memory. A block of grid 2 spans the heads of one slice of one
// group (the group's heads cut into k slices, k from the wrapper:
// `backward_head_splits`, the fewest that give two waves of the card). It
// stages the chunk's B and C once and computes C B^T once; each head
// applies its own decay. B and C are the group's, so the intra-chunk dB
// and dC are products of the heads' summed dM (one each for the block),
// and the chunk-state and inter-chunk terms gather over the heads in
// registers (or shared memory): the block writes one fp32 partial row a
// head-slice, (B, T, G, k, N), or the final dB and dC when k = 1. No
// (B, T, H, N) rows a head.
//
// What bounds it: at mamba2's training shape (B 8, T 1024, 32 heads, P 64,
// N 128) the products the gradient needs are ~26 GFLOP (0.39 ms on fp32's
// 67 TFLOP/s, 0.026 ms on bf16's tensor cores) and its inputs and outputs
// ~0.11 GB in bf16 (0.033 ms at 3.35 TB/s). The scratch is E_c and dS_c,
// (B, nC, H, P, N) fp32 each, 134 MB each at that shape, written once by
// grid 1 and read once by grid 2 (0.54 GB, 0.16 ms), besides the
// (B, nC, H) dA and dD terms and, at k = 4 there, 2 x 16.8 MB of
// head-slice partials of dB and dC: those bytes, not the tensor cores,
// bound the bf16 kernel; the FMAs bound the fp32 one.
//
// bf16 runs every product on the tensor cores as mma.sync.m16n8k16 with
// ldmatrix operands from swizzled shared memory, fp32 accumulators.
// mma.sync rather than wgmma: each product is 64 rows by 64 or N columns,
// chained per head through registers (x dy^T -> the scores and dM ->
// their products) in the m16n8k16 accumulator and A layouts, and the
// operands are wanted in both orientations (x and dy as rows and as
// columns, B dS^T and x^T dS), which ldmatrix and ldmatrix.trans read from
// one swizzled tile; at these sizes the kernel waits on the state bytes
// and on its per-head phases, not on the rate of the products. The
// operands computed in fp32 (diag(w) x and diag(exp(cum)) dy of grid 1,
// the masked scores, the heads' summed dM, E_c and dS_c) are rounded to
// bf16 once: `BACKWARD_ROUNDING`, whose plain mirror keeps every gradient
// within bf16's tolerance (tests/test_torch_train_families.py). The row
// and column sums that feed dcum, ddt and dA (rsum, csum, dw, the inter
// term, <E_c, dS_c>) are taken from fp32 accumulators or fp32 values,
// never from rounded operands.
//
// fp32 runs on FMAs (TF32 would break the 1e-4 tolerance) as 8 x 8
// register tiles over padded shared-memory rows (an operand whose rows
// run along the tile's columns read as two 16-byte vectors): in grid 2 a
// team of 128 threads takes a 64 x N product (N = 128), a quarter of 64
// threads a 64 x 64 one, so that independent products run side by side.
// Grid 2's blocks hold B, C, x, dy, E_c or dS_c, C B^T, M, the heads'
// summed dM and a dx tile, ~217 KB at N = 128 (two teams' slice sums of
// dB and dC in 255 registers a thread): one block (8 warps) an SM, not
// two.
constexpr int kBwdThreads = 256;
constexpr int kXLdB = 64;       // bf16 x / dy tile rows (P = 64)

// Stage ROWS rows of W elements of T (widened to fp32) into shared memory
// with row stride LD; rows at or past n_rows are zeros. `src(r)` points at
// row r (16-byte aligned). All loads are issued before any is stored.
template <typename T, int ROWS, int W, int LD, int NT, class Src>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows, int tid,
                                           Src src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  static_assert(W % kVec == 0 && (ROWS * kPerRow) % NT == 0,
                "rows split over the threads");
  constexpr int kIters = ROWS * kPerRow / NT;
  uint4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = tid + k * NT;
    const int r = idx / kPerRow;
    buf[k] = r < n_rows
                 ? reinterpret_cast<const uint4*>(src(r))[idx % kPerRow]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = tid + k * NT;
    const T* e = reinterpret_cast<const T*>(&buf[k]);
    float* row = dst + (idx / kPerRow) * LD + (idx % kPerRow) * kVec;
#pragma unroll
    for (int v = 0; v < kVec; ++v) row[v] = to_float(e[v]);
  }
}

// Where a backward block's chunk lies: blockIdx.y = b * nC + c.
struct BwdPos {
  int b, c, bc, rows;
  size_t row0;   // sequence row (b * T + c * kQ) of the chunk's first row

  __device__ __forceinline__ BwdPos(int T_, int nC) {
    bc = blockIdx.y;
    b = bc / nC;
    c = bc % nC;
    rows = min(kQ, T_ - c * kQ);
    row0 = static_cast<size_t>(b) * T_ + static_cast<size_t>(c) * kQ;
  }
};

// One warp: a chunk's per-row scalars from its dt, rows 2 lane and 2 lane
// + 1 in d0 and d1 (0 past the sequence): cum (the inclusive cumsum of dt
// a), dt, w = dt exp(total - cum) and exp(cum); returns total.
__device__ __forceinline__ float chunk_scalars(float d0, float d1, float a,
                                               int lane, float* cum,
                                               float* dts, float* wts,
                                               float* ecum) {
  const int i0 = 2 * lane;
  const float v1 = d1 * a;
  float incl = d0 * a + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
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
  return total;
}

// 4-byte global -> shared copy; with `full` false it writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// acc[a][b] += sum over k < K of A(a, k) * B(b, k): one thread's 8 x 8
// register tile of an fp32 product, its operands read from shared memory
// by `av(a, k)` and `bv(b, k)`; the loop over k unrolled twice, or
// (kUnroll false) not at all, for a kernel short of registers
template <int K, bool kUnroll = true, class FA, class FB>
__device__ __forceinline__ void fma_tile(float (&acc)[8][8], FA av, FB bv) {
  auto step = [&](int k) {
    float ar[8], br[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) ar[a] = av(a, k);
#pragma unroll
    for (int b = 0; b < 8; ++b) br[b] = bv(b, k);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
  };
  if constexpr (kUnroll) {
#pragma unroll 2
    for (int k = 0; k < K; ++k) step(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < K; ++k) step(k);
  }
}

template <int M, int N2>
__device__ __forceinline__ void zero(float (&t)[M][N2]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int b = 0; b < N2; ++b) t[a][b] = 0.f;
}

// a barrier over the 128 threads of one team (ids 1 and 2; 0 is the
// block's __syncthreads)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(team + 1) : "memory");
}

// ------------------------------- 1. the states and their gradients
// Grid (P / PS, B * H): one block a (P-slice of PS rows, batch, head)
// walks the chunks in order, computing each chunk's S_c slice [p][n] =
// sum_j w_j x_j[p] B_j[n] and writing the state entering it (E_0 = 0,
// E_{c+1} = exp(total_c) E_c + S_c), then back from the last, computing
// dE_c [p][n] = sum_i exp(cum_i) dy_i[p] C_i[n] and writing dS_c (G =
// dfinal or 0; dS_c = G, G = dE_c + exp(total_c) G). The running state
// stays in registers, and each chunk's tiles (x or dy slice, B or C, dt)
// arrive by cp.async while the chunk before is computed: S_c and dE_c
// never reach device memory. bf16: PS 64 (all of P: B and C come from L2
// once a (batch, head) and chunk), 4 warps, m16n8k16 with the scaled rows
// transposed as A (built in registers, rounded once) and B or C via
// ldmatrix.trans; warp w owns the rows 16 w .. 16 w + 15.
// fp32: 8 x 8 tiles read as 16-byte vectors, PS 32 at N 128 (p = 4 ty
// .. 4 ty + 3 and 16 more, n = 4 tx .. 4 tx + 3 and 64 more) and 64 at
// N 64 (32 more each), groups of 64 threads (two at N 128, four at 64)
// over a share of the chunk's rows each, added in group order.
// As fma_tile, with B read as two 16-byte vectors: the thread's columns
// are c0 .. c0 + 3 and c0 + kHalf .. c0 + kHalf + 3 of the row that
// `brow(k)` points at (16-byte aligned rows), so a k step loads 8 scalars
// of A and 2 vectors of B for its 64 multiply-adds, not 16 scalars
template <int K, int kHalf, bool kUnroll = true, class FA, class FB>
__device__ __forceinline__ void fma_tile_v(float (&acc)[8][8], FA av,
                                           FB brow, int c0) {
  auto step = [&](int k) {
    float ar[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) ar[a] = av(a, k);
    const float* r = brow(k) + c0;
    const float4 b0 = *reinterpret_cast<const float4*>(r);
    const float4 b1 = *reinterpret_cast<const float4*>(r + kHalf);
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
  };
  if constexpr (kUnroll) {
#pragma unroll 2
    for (int k = 0; k < K; ++k) step(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < K; ++k) step(k);
  }
}

// As fma_tile_v, with A read as vectors too: the thread's rows are r0 ..
// r0 + 3 and r0 + kHalfA .. r0 + kHalfA + 3 of the row `arow(k)` points
// at, each scaled by `ascale(k)`
template <int K, int kHalfA, int kHalfB, class FA, class FS, class FB>
__device__ __forceinline__ void fma_tile_vv(float (&acc)[8][8], FA arow,
                                            FS ascale, int r0, FB brow,
                                            int c0) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* ra = arow(k) + r0;
    const float* rb = brow(k) + c0;
    const float s = ascale(k);
    const float4 a0 = *reinterpret_cast<const float4*>(ra);
    const float4 a1 = *reinterpret_cast<const float4*>(ra + kHalfA);
    const float4 b0 = *reinterpret_cast<const float4*>(rb);
    const float4 b1 = *reinterpret_cast<const float4*>(rb + kHalfB);
    const float ar[8] = {s * a0.x, s * a0.y, s * a0.z, s * a0.w,
                         s * a1.x, s * a1.y, s * a1.z, s * a1.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
  }
}

template <typename T, int P, int N>
struct PassShape {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kPS = kBf16 ? 64 : (N == 128 ? 32 : 64);
  // fp32: groups of 64 threads, each over an equal share of the chunk's
  // rows, their 8 x 8 tiles added in group order by the first; four at N
  // 64 (B * H blocks only), two at 128
  static constexpr int kGroups = kBf16 ? 1 : (N == 128 ? 2 : 4);
  static constexpr int kThreads = kBf16 ? 128 : 64 * kGroups;
  static constexpr int kLd = kBf16 ? kPS + 8 : kPS;   // x / dy slice rows
  // chunks in flight: a bf16 step is short next to a load's latency
  static constexpr int kStages = kBf16 ? 3 : 2;
};

template <typename T, int P, int N>
struct BwdPassSmem {
  using S = PassShape<T, P, N>;
  T Ms[S::kStages][kQ * N];       // B (forward) or C (back) of a chunk
  T Rs[S::kStages][kQ * S::kLd];  // the x or dy slice
  float dts[S::kStages][kQ];      // the chunk's dt, as it arrives
  float cum[kQ], dtc[kQ], wts[kQ], ecum[kQ];
  // fp32: the other groups' partial tiles, [group][element][thread]
  float part[S::kBf16 ? 1 : S::kGroups - 1][S::kBf16 ? 1 : 64][64];
  float decay;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(PassShape<T, P, N>::kThreads)
    ssd_bwd_pass(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const T* __restrict__ dy,
                 const float* __restrict__ dfinal,
                 float* __restrict__ states, float* __restrict__ dstates,
                 int T_, int H, int G, int nC) {
  using S = PassShape<T, P, N>;
  constexpr bool kBf16 = S::kBf16;
  constexpr int kPS = S::kPS, kNT = S::kThreads, kLd = S::kLd;
  // a thread's tile of the (PS, N) state: bf16, the m16n8k16 accumulators
  // of the warp's 16 rows; fp32, 8 x 8
  constexpr int kR = kBf16 ? N / 8 : 8, kC = kBf16 ? 4 : 8;
  constexpr int kTX = N == 128 ? 16 : 8;
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<BwdPassSmem<T, P, N>*>(smem4);
  // the chunk grid may launch now and run its first intra-chunk part
  griddep_launch_dependents();
  const int ps = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int grp = tid / 64, lq = tid % 64;   // fp32: a thread's group
  const int ty = lq / kTX, tx = lq % kTX;
  const float a = A[h];
  // chunk c's tiles of `rows` (x or dy) and `mat` (B or C), and its dt,
  // into buffer `buf`: one cp.async group
  auto load = [&](const T* rows, const T* mat, int c, int buf) {
    const size_t row0 =
        static_cast<size_t>(b) * T_ + static_cast<size_t>(c) * kQ;
    const int n_rows = min(kQ, T_ - c * kQ);
    constexpr int kE = 16 / sizeof(T);   // elements a 16-byte copy
    constexpr int kMC = N / kE, kRC = kPS / kE;
    for (int k = tid; k < kQ * kMC; k += kNT) {
      const int r = k / kMC, cc = k % kMC;
      const bool ok = r < n_rows;
      T* dst = kBf16 ? &sm.Ms[buf][swz<N>(r, cc)] : &sm.Ms[buf][r * N + cc * kE];
      cp_async16(smem_u32(dst),
                 mat + ((row0 + (ok ? r : 0)) * G + g) * N + cc * kE, ok);
    }
    for (int k = tid; k < kQ * kRC; k += kNT) {
      const int r = k / kRC, cc = k % kRC;
      const bool ok = r < n_rows;
      cp_async16(smem_u32(&sm.Rs[buf][r * kLd + cc * kE]),
                 rows + ((row0 + (ok ? r : 0)) * H + h) * P + ps * kPS
                     + cc * kE,
                 ok);
    }
    for (int r = tid; r < kQ; r += kNT)
      cp_async4(&sm.dts[buf][r], dt + (row0 + (r < n_rows ? r : 0)) * H + h,
                r < n_rows);
    cp_async_commit();
  };
  // acc = sum over the chunk's rows j of scl_j rows_j[p] mat_j[n] (fp32:
  // the first group's tile holds the sum)
  auto product = [&](float (&acc)[kR][kC], int buf, bool forward) {
    const float* scl = forward ? sm.wts : sm.ecum;
    zero(acc);
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = 16 * warp + g4 + 8 * (q & 1);
          const int j = kk * 16 + 2 * t4 + 8 * (q >> 1);
          af[q] = pack_bf16(
              scl[j] * to_float(sm.Rs[buf][j * kLd + p]),
              scl[j + 1] * to_float(sm.Rs[buf][(j + 1) * kLd + p]));
        }
#pragma unroll
        for (int np = 0; np < kR / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, smem_u32(&sm.Ms[buf][swz<N>(
                                kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                np * 2 + (lane >> 4))]));
          mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    } else {
      constexpr int kG = S::kGroups, kJ = kQ / kG;
      const int j0 = grp * kJ;
      const T* rs = sm.Rs[buf] + j0 * kLd;
      const T* ms = sm.Ms[buf] + j0 * N;
      scl += j0;
      fma_tile_vv<kJ, kPS / 2, N / 2>(
          acc, [&](int j) { return rs + j * kLd; },
          [&](int j) { return scl[j]; }, 4 * ty,
          [&](int j) { return ms + j * N; }, 4 * tx);
      if constexpr (kG > 1) {
        if (grp > 0)
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int q = 0; q < kC; ++q)
              sm.part[grp - 1][r * kC + q][lq] = acc[r][q];
        __syncthreads();
        if (grp == 0)
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int q = 0; q < kC; ++q)
#pragma unroll
              for (int o = 0; o < kG - 1; ++o)
                acc[r][q] += sm.part[o][r * kC + q][lq];
      }
    }
  };
  // element (r, c) of the thread's tile: its offset in a (PS, N) slice
  auto at = [&](int r, int c) {
    if constexpr (kBf16)
      return (16 * warp + g4 + 8 * (c >> 1)) * N + r * 8 + 2 * t4 + (c & 1);
    else
      return (4 * ty + (r & 3) + (r >> 2) * (kPS / 2)) * N + 4 * tx + (c & 3)
             + (c >> 2) * (N / 2);
  };
  auto slot = [&](float* base, int c) {
    return base + ((static_cast<size_t>(b) * nC + c) * H + h) * P * N
           + static_cast<size_t>(ps) * kPS * N;
  };
  float run[kR][kC], acc[kR][kC];
  // one sweep: out[c] = the running state, then run = decay run + acc
  auto sweep = [&](const T* rows, const T* mat, float* out, bool forward) {
    constexpr int kSt = S::kStages;
    const int c0 = forward ? 0 : nC - 1, step = forward ? 1 : -1;
    // kSt - 1 chunks ahead, one cp.async group each (empty past the end)
    for (int k = 0; k < kSt - 1; ++k) {
      if (k < nC) load(rows, mat, c0 + step * k, k);
      else cp_async_commit();
    }
    for (int k = 0; k < nC; ++k) {
      const int c = c0 + step * k, buf = k % kSt, kn = k + kSt - 1;
      // into the buffer the step before freed
      if (kn < nC) load(rows, mat, c0 + step * kn, kn % kSt);
      else cp_async_commit();
      cp_async_wait<kSt - 1>();
      __syncthreads();
      if (warp == 0) {
        const float total = chunk_scalars(
            sm.dts[buf][2 * lane], sm.dts[buf][2 * lane + 1], a, lane,
            sm.cum, sm.dtc, sm.wts, sm.ecum);
        if (lane == 0) sm.decay = expf(total);
      }
      __syncthreads();
      product(acc, buf, forward);
      if (kBf16 || grp == 0) {
        const float d = sm.decay;
        float* o = slot(out, c);
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kC; q += 2) {
            // (q, q + 1): adjacent columns in both dtypes' tiles
            *reinterpret_cast<float2*>(o + at(r, q)) =
                make_float2(run[r][q], run[r][q + 1]);
            run[r][q] = fmaf(run[r][q], d, acc[r][q]);
            run[r][q + 1] = fmaf(run[r][q + 1], d, acc[r][q + 1]);
          }
      }
      __syncthreads();   // this buffer is loaded again at the next step
    }
  };
  zero(run);
  sweep(x, Bm, states, true);
  if (dfinal != nullptr && (kBf16 || grp == 0)) {
    const float* df = dfinal + (static_cast<size_t>(bh) * P + ps * kPS) * N;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kC; ++q) run[r][q] = df[at(r, q)];
  } else {
    zero(run);
  }
  sweep(dy, Cm, dstates, false);
}

// --------------------------------------------------- 2. chunk gradients
// Grid (G * k, B * nC): block (g * k + s, b * nC + c) takes the heads of
// slice s of group g in order. Per head it writes dx and ddt and the
// chunk's dA and dD terms; at the end its slice's dB and dC rows.

// The per-head scalars, one warp, two rows a lane: dcum from the partial
// sums (rsum_i = sum_j t_ij dt_j, csum_j = sum_i t_ij with t = (dy_i .
// x_j) M_ij, dw, the inter term), dtotal on the last row, the reverse
// cumsum into da, ddt, and the chunk's dA and dD terms.
struct HeadSums {
  const float *rsum, *csum, *dw, *inter, *cum, *dts, *wts;
  float total, es, dd;
};

__device__ __forceinline__ void head_tail(const HeadSums& s, float a,
                                          int lane, int rows, size_t row0,
                                          int H, int h, size_t bch,
                                          float* __restrict__ ddt,
                                          float* __restrict__ dA_part,
                                          float* __restrict__ dD_part) {
  const int i0 = 2 * lane;
  float dcum[2], wdw = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = i0 + k;
    const float dwi = s.dw[i] * s.wts[i];
    wdw += dwi;
    dcum[k] = s.rsum[i] + s.inter[i] - s.dts[i] * s.csum[i] - dwi;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wdw += __shfl_xor_sync(0xffffffffu, wdw, off);
  if (i0 + 1 == kQ - 1) dcum[1] += wdw + expf(s.total) * s.es;
  // da_i = sum over rows r >= i of dcum_r
  float incl = dcum[0] + dcum[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  float after = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) after = 0.f;
  const float da[2] = {after + dcum[1] + dcum[0], after + dcum[1]};
  float da_dt = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = i0 + k;
    da_dt = fmaf(da[k], s.dts[i], da_dt);
    if (i < rows)
      ddt[(row0 + i) * H + h] =
          s.csum[i] + s.dw[i] * expf(s.total - s.cum[i]) + a * da[k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
  if (lane == 0) {
    dA_part[bch] = da_dt;
    dD_part[bch] = s.dd;
  }
}

// bf16: warp w owns the 16 rows 16 (w & 3) .. + 15 (rows j of the
// transposed products, rows i of dC) and half w >> 2 of the columns of
// its 64 x 64 (p) and 64 x N (n) products; the two halves share the 64 x
// 64 ones (C B^T, x dy^T and what follows), which each computes.
template <int N>
struct BwdChunkSmemB {
  bf16 Cs[kQ * N];          // [i][n], swizzled
  bf16 Bs[kQ * N];          // [j][n]
  bf16 Xs[2][kQ * kXLdB];   // [j][p], this head's and the next's; at the
                            // end the heads' dM^T [j][i]
  bf16 dYs[2][kQ * kXLdB];  // [i][p]
  bf16 Es[64 * N];          // E_c [p][n], rounded once
  bf16 dSs[64 * N];         // dS_c [p][n]
  float Ef[64 * N];         // E_c and dS_c in fp32 as they arrive, the
  float dSf[64 * N];        // next head's while this one computes
  // C B^T and the heads' summed dM^T in the accumulator layout of a row
  // block: [row block][n8 tile][lane] float4s, so a warp's reads of one
  // tile are 512 consecutive bytes
  float4 cbt[4][8][32];
  float4 dmt[4][8][32];
  float dtv[2][kQ];         // each head's dt as it arrives
  float cum[kQ], dts[kQ], wts[kQ], ecum[kQ];
  float rsum[4][kQ];        // by row block, summed in order
  float csum[kQ];
  float dw[2][kQ], inter[2][kQ];   // by column half
  float red[2][kBwdThreads / 32];
  float total;
};

template <int P, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm,
                      const float* __restrict__ D,
                      const bf16* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      bf16* __restrict__ dx, float* __restrict__ ddt,
                      bf16* __restrict__ dB, bf16* __restrict__ dC,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      float* __restrict__ dA_part,
                      float* __restrict__ dD_part, int T_, int H, int G,
                      int nC, int splits) {
  static_assert(P == 64 && N % 64 == 0 && kQ == 64, "tile shapes");
  constexpr int kNH = N / 16;     // n8 tiles of a column half
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<BwdChunkSmemB<N>*>(smem4);
  // the sums' grid may launch now; it waits for this one
  griddep_launch_dependents();
  const BwdPos at(T_, nC);
  const int hg = H / G, hs = hg / splits;
  const int g = blockIdx.x / splits, slice = blockIdx.x % splits;
  const int h0 = g * hg + slice * hs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3, rb = warp & 3, ch = warp >> 2;
  const int j0 = 16 * rb;
  {
    const bf16* br = Bm + (at.row0 * G + g) * N;
    const bf16* cr = Cm + (at.row0 * G + g) * N;
    for (int k = tid; k < kQ * (N / 8); k += kBwdThreads) {
      const int r = k / (N / 8), cc = k % (N / 8);
      const bool ok = r < at.rows;
      const size_t off = static_cast<size_t>(ok ? r : 0) * G * N + cc * 8;
      cp_async16(smem_u32(&sm.Bs[swz<N>(r, cc)]), br + off, ok);
      cp_async16(smem_u32(&sm.Cs[swz<N>(r, cc)]), cr + off, ok);
    }
  }
  // x and dy of head h into buffer `buf`; E_c and dS_c of head h as they
  // are (fp32) into the staging tiles. Each call is one cp.async group.
  auto load_xdy = [&](int h, int buf) {
    const bf16* xr = x + (at.row0 * H + h) * P;
    const bf16* gr = dy + (at.row0 * H + h) * P;
    for (int k = tid; k < kQ * (P / 8); k += kBwdThreads) {
      const int r = k / (P / 8), cc = k % (P / 8);
      const bool ok = r < at.rows;
      const size_t off = static_cast<size_t>(ok ? r : 0) * H * P + cc * 8;
      cp_async16(smem_u32(&sm.Xs[buf][swz<kXLdB>(r, cc)]), xr + off, ok);
      cp_async16(smem_u32(&sm.dYs[buf][swz<kXLdB>(r, cc)]), gr + off, ok);
    }
    for (int r = tid; r < kQ; r += kBwdThreads)
      cp_async4(&sm.dtv[buf][r], dt + (at.row0 + (r < at.rows ? r : 0)) * H + h,
                r < at.rows);
  };
  auto load_es = [&](int h) {
    const size_t st = (static_cast<size_t>(at.bc) * H + h) * P * N;
    for (int k = tid; k < P * N / 4; k += kBwdThreads) {
      cp_async16(smem_u32(&sm.Ef[4 * k]), states + st + 4 * k, true);
      cp_async16(smem_u32(&sm.dSf[4 * k]), dstates + st + 4 * k, true);
    }
  };
  load_xdy(h0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // (C B^T)^T [j][i] = B_j . C_i for the row block's j, i >= j only; once
  if (ch == 0) {
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int kq = 0; kq < N / 32; ++kq) {
      uint32_t ba[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4(ba[q], smem_u32(&sm.Bs[swz<N>(
                           j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           (2 * kq + q) * 2 + (lane >> 4))]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < 2 * rb) continue;   // i < j: masked
        uint32_t cf[4];
        ldsm_x4(cf, smem_u32(&sm.Cs[swz<N>(nt * 8 + (lane & 7),
                                           kq * 4 + (lane >> 3))]));
        mma_bf16(acc[nt], ba[0], cf[0], cf[1]);
        mma_bf16(acc[nt], ba[1], cf[2], cf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sm.cbt[rb][nt][lane] =
          make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      sm.dmt[rb][nt][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // E_c and dS_c of the first head (grid 2 has finished); they arrive
  // while its intra-chunk part runs
  griddep_wait();
  load_es(h0);
  cp_async_commit();
  float dbacc[kNH][4], dcacc[kNH][4];
  zero(dbacc);
  zero(dcacc);
  auto xval = [&](const bf16* t, int r, int p) {
    return __bfloat162float(t[swz<kXLdB>(r, p >> 3) + (p & 7)]);
  };
  // Two cp.async groups a head, committed in this order: the next head's x
  // and dy, then (once this head's staging is converted) its E_c and dS_c;
  // each wait<1> below leaves the younger group in flight.
  for (int hi = 0; hi < hs; ++hi) {
    const int h = h0 + hi, buf = hi & 1;
    const bf16* Xs = sm.Xs[buf];
    const bf16* dYs = sm.dYs[buf];
    if (warp == 0) {
      const float total = chunk_scalars(
          sm.dtv[buf][2 * lane], sm.dtv[buf][2 * lane + 1], A[h], lane,
          sm.cum, sm.dts, sm.wts, sm.ecum);
      if (lane == 0) sm.total = total;
    }
    __syncthreads();
    if (hi + 1 < hs) load_xdy(h + 1, buf ^ 1);
    cp_async_commit();
    // dscores^T [j][i] = x_j . dy_i, i >= j (x rows j as A fragments over
    // k = p)
    float ds[8][4];
    zero(ds);
    {
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(xa[kk], smem_u32(&Xs[swz<kXLdB>(
                            j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            kk * 2 + (lane >> 4))]));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < 2 * rb) continue;
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t yf[4];
          ldsm_x4(yf, smem_u32(&dYs[swz<kXLdB>(nt * 8 + (lane & 7),
                                               kq * 4 + (lane >> 3))]));
          mma_bf16(ds[nt], xa[2 * kq], yf[0], yf[1]);
          mma_bf16(ds[nt], xa[2 * kq + 1], yf[2], yf[3]);
        }
      }
    }
    // scores^T = M^T dt_j (in place of dscores, then rounded once into A
    // fragments), dM^T gathered over the heads, and the sums of t =
    // dscores M: csum over i (this warp's rows), rsum over j (the row
    // blocks' partials)
    uint32_t sa[4][4];
    {
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float rs[2] = {0.f, 0.f};
        const float4 cb4 = sm.cbt[rb][nt][lane];
        float4 dm4 = ch == 0 ? sm.dmt[rb][nt][lane]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        const float cb[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        float* dm = reinterpret_cast<float*>(&dm4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + gq + 8 * (e >> 1);
          const int i = nt * 8 + 2 * t4 + (e & 1);
          float sc = 0.f;
          if (nt >= 2 * rb && i >= j) {
            const float l = expf(sm.cum[i] - sm.cum[j]);
            const float m = cb[e] * l, dtj = sm.dts[j];
            const float t = ds[nt][e] * m;
            sc = m * dtj;
            dm[e] = fmaf(ds[nt][e] * l, dtj, dm[e]);
            cs[e >> 1] += t;
            rs[e & 1] = fmaf(t, dtj, rs[e & 1]);
          }
          ds[nt][e] = sc;
        }
        // the two column halves hold the same dM^T: the first keeps it
        if (ch == 0) sm.dmt[rb][nt][lane] = dm4;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = rs[c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (ch == 0 && gq == 0) sm.rsum[rb][nt * 8 + 2 * t4 + c] = v;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sa[kk][0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
        sa[kk][1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
        sa[kk][2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        sa[kk][3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 1);
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 2);
      }
      if (ch == 0 && t4 == 0) {
        sm.csum[j0 + gq] = cs[0];
        sm.csum[j0 + gq + 8] = cs[1];
      }
    }
    // dx's intra-chunk term [j][p of the half] = sum_{i >= j} scores^T_ji
    // dy_ip (dy via ldmatrix.trans)
    float xi[4][4];
    zero(xi);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < rb) continue;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t yf[4];
        ldsm_x4_trans(yf, smem_u32(&dYs[swz<kXLdB>(
                              kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              ch * 4 + pp * 2 + (lane >> 4))]));
        mma_bf16(xi[2 * pp], sa[kk], yf[0], yf[1]);
        mma_bf16(xi[2 * pp + 1], sa[kk], yf[2], yf[3]);
      }
    }
    // this head's E_c and dS_c have landed: to bf16 tiles, rounded once;
    // <E_c, dS_c> and <dy, x> in fp32
    cp_async_wait<1>();
    __syncthreads();
    {
      float es = 0.f, dd = 0.f;
#pragma unroll 4
      for (int k = tid; k < P * N / 4; k += kBwdThreads) {
        const float4 ev = reinterpret_cast<const float4*>(sm.Ef)[k];
        const float4 sv = reinterpret_cast<const float4*>(sm.dSf)[k];
        es = fmaf(ev.x, sv.x, fmaf(ev.y, sv.y, fmaf(ev.z, sv.z,
                                                    fmaf(ev.w, sv.w, es))));
        const int p = k / (N / 4), n = (k % (N / 4)) * 4;
        const int o = swz<N>(p, n >> 3) + (n & 7);
        *reinterpret_cast<uint2*>(&sm.Es[o]) =
            make_uint2(pack_bf16(ev.x, ev.y), pack_bf16(ev.z, ev.w));
        *reinterpret_cast<uint2*>(&sm.dSs[o]) =
            make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
      }
      for (int k = tid; k < kQ * P; k += kBwdThreads)
        dd = fmaf(xval(Xs, k / P, k % P), xval(dYs, k / P, k % P), dd);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        es += __shfl_xor_sync(0xffffffffu, es, off);
        dd += __shfl_xor_sync(0xffffffffu, dd, off);
      }
      if (lane == 0) {
        sm.red[0][warp] = es;
        sm.red[1][warp] = dd;
      }
    }
    __syncthreads();
    // the staging tiles are free: the next head's E_c and dS_c
    if (hi + 1 < hs) load_es(h + 1);
    cp_async_commit();
    const float wj[2] = {sm.wts[j0 + gq], sm.wts[j0 + gq + 8]};
    // dx's chunk-state term [j][p of the half] = sum_n B_jn dS_pn; dx out,
    // and dw_j = x_j . (dS_c B_j) over the half
    {
      float xs[4][4];
      zero(xs);
#pragma unroll 1
      for (int kq = 0; kq < N / 32; ++kq) {
        uint32_t ba[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
          ldsm_x4(ba[q], smem_u32(&sm.Bs[swz<N>(
                             j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             (2 * kq + q) * 2 + (lane >> 4))]));
#pragma unroll
        for (int pt = 0; pt < 4; ++pt) {
          uint32_t sf[4];
          ldsm_x4(sf, smem_u32(&sm.dSs[swz<N>(ch * 32 + pt * 8 + (lane & 7),
                                              kq * 4 + (lane >> 3))]));
          mma_bf16(xs[pt], ba[0], sf[0], sf[1]);
          mma_bf16(xs[pt], ba[1], sf[2], sf[3]);
        }
      }
      const float dskip = D[h];
      float dwp[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = j0 + gq + 8 * hf;
        bf16* dr = dx + ((at.row0 + j) * H + h) * P;
#pragma unroll
        for (int pt = 0; pt < 4; ++pt) {
          const int p = ch * 32 + pt * 8 + 2 * t4;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float sb = xs[pt][2 * hf + c];
            dwp[hf] = fmaf(xval(Xs, j, p + c), sb, dwp[hf]);
            v[c] = xi[pt][2 * hf + c] + wj[hf] * sb
                   + dskip * xval(dYs, j, p + c);
          }
          if (j < at.rows)
            *reinterpret_cast<uint32_t*>(dr + p) = pack_bf16(v[0], v[1]);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        dwp[hf] += __shfl_xor_sync(0xffffffffu, dwp[hf], 1);
        dwp[hf] += __shfl_xor_sync(0xffffffffu, dwp[hf], 2);
      }
      if (t4 == 0) {
        sm.dw[ch][j0 + gq] = dwp[0];
        sm.dw[ch][j0 + gq + 8] = dwp[1];
      }
    }
    // dB's chunk-state term [j][n of the half] = w_j sum_p x_jp dS_pn
    {
      float tmp[kNH][4];
      zero(tmp);
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xa[4];
        ldsm_x4(xa, smem_u32(&Xs[swz<kXLdB>(
                        j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        kk * 2 + (lane >> 4))]));
#pragma unroll
        for (int np = 0; np < kNH / 2; ++np) {
          uint32_t sf[4];
          ldsm_x4_trans(sf, smem_u32(&sm.dSs[swz<N>(
                                kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                ch * kNH + np * 2 + (lane >> 4))]));
          mma_bf16(tmp[2 * np], xa, sf[0], sf[1]);
          mma_bf16(tmp[2 * np + 1], xa, sf[2], sf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dbacc[nt][e] = fmaf(wj[e >> 1], tmp[nt][e], dbacc[nt][e]);
    }
    // dC's inter-chunk term [i][n of the half] = exp(cum_i) sum_p dy_ip
    // E_pn, and its dot with C_i (dy_i . y_inter_i) over the half
    {
      float tmp[kNH][4];
      zero(tmp);
#pragma unroll 1
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ya[4];
        ldsm_x4(ya, smem_u32(&dYs[swz<kXLdB>(
                        j0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        kk * 2 + (lane >> 4))]));
#pragma unroll
        for (int np = 0; np < kNH / 2; ++np) {
          uint32_t ef[4];
          ldsm_x4_trans(ef, smem_u32(&sm.Es[swz<N>(
                                kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                ch * kNH + np * 2 + (lane >> 4))]));
          mma_bf16(tmp[2 * np], ya, ef[0], ef[1]);
          mma_bf16(tmp[2 * np + 1], ya, ef[2], ef[3]);
        }
      }
      const float ei[2] = {sm.ecum[j0 + gq], sm.ecum[j0 + gq + 8]};
      float ip[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kNH; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = j0 + gq + 8 * (e >> 1);
          const int n = ch * (N / 2) + nt * 8 + 2 * t4 + (e & 1);
          const float v = ei[e >> 1] * tmp[nt][e];
          dcacc[nt][e] += v;
          ip[e >> 1] = fmaf(__bfloat162float(sm.Cs[swz<N>(i, n >> 3) + (n & 7)]),
                            v, ip[e >> 1]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ip[hf] += __shfl_xor_sync(0xffffffffu, ip[hf], 1);
        ip[hf] += __shfl_xor_sync(0xffffffffu, ip[hf], 2);
      }
      if (t4 == 0) {
        sm.inter[ch][j0 + gq] = ip[0];
        sm.inter[ch][j0 + gq + 8] = ip[1];
      }
    }
    __syncthreads();
    if (warp == 0) {
      // the partial sums in a fixed order: row blocks, column halves, warps
      for (int i = lane; i < kQ; i += 32) {
        sm.rsum[0][i] = ((sm.rsum[0][i] + sm.rsum[1][i]) + sm.rsum[2][i])
                        + sm.rsum[3][i];
        sm.dw[0][i] += sm.dw[1][i];
        sm.inter[0][i] += sm.inter[1][i];
      }
      __syncwarp();
      HeadSums s{sm.rsum[0], sm.csum, sm.dw[0], sm.inter[0], sm.cum, sm.dts,
                 sm.wts, sm.total, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kBwdThreads / 32; ++w) {
        s.es += sm.red[0][w];
        s.dd += sm.red[1][w];
      }
      head_tail(s, A[h], lane, at.rows, at.row0, H, h,
                static_cast<size_t>(at.bc) * H + h, ddt, dA_part, dD_part);
    }
    // the next head's x and dy have landed (its E_c and dS_c may fly)
    cp_async_wait<1>();
    __syncthreads();
  }
  // the intra-chunk dB [j][n of the half] += sum_{i >= j} dM^T_ji C_in,
  // dM^T rounded once into A fragments
  uint32_t da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 a0 = sm.dmt[rb][2 * kk][lane], a1 = sm.dmt[rb][2 * kk + 1][lane];
    da[kk][0] = pack_bf16(a0.x, a0.y);
    da[kk][1] = pack_bf16(a0.z, a0.w);
    da[kk][2] = pack_bf16(a1.x, a1.y);
    da[kk][3] = pack_bf16(a1.z, a1.w);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < rb) continue;
#pragma unroll
    for (int np = 0; np < kNH / 2; ++np) {
      uint32_t cf[4];
      ldsm_x4_trans(cf, smem_u32(&sm.Cs[swz<N>(
                            kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            ch * kNH + np * 2 + (lane >> 4))]));
      mma_bf16(dbacc[2 * np], da[kk], cf[0], cf[1]);
      mma_bf16(dbacc[2 * np + 1], da[kk], cf[2], cf[3]);
    }
  }
  // the intra-chunk dC [i][n of the half] += sum_{j <= i} dM_ij B_jn: dM^T
  // through shared memory (in x's tile), read back transposed
  bf16* dms = sm.Xs[0];
  if (ch == 0)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + gq + 8 * (q & 1);
        const int i = kk * 16 + 2 * t4 + 8 * (q >> 1);
        *reinterpret_cast<uint32_t*>(&dms[swz<kXLdB>(j, i >> 3) + (i & 7)]) =
            da[kk][q];
      }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > rb) continue;   // j <= i
    uint32_t am[4];
    ldsm_x4_trans(am, smem_u32(&dms[swz<kXLdB>(
                          kk * 16 + (lane & 7) + 8 * (lane >> 4),
                          2 * rb + ((lane >> 3) & 1))]));
#pragma unroll
    for (int np = 0; np < kNH / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, smem_u32(&sm.Bs[swz<N>(
                            kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            ch * kNH + np * 2 + (lane >> 4))]));
      mma_bf16(dcacc[2 * np], am, bf[0], bf[1]);
      mma_bf16(dcacc[2 * np + 1], am, bf[2], bf[3]);
    }
  }
  // the slice's dB and dC rows: final (k = 1) or its fp32 partial
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = j0 + gq + 8 * hf;
    if (r >= at.rows) continue;
    const size_t row = (at.row0 + r) * G + g;
#pragma unroll
    for (int nt = 0; nt < kNH; ++nt) {
      const int n = ch * (N / 2) + nt * 8 + 2 * t4;
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(dB + row * N + n) =
            pack_bf16(dbacc[nt][2 * hf], dbacc[nt][2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(dC + row * N + n) =
            pack_bf16(dcacc[nt][2 * hf], dcacc[nt][2 * hf + 1]);
      } else {
        const size_t o = (row * splits + slice) * N + n;
        *reinterpret_cast<float2*>(dBp + o) =
            make_float2(dbacc[nt][2 * hf], dbacc[nt][2 * hf + 1]);
        *reinterpret_cast<float2*>(dCp + o) =
            make_float2(dcacc[nt][2 * hf], dcacc[nt][2 * hf + 1]);
      }
    }
  }
}

// fp32: 8 x 8 register tiles over padded rows. A quarter (64 threads, q =
// tid / 64) takes a 64 x 64 product: thread (ty, tx) = (lq / 8, lq % 8)
// owns rows ty + 8a and columns tx + 8b (4 tx .. 4 tx + 3 and 32 more
// where B is read as vectors). A team (128 threads: quarters 0-1 and 2-3)
// takes a 64 x N product: at N = 128 thread (lt / 16, lt % 16) owns rows
// ty + 8a, columns 4 tx .. 4 tx + 3 and 64 more; at N = 64 each of its
// quarters owns the whole 64 x 64 over half of K. Team 0 gathers the slice's dB,
// team 1 its dC, across the heads: in registers at N = 128, in shared
// memory at 64 (the two quarters adding in order).
template <int P, int N>
struct BwdChunkSmemF {
  float Cs[kQ * (N + 4)];     // [i][n]
  float Bs[kQ * (N + 4)];     // [j][n]
  float Xs[kQ * (P + 4)];     // [j][p]
  float dYs[kQ * (P + 4)];    // [i][p]
  float ESs[P * (N + 4)];     // E_c [p][n], then dS_c
  float CBT[kQ * (kQ + 1)];   // (C B^T)^T [j][i]
  float MT[kQ * (kQ + 1)];    // M^T [j][i] masked; later a dx partial
  float DMT[kQ * (kQ + 1)];   // the heads' dM^T [j][i]
  float DX[kQ * (P + 4)];     // dt_j (M^T dy)_j + D dy_j
  float part[4][kQ * 17];     // csum, rsum, dw, inter partials by thread
  // at N = 64 the slice's dB and dC sums (at 128 they stay in registers)
  float DBs[N == 64 ? kQ * (kQ + 1) : 1];
  float DCs[N == 64 ? kQ * (kQ + 1) : 1];
  float cum[kQ], dts[kQ], wts[kQ], ecum[kQ];
  float red[2][kBwdThreads / 32];
  float total;
};

// sum over the first n of row r's partials (rows of 17), in order
__device__ __forceinline__ float row_sum(const float* part, int r, int n) {
  float s = 0.f;
  for (int q = 0; q < n; ++q) s += part[r * 17 + q];
  return s;
}

template <int P, int N>
__global__ void __launch_bounds__(kBwdThreads, 1)
    ssd_bwd_chunk_fma(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D,
                      const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      float* __restrict__ dx, float* __restrict__ ddt,
                      float* __restrict__ dB, float* __restrict__ dC,
                      float* __restrict__ dBp, float* __restrict__ dCp,
                      float* __restrict__ dA_part,
                      float* __restrict__ dD_part, int T_, int H, int G,
                      int nC, int splits) {
  static_assert(P == 64 && (N == 64 || N == 128) && kQ == 64, "tiles");
  // rows padded by 4 floats: 16-byte aligned for the vector reads, and
  // the 8 rows a warp reads at one column fall in distinct banks
  constexpr int LN = N + 4, LP = P + 4, LQ = kQ + 1;
  // the products' k loops unrolled but at N = 128, where a thread holds
  // its slice sums beside another tile in 255 registers
  constexpr bool kUnroll = N != 128;
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<BwdChunkSmemF<P, N>*>(smem4);
  griddep_launch_dependents();
  const BwdPos at(T_, nC);
  const int hg = H / G, hs = hg / splits;
  const int g = blockIdx.x / splits, slice = blockIdx.x % splits;
  const int h0 = g * hg + slice * hs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int quarter = tid / 64, lq = tid % 64, qy = lq / 8, qx = lq % 8;
  const int team = tid / 128, lt = tid % 128;
  // a team's tile: rows ty + 8a, columns 4 tx .. 4 tx + 3 and N / 2
  // more; at N = 64 over the K half thalf
  const int ty = N == 128 ? lt / 16 : qy, tx = N == 128 ? lt % 16 : qx;
  const int thalf = N == 128 ? 0 : lt / 64;
  auto col = [&](int b) { return 4 * tx + (b & 3) + (b >> 2) * (N / 2); };
  const float* br = Bm + (at.row0 * G + g) * N;
  const float* cr = Cm + (at.row0 * G + g) * N;
  stage_rows<float, kQ, N, LN, kBwdThreads>(sm.Bs, at.rows, tid, [&](int r) {
    return br + static_cast<size_t>(r) * G * N;
  });
  stage_rows<float, kQ, N, LN, kBwdThreads>(sm.Cs, at.rows, tid, [&](int r) {
    return cr + static_cast<size_t>(r) * G * N;
  });
  __syncthreads();
  // (C B^T)^T [j][i] = B_j . C_i, once: each quarter over a quarter of
  // the n, added in quarter order
  {
    float acc[8][8];
    zero(acc);
    const int k0 = quarter * (N / 4);
    fma_tile<N / 4, kUnroll>(acc,
                    [&](int a, int k) { return sm.Bs[(qy + 8 * a) * LN + k0 + k]; },
                    [&](int b, int k) { return sm.Cs[(qx + 8 * b) * LN + k0 + k]; });
    for (int q = 0; q < 4; ++q) {
      if (quarter == q)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            float* c = &sm.CBT[(qy + 8 * a) * LQ + qx + 8 * b];
            *c = q == 0 ? acc[a][b] : *c + acc[a][b];
          }
      __syncthreads();
    }
  }
  for (int e = tid; e < kQ * LQ; e += kBwdThreads) {
    sm.DMT[e] = 0.f;
    if constexpr (N == 64) sm.DBs[e] = sm.DCs[e] = 0.f;
  }
  // the slice's dB (team 0) or dC (team 1): at N = 128 in registers; at
  // 64 in shared memory, where a team's two quarters (each over half of
  // every product's K) add their tiles in quarter order (a thread holding
  // its sums and another product's tile would spill there)
  float acc_g[8][8];
  zero(acc_g);
  auto gather = [&](const float (&v)[8][8]) {   // N = 64 only
    {
      float* tile = team ? sm.DCs : sm.DBs;
      for (int q = 0; q < 2; ++q) {
        if (thalf == q)
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b)
              tile[(ty + 8 * a) * LQ + col(b)] += v[a][b];
        team_sync(team);
      }
    }
  };
  for (int hi = 0; hi < hs; ++hi) {
    const int h = h0 + hi;
    const float* xr = x + (at.row0 * H + h) * P;
    const float* gr = dy + (at.row0 * H + h) * P;
    stage_rows<float, kQ, P, LP, kBwdThreads>(sm.Xs, at.rows, tid, [&](int r) {
      return xr + static_cast<size_t>(r) * H * P;
    });
    stage_rows<float, kQ, P, LP, kBwdThreads>(sm.dYs, at.rows, tid, [&](int r) {
      return gr + static_cast<size_t>(r) * H * P;
    });
    if (warp == 0) {
      const float* dr = dt + at.row0 * H + h;
      const int i0 = 2 * lane;
      const float total = chunk_scalars(
          i0 < at.rows ? dr[static_cast<size_t>(i0) * H] : 0.f,
          i0 + 1 < at.rows ? dr[static_cast<size_t>(i0 + 1) * H] : 0.f,
          A[h], lane, sm.cum, sm.dts, sm.wts, sm.ecum);
      if (lane == 0) sm.total = total;
    }
    __syncthreads();
    // M^T [j][i] = (C B^T)^T exp(cum_i - cum_j) for i >= j, else 0
    for (int e = tid; e < kQ * kQ; e += kBwdThreads) {
      const int j = e / kQ, i = e % kQ;
      sm.MT[j * LQ + i] =
          i >= j ? sm.CBT[j * LQ + i] * expf(sm.cum[i] - sm.cum[j]) : 0.f;
    }
    __syncthreads();
    if (quarter == 0) {
      // dscores^T [j][i] = x_j . dy_i; dM^T gathered; t = dscores M:
      // csum_j = sum_i t, rsum_i = sum_j t dt_j
      float acc[8][8];
      zero(acc);
      fma_tile<P, kUnroll>(acc, [&](int a, int k) { return sm.Xs[(qy + 8 * a) * LP + k]; },
                  [&](int b, int k) { return sm.dYs[(qx + 8 * b) * LP + k]; });
      float rp[8] = {};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int j = qy + 8 * a;
        const float dtj = sm.dts[j], cj = sm.cum[j];
        float cp = 0.f;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = qx + 8 * b;
          if (i >= j) {
            const float l = expf(sm.cum[i] - cj);
            const float t = acc[a][b] * sm.MT[j * LQ + i];
            sm.DMT[j * LQ + i] = fmaf(acc[a][b] * l, dtj, sm.DMT[j * LQ + i]);
            cp += t;
            rp[b] = fmaf(t, dtj, rp[b]);
          }
        }
        sm.part[0][j * 17 + qx] = cp;
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) sm.part[1][(qx + 8 * b) * 17 + qy] = rp[b];
    } else if (quarter == 1) {
      // DX [j][p] = dt_j sum_{i >= j} M^T_ji dy_ip + D dy_jp
      float acc[8][8];
      zero(acc);
      fma_tile_v<kQ, 32, kUnroll>(
          acc, [&](int a, int k) { return sm.MT[(qy + 8 * a) * LQ + k]; },
          [&](int k) { return &sm.dYs[k * LP]; }, 4 * qx);
      const float dskip = D[h];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int j = qy + 8 * a;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int p = 4 * qx + (b & 3) + (b >> 2) * 32;
          sm.DX[j * LP + p] = fmaf(sm.dts[j], acc[a][b],
                                   dskip * sm.dYs[j * LP + p]);
        }
      }
    } else {
      // team 1: E_c (grid 2 has finished), then dC's inter-chunk term
      // [i][n] = exp(cum_i) sum_p dy_ip E_pn and its dot with C_i
      griddep_wait();
      const float* es = states + (static_cast<size_t>(at.bc) * H + h) * P * N;
      // a quarter of the rows at a time: fewer loads in registers beside
      // the slice's sums
#pragma unroll
      for (int r0 = 0; r0 < P; r0 += P / 4)
        stage_rows<float, P / 4, N, LN, 128>(
            sm.ESs + r0 * LN, P / 4, lt,
            [&](int r) { return es + static_cast<size_t>(r0 + r) * N; });
      team_sync(1);
      float acc[8][8];
      zero(acc);
      const int k0 = thalf * (P / 2);
      fma_tile_v<N == 128 ? P : P / 2, N / 2, kUnroll>(
          acc, [&](int a, int k) { return sm.dYs[(ty + 8 * a) * LP + k0 + k]; },
          [&](int k) { return &sm.ESs[(k0 + k) * LN]; }, 4 * tx);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + 8 * a;
        const float ei = sm.ecum[i];
        float ip = 0.f;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float v = ei * acc[a][b];
          if constexpr (N == 128) acc_g[a][b] += v;
          else acc[a][b] = v;
          ip = fmaf(sm.Cs[i * LN + col(b)], v, ip);
        }
        sm.part[3][i * 17 + tx + 8 * thalf] = ip;
      }
      if constexpr (N == 64) gather(acc);
    }
    __syncthreads();
    // dS_c over E_c in place, <E_c, dS_c> and <dy, x> in fp32
    griddep_wait();
    {
      const float4* s4 = reinterpret_cast<const float4*>(
          dstates + (static_cast<size_t>(at.bc) * H + h) * P * N);
      float es = 0.f, dd = 0.f;
      // four loads in flight before the first is used
      constexpr int kPer = P * N / 4 / kBwdThreads, kBatch = 4;
#pragma unroll
      for (int q0 = 0; q0 < kPer; q0 += kBatch) {
        float4 sv[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          sv[q] = s4[tid + (q0 + q) * kBwdThreads];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int k = tid + (q0 + q) * kBwdThreads;
        const int p = k / (N / 4), n = (k % (N / 4)) * 4;
          float* row = &sm.ESs[p * LN + n];
          es = fmaf(row[0], sv[q].x, fmaf(row[1], sv[q].y, fmaf(
              row[2], sv[q].z, fmaf(row[3], sv[q].w, es))));
          row[0] = sv[q].x;
          row[1] = sv[q].y;
          row[2] = sv[q].z;
          row[3] = sv[q].w;
        }
      }
      for (int k = tid; k < kQ * P; k += kBwdThreads)
        dd = fmaf(sm.Xs[(k / P) * LP + k % P], sm.dYs[(k / P) * LP + k % P],
                  dd);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        es += __shfl_xor_sync(0xffffffffu, es, off);
        dd += __shfl_xor_sync(0xffffffffu, dd, off);
      }
      if (lane == 0) {
        sm.red[0][warp] = es;
        sm.red[1][warp] = dd;
      }
    }
    __syncthreads();
    if (team == 0) {
      // dB's chunk-state term [j][n] = sum_p (w_j x_jp) dS_pn, into the
      // slice's sums
      const int k0 = thalf * (P / 2);
      auto wx = [&](int a, int k) {
        return sm.wts[ty + 8 * a] * sm.Xs[(ty + 8 * a) * LP + k0 + k];
      };
      auto ds = [&](int k) { return &sm.ESs[(k0 + k) * LN]; };
      if constexpr (N == 128) {
        fma_tile_v<P, N / 2, kUnroll>(acc_g, wx, ds, 4 * tx);
      } else {
        float acc[8][8];
        zero(acc);
        fma_tile_v<P / 2, N / 2, kUnroll>(acc, wx, ds, 4 * tx);
        gather(acc);
      }
    } else {
      // dx's chunk-state term [j][p] = sum_n B_jn dS_pn, quarter 2 over
      // the first half of n and 3 over the second, added through MT's
      // tile; then dx out and dw_j = x_j . (dS_c B_j)
      float acc[8][8];
      zero(acc);
      const int k0 = (quarter - 2) * (N / 2);
      fma_tile<N / 2, kUnroll>(acc,
                      [&](int a, int k) { return sm.Bs[(qy + 8 * a) * LN + k0 + k]; },
                      [&](int b, int k) { return sm.ESs[(qx + 8 * b) * LN + k0 + k]; });
      if (quarter == 3)
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b)
            sm.MT[(qy + 8 * a) * LQ + qx + 8 * b] = acc[a][b];
      team_sync(1);
      if (quarter == 2) {
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int j = qy + 8 * a;
          const float wj = sm.wts[j];
          float dwp = 0.f;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int p = qx + 8 * b;
            const float sb = acc[a][b] + sm.MT[j * LQ + p];
            dwp = fmaf(sm.Xs[j * LP + p], sb, dwp);
            if (j < at.rows)
              dx[((at.row0 + j) * H + h) * P + p] =
                  fmaf(wj, sb, sm.DX[j * LP + p]);
          }
          sm.part[2][j * 17 + qx] = dwp;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      HeadSums s{nullptr, nullptr, nullptr, nullptr, sm.cum, sm.dts, sm.wts,
                 sm.total, 0.f, 0.f};
      float* sums = sm.MT;        // four rows of kQ: rsum, csum, dw, inter
      for (int i = lane; i < kQ; i += 32) {
        sums[i] = row_sum(sm.part[1], i, 8);
        sums[kQ + i] = row_sum(sm.part[0], i, 8);
        sums[2 * kQ + i] = row_sum(sm.part[2], i, 8);
        sums[3 * kQ + i] = row_sum(sm.part[3], i, 16);
      }
      __syncwarp();
      s.rsum = sums;
      s.csum = sums + kQ;
      s.dw = sums + 2 * kQ;
      s.inter = sums + 3 * kQ;
#pragma unroll
      for (int w = 0; w < kBwdThreads / 32; ++w) {
        s.es += sm.red[0][w];
        s.dd += sm.red[1][w];
      }
      head_tail(s, A[h], lane, at.rows, at.row0, H, h,
                static_cast<size_t>(at.bc) * H + h, ddt, dA_part, dD_part);
    }
    __syncthreads();
  }
  // the intra-chunk terms, once: team 0 dB [j][n] += sum_{i >= j} dM^T_ji
  // C_in, team 1 dC [i][n] += sum_{j <= i} dM^T_ji B_jn
  {
    const int k0 = thalf * (kQ / 2);
    constexpr int kK = N == 128 ? kQ : kQ / 2;
    float acc[8][8];
    zero(acc);
    float (&into)[8][8] = N == 128 ? acc_g : acc;
    if (team == 0)
      fma_tile_v<kK, N / 2, kUnroll>(
          into, [&](int a, int k) { return sm.DMT[(ty + 8 * a) * LQ + k0 + k]; },
          [&](int k) { return &sm.Cs[(k0 + k) * LN]; }, 4 * tx);
    else
      fma_tile_v<kK, N / 2, kUnroll>(
          into, [&](int a, int k) { return sm.DMT[(k0 + k) * LQ + ty + 8 * a]; },
          [&](int k) { return &sm.Bs[(k0 + k) * LN]; }, 4 * tx);
    if constexpr (N == 64) {
      gather(acc);
      const float* tile = team ? sm.DCs : sm.DBs;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          acc_g[a][b] = tile[(ty + 8 * a) * LQ + col(b)];
      if (thalf == 1) return;   // the first quarter of each team stores
    }
  }
  float* out = splits == 1 ? (team ? dC : dB) : (team ? dCp : dBp);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = ty + 8 * a;
    if (r >= at.rows) continue;
    const size_t row = ((at.row0 + r) * G + g) * (splits == 1 ? 1 : splits)
                       + (splits == 1 ? 0 : slice);
#pragma unroll
    for (int b = 0; b < 8; ++b) out[row * N + col(b)] = acc_g[a][b];
  }
}

// ------------------------------------------------------------- 3. sums
// Blocks below `sum_blocks`: dB and dC (B, T, G, N) in x's dtype, each the
// sum of its k head-slice partials (B, T, G, k, N), in slice order; the
// rest: dA[h], dD[h], the sums over (batch, chunk) of the chunks' terms.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_sums(const float* __restrict__ dBp, const float* __restrict__ dCp,
                 T* __restrict__ dB, T* __restrict__ dC, size_t n_out,
                 int splits, int N, const float* __restrict__ dA_part,
                 const float* __restrict__ dD_part, float* __restrict__ dA,
                 float* __restrict__ dD, int n_bc, int H, int sum_blocks) {
  griddep_wait();
  if (static_cast<int>(blockIdx.x) < sum_blocks) {
    for (size_t o = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         o < n_out; o += static_cast<size_t>(sum_blocks) * blockDim.x) {
      const size_t base = (o / N) * splits * N + o % N;
      float sb = 0.f, sc = 0.f;
      for (int k = 0; k < splits; ++k) {
        sb += dBp[base + static_cast<size_t>(k) * N];
        sc += dCp[base + static_cast<size_t>(k) * N];
      }
      dB[o] = from_float<T>(sb);
      dC[o] = from_float<T>(sc);
    }
    return;
  }
  const int h = (blockIdx.x - sum_blocks) * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int k = 0; k < n_bc; ++k) {
    sa += dA_part[static_cast<size_t>(k) * H + h];
    sd += dD_part[static_cast<size_t>(k) * H + h];
  }
  dA[h] = sa;
  dD[h] = sd;
}

// scratch (fp32): the entering states (B, nC, H, P, N), the state
// gradients (B, nC, H, P, N), the dA and dD terms (B, nC, H) each, then,
// with splits > 1, the head-slice partials of dB and dC (B, T, G,
// splits, N) each
template <typename T, int P, int N>
int launch_bwd(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, const float* D,
               const void* dy, const float* dfinal, void* dx, float* ddt,
               float* dA, void* dB, void* dC, float* dD, float* scratch,
               int B, int T_, int H, int G, int splits, cudaStream_t s) {
  const int nC = (T_ + kQ - 1) / kQ;
  if (static_cast<long long>(B) * nC > 65535 || H > 65535 ||
      static_cast<long long>(B) * H > 65535 || splits <= 0 ||
      (H / G) % splits != 0)
    return kBadArgument;
  const size_t n_state = static_cast<size_t>(B) * nC * H * P * N;
  const size_t n_bch = static_cast<size_t>(B) * nC * H;
  float* states = scratch;
  float* dstates = states + n_state;
  float* dA_part = dstates + n_state;
  float* dD_part = dA_part + n_bch;
  float* dBp = dD_part + n_bch;
  float* dCp = dBp + static_cast<size_t>(B) * T_ * G * splits * N;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  const auto* gt = static_cast<const T*>(dy);
  const size_t n_out = static_cast<size_t>(B) * T_ * G * N;
  const int sum_blocks =
      splits > 1
          ? static_cast<int>(std::min<size_t>((n_out + 255) / 256, 4096))
          : 0;
  const int head_blocks = (H + 255) / 256;
  cudaError_t rc = cudaSuccess;
  if (nC > 0 && B > 0) {
    using PS = PassShape<T, P, N>;
    constexpr int kPassBytes = static_cast<int>(sizeof(BwdPassSmem<T, P, N>));
    constexpr int kChunkBytes = static_cast<int>(
        kBf16 ? sizeof(BwdChunkSmemB<N>) : sizeof(BwdChunkSmemF<P, N>));
    // once per instantiation (and process): allow more than 48 KB
    static const cudaError_t a1 = cudaFuncSetAttribute(
        ssd_bwd_pass<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPassBytes);
    if (a1 != cudaSuccess) return static_cast<int>(a1);
    ssd_bwd_pass<T, P, N><<<dim3(P / PS::kPS, B * H), PS::kThreads,
                            kPassBytes, s>>>(xt, dt, A, bt, ct, gt, dfinal,
                                             states, dstates, T_, H, G, nC);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    auto run_chunk = [&](auto kernel) {
      static const cudaError_t a2 = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkBytes);
      if (a2 != cudaSuccess) return a2;
      return launch_dependent(
          kernel, dim3(G * splits, B * nC), dim3(kBwdThreads), kChunkBytes, s,
          xt, dt, A, bt, ct, D, gt, static_cast<const float*>(states),
          static_cast<const float*>(dstates), static_cast<T*>(dx), ddt,
          static_cast<T*>(dB), static_cast<T*>(dC), dBp, dCp, dA_part,
          dD_part, T_, H, G, nC, splits);
    };
    if constexpr (kBf16)
      rc = run_chunk(ssd_bwd_chunk_mma<P, N>);
    else
      rc = run_chunk(ssd_bwd_chunk_fma<P, N>);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // with no chunk, dA and dD are zeros
  rc = launch_dependent(ssd_bwd_sums<T>, dim3(sum_blocks + head_blocks),
                        dim3(256), 0, s, static_cast<const float*>(dBp),
                        static_cast<const float*>(dCp), static_cast<T*>(dB),
                        static_cast<T*>(dC), n_out, splits, N,
                        static_cast<const float*>(dA_part),
                        static_cast<const float*>(dD_part), dA, dD,
                        nC > 0 ? B * nC : 0, H, sum_blocks);
  return static_cast<int>(rc);
}

template <typename T>
int dispatch_bwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D,
                 const void* dy, const float* dfinal, void* dx, float* ddt,
                 float* dA, void* dB, void* dC, float* dD, float* scratch,
                 int B, int T_, int H, int G, int P, int N, int splits,
                 cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch_bwd<T, 64, 128>(x, dt, A, Bm, Cm, D, dy, dfinal, dx, ddt,
                                  dA, dB, dC, dD, scratch, B, T_, H, G,
                                  splits, s);
  if (P == 64 && N == 64)
    return launch_bwd<T, 64, 64>(x, dt, A, Bm, Cm, D, dy, dfinal, dx, ddt,
                                 dA, dB, dC, dD, scratch, B, T_, H, G,
                                 splits, s);
  return kBadArgument;
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, void* y, float* final_state,
             float* scratch, int B, int T_, int H, int G, int P, int N,
             cudaStream_t s) {
  // the ported configs' (head_dim, state_dim): mamba2-370m's, zamba2-1.2b's;
  // add an instantiation when another config needs one
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, Bm, Cm, D, y, final_state, scratch,
                              B, T_, H, G, s);
  if (P == 64 && N == 64)
    return launch<T, 64, 64>(x, dt, A, Bm, Cm, D, y, final_state, scratch,
                             B, T_, H, G, s);
  return kBadArgument;
}

}  // namespace
}  // namespace repro

// x, y: (B, T, H, P); dt: (B, T, H) fp32; A, D: (H,) fp32; Bm, Cm:
// (B, T, G, N) of x's dtype; final_state: (B, H, P, N) fp32 or null;
// scratch: fp32 of B * nC * H * (P * N + 1) floats, nC = ceil(T / 64),
// its contents on entry unused. All contiguous and 16-byte aligned;
// H % G == 0; (P, N) is (64, 128) or (64, 64).
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt,
                              const void* A, const void* Bm, const void* Cm,
                              const void* D, void* y, void* final_state,
                              void* scratch, int B, int T_, int H, int G,
                              int P, int N, void* stream) {
  using namespace repro;
  if (B <= 0 || H <= 0) return 0;
  if (T_ < 0 || G <= 0 || H % G != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Df = static_cast<const float*>(D);
  auto* fs = static_cast<float*>(final_state);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return dispatch<float>(x, dtf, Af, Bm, Cm, Df, y, fs, sc, B, T_, H, G,
                           P, N, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, y, fs, sc, B, T_,
                                   H, G, P, N, s);
  return kBadArgument;
}

// The gradient of repro_ssd_scan's y for dy and of its final state for
// dfinal ((B, H, P, N) fp32, or null: no gradient there): x, dy, dx:
// (B, T, H, P); dt, ddt: (B, T, H) fp32; A, D, dA, dD: (H,) fp32; Bm, Cm,
// dB, dC: (B, T, G, N) of x's dtype; splits: the head-slices k a group's
// heads are cut into (it divides H / G; kernels/ssd_scan.py
// `backward_head_splits`); scratch: fp32 of B * nC * H * (2 * P * N + 3)
// floats, and 2 * B * T * G * splits * N more when splits > 1, its
// contents on entry unused. All contiguous, x, dy, B, C and dfinal
// 16-byte aligned; H % G == 0; (P, N) is (64, 128) or (64, 64).
extern "C" int repro_ssd_scan_backward(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
    void* scratch, int B, int T_, int H, int G, int P, int N, int splits,
    void* stream) {
  using namespace repro;
  if (H <= 0) return 0;
  if (B < 0 || T_ < 0 || G <= 0 || H % G != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Df = static_cast<const float*>(D);
  const auto* dff = static_cast<const float*>(dfinal);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dAf = static_cast<float*>(dA);
  auto* dDf = static_cast<float*>(dD);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return dispatch_bwd<float>(x, dtf, Af, Bm, Cm, Df, dy, dff, dx, ddtf, dAf,
                               dB, dC, dDf, sc, B, T_, H, G, P, N, splits, s);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, dy, dff, dx,
                                       ddtf, dAf, dB, dC, dDf, sc, B, T_, H,
                                       G, P, N, splits, s);
  return kBadArgument;
}
