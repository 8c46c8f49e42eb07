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
// file: the forward's first two grids again, then five grids of its own.
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
// The gradient of the scan above for dy (no TPU counterpart: the JAX
// package differentiates its XLA reference `ssd_chunked`, and its Pallas
// kernel has no custom_vjp). kernels/ssd_scan.py
// `ssd_scan_backward_plain` is its plain version, term by term. Per
// (batch, head, chunk c), with E_c the state entering the chunk, w_j =
// dt_j exp(total - cum_j) and the final state carrying no gradient:
//   dE_c = sum_i exp(cum_i) dy_i C_i^T                   (ssd_bwd_state_grad)
//   G = 0; for c down: dS_c = G, G = dE_c + exp(total_c) G (ssd_bwd_state_pass)
//   then, chunk by chunk                                  (ssd_bwd_chunk)
//   dx_j = D dy_j + w_j dS_c B_j + sum_{i>=j} scores_ij dy_i
//   dB_j = w_j dS_c^T x_j + sum_i dM_ij C_i,  dC_i = exp(cum_i) E_c^T dy_i
//          + sum_j dM_ij B_j, with dM_ij = (dy_i . x_j) L_ij dt_j (j <= i)
//   dcum from the intra-chunk, inter-chunk and chunk-state terms, the
//   chunk's dtotal (sum_j dw_j w_j + exp(total) <E_c, dS_c>) on its last
//   row, reverse-summed into da: ddt = (intra and w terms) + A da, and
//   per-chunk partial sums of dA (da . dt) and dD (dy . x)
// and two fixed-order sums: dB and dC over each group's heads
// (ssd_bwd_group_sum), dA and dD over (batch, chunk) (ssd_bwd_head_sum).
// E_c is recomputed by the forward's first two grids into the scratch
// rather than kept from the forward: kept, it would cost B nC H P N fp32
// a layer for the whole backward of a model (134 MB a layer for mamba2 at
// 8 x 1024, 6.4 GB over its 48 layers). No atomics: every output element
// and partial sum has one writer and a fixed order, so results do not
// depend on the run. Rows past T are staged as zeros with dt = 0; their
// gradients are not stored.
//
// What bounds it: at mamba2's training shape (B 8, T 1024, 32 heads, P 64,
// N 128) a call does ~30 GFLOP of products (dE, C B^T, dy x^T, two for dx,
// two each for dB and dC, and the recomputed states) against ~0.2 GB of
// inputs and outputs in fp32, so operations. This first version runs
// every product on fp32 FMAs from shared memory (bf16 inputs are widened
// as they are staged), one block of 256 threads per (head, batch x
// chunk), each thread a 4 x 4 (4 x N/16) interleaved sub-tile (rows
// ty + 16a, columns tx + 16b); the shared-memory reads bound it well below
// the FMA peak. Tensor cores are later work.
constexpr int kBwdThreads = 256;   // 16 x 16 threads

// Stage ROWS rows of W elements of T (widened to fp32) into shared memory
// with row stride LD; rows at or past n_rows are zeros. `src(r)` points at
// row r (16-byte aligned). All loads are issued before any is stored.
template <typename T, int ROWS, int W, int LD, class Src>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows, Src src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  static_assert(W % kVec == 0 && (ROWS * kPerRow) % kBwdThreads == 0,
                "rows split over the block");
  constexpr int kIters = ROWS * kPerRow / kBwdThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kBwdThreads;
    const int r = idx / kPerRow;
    buf[k] = r < n_rows
                 ? reinterpret_cast<const uint4*>(src(r))[idx % kPerRow]
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int idx = threadIdx.x + k * kBwdThreads;
    const T* e = reinterpret_cast<const T*>(&buf[k]);
    float* row = dst + (idx / kPerRow) * LD + (idx % kPerRow) * kVec;
#pragma unroll
    for (int v = 0; v < kVec; ++v) row[v] = to_float(e[v]);
  }
}

// Where a backward block's chunk lies: blockIdx = (head, b * nC + c).
struct BwdPos {
  int h, b, c, bc, rows, g;
  size_t row0;   // sequence row (b * T + c * kQ) of the chunk's first row

  __device__ __forceinline__ BwdPos(int T_, int H, int G, int nC) {
    h = blockIdx.x;
    bc = blockIdx.y;
    b = bc / nC;
    c = bc % nC;
    rows = min(kQ, T_ - c * kQ);
    g = h / (H / G);
    row0 = static_cast<size_t>(b) * T_ + static_cast<size_t>(c) * kQ;
  }
};

template <int P, int N>
struct BwdStateSmem {
  float dYs[kQ * (P + 1)];
  float Cs[kQ * (N + 1)];
  float cum[kQ], dts[kQ], ecum[kQ];
};

// dE_c[p][n] = sum_i exp(cum_i) dy_i[p] C_i[n] into `dstates` (B, nC, H,
// P, N); thread (ty, tx) owns p = ty + 16a, n = tx + 16b.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_state_grad(const T* __restrict__ dy, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Cm,
                       float* __restrict__ dstates, int T_, int H, int G,
                       int nC) {
  static_assert(P == 64 && N % 16 == 0, "thread tiles");
  constexpr int LP = P + 1, LN = N + 1, kNB = N / 16;
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<BwdStateSmem<P, N>*>(smem4);
  const BwdPos at(T_, H, G, nC);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  stage_rows<T, kQ, P, LP>(sm.dYs, at.rows, [&](int r) {
    return dy + ((at.row0 + r) * H + at.h) * P;
  });
  stage_rows<T, kQ, N, LN>(sm.Cs, at.rows, [&](int r) {
    return Cm + ((at.row0 + r) * G + at.g) * N;
  });
  if (tid < 32) {
    chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows, A[at.h], tid, sm.cum,
                 sm.dts, nullptr);
    sm.ecum[2 * tid] = expf(sm.cum[2 * tid]);
    sm.ecum[2 * tid + 1] = expf(sm.cum[2 * tid + 1]);
  }
  __syncthreads();
  float acc[4][kNB] = {};
#pragma unroll 4
  for (int i = 0; i < kQ; ++i) {
    const float e = sm.ecum[i];
    float gv[4], cv[kNB];
#pragma unroll
    for (int a = 0; a < 4; ++a) gv[a] = sm.dYs[i * LP + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < kNB; ++b) cv[b] = e * sm.Cs[i * LN + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kNB; ++b) acc[a][b] = fmaf(gv[a], cv[b], acc[a][b]);
  }
  float* out = dstates + (static_cast<size_t>(at.bc) * H + at.h) * P * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < kNB; ++b)
      out[(ty + 16 * a) * N + tx + 16 * b] = acc[a][b];
}

// The reverse state pass, in place: slot c holds dE_c on entry and dS_c
// (the gradient of the state leaving chunk c) on exit. Grid (P * N / 4 /
// kPassThreads, B * H), 4 state elements a thread, as ssd_state_pass.
template <int P, int N>
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_state_pass(float* __restrict__ dstates,
                       const float* __restrict__ decay, int H, int nC) {
  constexpr int kVecs = P * N / 4;
  static_assert(kVecs % kPassThreads == 0, "state splits over the blocks");
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nC - 1; c >= 0; --c) {
    float4* slot = reinterpret_cast<float4*>(dstates)
                   + ((static_cast<size_t>(b) * nC + c) * H + h) * kVecs + e;
    const float4 de = *slot;
    const float d = decay[(static_cast<size_t>(b) * nC + c) * H + h];
    *slot = run;
    run.x = de.x + d * run.x;
    run.y = de.y + d * run.y;
    run.z = de.z + d * run.z;
    run.w = de.w + d * run.w;
  }
}

template <int P, int N>
struct BwdChunkSmem {
  float Xs[kQ * (P + 1)];
  float dYs[kQ * (P + 1)];
  float Bs[kQ * (N + 1)];
  float Cs[kQ * (N + 1)];
  float Es[P * (N + 1)];      // E_c (zeros for the first chunk)
  float dSs[P * (N + 1)];     // dS_c
  float Ms[kQ * (kQ + 1)];    // scores_ij (0 above the diagonal)
  float Gs[kQ * (kQ + 1)];    // dM_ij = dscores_ij L_ij dt_j (likewise)
  float part[2][kQ * 17];     // per-thread partial sums of a row / column
  float cum[kQ], dts[kQ], wts[kQ], ecum[kQ];
  float rsum[kQ], csum[kQ], dw[kQ], inter[kQ];
  float red[2][kBwdThreads / 32];
  float total;
};

// sum over the 16 partials of row r of `part` (rows of 17), in order
__device__ __forceinline__ float row_of_partials(const float* part, int r) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) s += part[r * 17 + q];
  return s;
}

// One chunk's gradients (see the note above); grid (H, B * nC).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  const T* __restrict__ dy, const float* __restrict__ states,
                  const float* __restrict__ dstates, T* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dBh,
                  float* __restrict__ dCh, float* __restrict__ dA_part,
                  float* __restrict__ dD_part, int T_, int H, int G,
                  int nC) {
  static_assert(P == kQ && N % 16 == 0, "thread tiles");
  constexpr int LP = P + 1, LN = N + 1, LQ = kQ + 1, kNB = N / 16;
  extern __shared__ float4 smem4[];
  auto& sm = *reinterpret_cast<BwdChunkSmem<P, N>*>(smem4);
  const BwdPos at(T_, H, G, nC);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  stage_rows<T, kQ, P, LP>(sm.Xs, at.rows, [&](int r) {
    return x + ((at.row0 + r) * H + at.h) * P;
  });
  stage_rows<T, kQ, P, LP>(sm.dYs, at.rows, [&](int r) {
    return dy + ((at.row0 + r) * H + at.h) * P;
  });
  stage_rows<T, kQ, N, LN>(sm.Bs, at.rows, [&](int r) {
    return Bm + ((at.row0 + r) * G + at.g) * N;
  });
  stage_rows<T, kQ, N, LN>(sm.Cs, at.rows, [&](int r) {
    return Cm + ((at.row0 + r) * G + at.g) * N;
  });
  const size_t st = (static_cast<size_t>(at.bc) * H + at.h) * P * N;
  // slot 0 of the recomputed states still holds S_0: E_0 = 0
  stage_rows<float, P, N, LN>(sm.Es, at.c > 0 ? P : 0,
                              [&](int r) { return states + st + r * N; });
  stage_rows<float, P, N, LN>(sm.dSs, P,
                              [&](int r) { return dstates + st + r * N; });
  if (tid < 32) {
    const float total = chunk_cumsum(dt + at.row0 * H + at.h, H, at.rows,
                                     A[at.h], tid, sm.cum, sm.dts, sm.wts);
    sm.ecum[2 * tid] = expf(sm.cum[2 * tid]);
    sm.ecum[2 * tid + 1] = expf(sm.cum[2 * tid + 1]);
    if (tid == 0) sm.total = total;
  }
  __syncthreads();

  // 1. C B^T and dy x^T over (i = ty + 16a, j = tx + 16b): the masked
  // scores and dM, and the row and column sums of t_ij = dscores_ij M_ij
  // (M_ij = C_i.B_j L_ij): dcum_i += sum_j t_ij dt_j, ddt_j += sum_i t_ij
  {
    float cb[4][4] = {}, ds[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Cs[(ty + 16 * a) * LN + k];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sm.Bs[(tx + 16 * b) * LN + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) cb[a][b] = fmaf(av[a], bv[b], cb[a][b]);
    }
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.dYs[(ty + 16 * a) * LP + k];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sm.Xs[(tx + 16 * b) * LP + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) ds[a][b] = fmaf(av[a], bv[b], ds[a][b]);
    }
    float rpart[4] = {}, cpart[4] = {};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tx + 16 * b;
        float s = 0.f, gm = 0.f;
        // the exponent only where j <= i (above, it can overflow)
        if (j <= i) {
          const float l = expf(sm.cum[i] - sm.cum[j]);
          const float m = cb[a][b] * l, dtj = sm.dts[j];
          const float t = ds[a][b] * m;
          s = m * dtj;
          gm = ds[a][b] * l * dtj;
          rpart[a] = fmaf(t, dtj, rpart[a]);
          cpart[b] += t;
        }
        sm.Ms[i * LQ + j] = s;
        sm.Gs[i * LQ + j] = gm;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) sm.part[0][(ty + 16 * a) * 17 + tx] = rpart[a];
#pragma unroll
    for (int b = 0; b < 4; ++b) sm.part[1][(tx + 16 * b) * 17 + ty] = cpart[b];
  }
  __syncthreads();
  if (tid < kQ) {
    sm.rsum[tid] = row_of_partials(sm.part[0], tid);
    sm.csum[tid] = row_of_partials(sm.part[1], tid);
  }
  __syncthreads();

  // 2. dx over (j = ty + 16a, p = tx + 16b): scores^T dy, and dS_c B_j,
  // whose product with x_j is dw_j
  {
    float acc[4][4] = {}, sb[4][4] = {};
#pragma unroll 4
    for (int i = 0; i < kQ; ++i) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Ms[i * LQ + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sm.dYs[i * LP + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Bs[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sm.dSs[(tx + 16 * b) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sb[a][b] = fmaf(av[a], bv[b], sb[a][b]);
    }
    const float dskip = D[at.h];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = ty + 16 * a;
      const float wj = sm.wts[j];
      float dwp = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = tx + 16 * b;
        dwp = fmaf(sm.Xs[j * LP + p], sb[a][b], dwp);
        if (j < at.rows)
          dx[((at.row0 + j) * H + at.h) * P + p] = from_float<T>(
              acc[a][b] + wj * sb[a][b] + dskip * sm.dYs[j * LP + p]);
      }
      sm.part[0][j * 17 + tx] = dwp;
    }
  }
  __syncthreads();
  if (tid < kQ) sm.dw[tid] = row_of_partials(sm.part[0], tid);
  __syncthreads();

  // 3. dB over (j = ty + 16a, n = tx + 16b): w_j (x_j^T dS_c) + dM^T C;
  // then dC over (i, n): exp(cum_i) (dy_i^T E_c) + dM B, whose first term
  // with C_i is dy_i . y_inter_i
  float* dBrow = dBh + (at.row0 * H + at.h) * N;
  float* dCrow = dCh + (at.row0 * H + at.h) * N;
  {
    float acc[4][kNB] = {};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float av[4], bv[kNB];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Xs[(ty + 16 * a) * LP + p];
#pragma unroll
      for (int b = 0; b < kNB; ++b) bv[b] = sm.dSs[p * LN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kNB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kNB; ++b) acc[a][b] *= sm.wts[ty + 16 * a];
#pragma unroll 4
    for (int i = 0; i < kQ; ++i) {
      float av[4], bv[kNB];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Gs[i * LQ + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < kNB; ++b) bv[b] = sm.Cs[i * LN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kNB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = ty + 16 * a;
      if (j >= at.rows) continue;
#pragma unroll
      for (int b = 0; b < kNB; ++b)
        dBrow[static_cast<size_t>(j) * H * N + tx + 16 * b] = acc[a][b];
    }
  }
  {
    float acc[4][kNB] = {};
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      float av[4], bv[kNB];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.dYs[(ty + 16 * a) * LP + p];
#pragma unroll
      for (int b = 0; b < kNB; ++b) bv[b] = sm.Es[p * LN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kNB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const float e = sm.ecum[i];
      float ip = 0.f;
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
        acc[a][b] *= e;
        ip = fmaf(sm.Cs[i * LN + tx + 16 * b], acc[a][b], ip);
      }
      sm.part[0][i * 17 + tx] = ip;
    }
#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      float av[4], bv[kNB];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.Gs[(ty + 16 * a) * LQ + j];
#pragma unroll
      for (int b = 0; b < kNB; ++b) bv[b] = sm.Bs[j * LN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kNB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      if (i >= at.rows) continue;
#pragma unroll
      for (int b = 0; b < kNB; ++b)
        dCrow[static_cast<size_t>(i) * H * N + tx + 16 * b] = acc[a][b];
    }
  }
  // <E_c, dS_c> and <dy, x> over the chunk, each thread over fixed
  // elements, then the warps in order
  {
    float es = 0.f, dd = 0.f;
    for (int e = tid; e < P * N; e += kBwdThreads) {
      const int at_e = (e / N) * LN + e % N;
      es = fmaf(sm.Es[at_e], sm.dSs[at_e], es);
    }
    for (int e = tid; e < kQ * P; e += kBwdThreads) {
      const int at_e = (e / P) * LP + e % P;
      dd = fmaf(sm.dYs[at_e], sm.Xs[at_e], dd);
    }
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
  if (tid < kQ) sm.inter[tid] = row_of_partials(sm.part[0], tid);
  __syncthreads();

  // 4. one warp, two rows a lane: dcum, dtotal on the last row, the
  // reverse cumsum into da, ddt, and the chunk's dA and dD terms
  if (warp == 0) {
    float es = 0.f, dd = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      es += sm.red[0][w];
      dd += sm.red[1][w];
    }
    const int i0 = 2 * lane, i1 = i0 + 1;
    float dcum[2], wdw = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = i0 + k;
      const float dwi = sm.dw[i] * sm.wts[i];
      wdw += dwi;
      dcum[k] = sm.rsum[i] + sm.inter[i] - sm.dts[i] * sm.csum[i] - dwi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      wdw += __shfl_xor_sync(0xffffffffu, wdw, off);
    const float total = sm.total;
    if (i1 == kQ - 1) dcum[1] += wdw + expf(total) * es;
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
    const float a = A[at.h];
    float da_dt = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = i0 + k;
      da_dt = fmaf(da[k], sm.dts[i], da_dt);
      if (i < at.rows)
        ddt[(at.row0 + i) * H + at.h] =
            sm.csum[i] + sm.dw[i] * expf(total - sm.cum[i]) + a * da[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
    if (lane == 0) {
      dA_part[static_cast<size_t>(at.bc) * H + at.h] = da_dt;
      dD_part[static_cast<size_t>(at.bc) * H + at.h] = dd;
    }
  }
}

// dB, dC (B, T, G, N) in x's dtype: each the sum of its group's heads'
// rows of dBh / dCh (B, T, H, N), heads in order
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_group_sum(const float* __restrict__ dBh,
                      const float* __restrict__ dCh, T* __restrict__ dB,
                      T* __restrict__ dC, size_t n_out, int H, int G, int N) {
  const int per = H / G;
  for (size_t o = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       o < n_out; o += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(o % N);
    const size_t rest = o / N;
    const int g = static_cast<int>(rest % G);
    const size_t base = ((rest / G) * H + static_cast<size_t>(g) * per) * N
                        + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < per; ++k) {
      sb += dBh[base + static_cast<size_t>(k) * N];
      sc += dCh[base + static_cast<size_t>(k) * N];
    }
    dB[o] = from_float<T>(sb);
    dC[o] = from_float<T>(sc);
  }
}

// dA[h], dD[h]: the sum over (batch, chunk) of the chunks' terms, in order
__global__ void __launch_bounds__(64)
    ssd_bwd_head_sum(const float* __restrict__ dA_part,
                     const float* __restrict__ dD_part,
                     float* __restrict__ dA, float* __restrict__ dD, int n_bc,
                     int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int k = 0; k < n_bc; ++k) {
    sa += dA_part[static_cast<size_t>(k) * H + h];
    sd += dD_part[static_cast<size_t>(k) * H + h];
  }
  dA[h] = sa;
  dD[h] = sd;
}

// scratch (fp32): the recomputed states (B, nC, H, P, N), the state
// gradients (B, nC, H, P, N), the decays, dA and dD terms (B, nC, H) each,
// then dBh and dCh (B, T, H, N) each
template <typename T, int P, int N>
int launch_bwd(const void* x, const float* dt, const float* A,
               const void* Bm, const void* Cm, const float* D,
               const void* dy, void* dx, float* ddt, float* dA, void* dB,
               void* dC, float* dD, float* scratch, int B, int T_, int H,
               int G, cudaStream_t s) {
  const int nC = (T_ + kQ - 1) / kQ;
  if (static_cast<long long>(B) * nC > 65535 || H > 65535 ||
      static_cast<long long>(B) * H > 65535)
    return kBadArgument;
  const size_t n_state = static_cast<size_t>(B) * nC * H * P * N;
  const size_t n_bch = static_cast<size_t>(B) * nC * H;
  float* states = scratch;
  float* dstates = states + n_state;
  float* decay = dstates + n_state;
  float* dA_part = decay + n_bch;
  float* dD_part = dA_part + n_bch;
  float* dBh = dD_part + n_bch;
  float* dCh = dBh + static_cast<size_t>(B) * T_ * H * N;
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  const auto* gt = static_cast<const T*>(dy);
  cudaError_t rc = cudaSuccess;
  if (nC > 0) {
    // once per instantiation (and process): allow more than 48 KB
    constexpr int kStateBytes = static_cast<int>(sizeof(BwdStateSmem<P, N>));
    constexpr int kChunkBytes = static_cast<int>(sizeof(BwdChunkSmem<P, N>));
    static const cudaError_t a1 = cudaFuncSetAttribute(
        ssd_bwd_state_grad<T, P, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kStateBytes);
    static const cudaError_t a2 = cudaFuncSetAttribute(
        ssd_bwd_chunk<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kChunkBytes);
    if (a1 != cudaSuccess) return static_cast<int>(a1);
    if (a2 != cudaSuccess) return static_cast<int>(a2);
    // the forward's states entering each chunk, again
    const dim3 fgrid(P / kPS, H, B * nC);
    if constexpr (kBf16)
      ssd_chunk_state_mma<P, N><<<fgrid, kThreads, 0, s>>>(
          xt, dt, A, bt, states, decay, T_, H, G, nC);
    else
      ssd_chunk_state_fma<P, N><<<fgrid, kThreads, 0, s>>>(
          xt, dt, A, bt, states, decay, T_, H, G, nC);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = launch_dependent(ssd_state_pass<P, N>,
                          dim3(P * N / 4 / kPassThreads, B * H),
                          dim3(kPassThreads), 0, s, states,
                          static_cast<const float*>(decay),
                          static_cast<float*>(nullptr), H, nC);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid(H, B * nC);
    ssd_bwd_state_grad<T, P, N><<<grid, kBwdThreads, kStateBytes, s>>>(
        gt, dt, A, ct, dstates, T_, H, G, nC);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ssd_bwd_state_pass<P, N><<<dim3(P * N / 4 / kPassThreads, B * H),
                               kPassThreads, 0, s>>>(dstates, decay, H, nC);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ssd_bwd_chunk<T, P, N><<<grid, kBwdThreads, kChunkBytes, s>>>(
        xt, dt, A, bt, ct, D, gt, states, dstates, static_cast<T*>(dx), ddt,
        dBh, dCh, dA_part, dD_part, T_, H, G, nC);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const size_t n_out = static_cast<size_t>(B) * T_ * G * N;
    const int blocks = static_cast<int>(
        std::min<size_t>((n_out + 255) / 256, 8192));
    ssd_bwd_group_sum<T><<<blocks, 256, 0, s>>>(
        dBh, dCh, static_cast<T*>(dB), static_cast<T*>(dC), n_out, H, G, N);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // with no chunk, dA and dD are zeros
  ssd_bwd_head_sum<<<(H + 63) / 64, 64, 0, s>>>(dA_part, dD_part, dA, dD,
                                                B * nC, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* D,
                 const void* dy, void* dx, float* ddt, float* dA, void* dB,
                 void* dC, float* dD, float* scratch, int B, int T_, int H,
                 int G, int P, int N, cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch_bwd<T, 64, 128>(x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB,
                                  dC, dD, scratch, B, T_, H, G, s);
  if (P == 64 && N == 64)
    return launch_bwd<T, 64, 64>(x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB,
                                 dC, dD, scratch, B, T_, H, G, s);
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

// The gradient of repro_ssd_scan's y (the final state carries none): x,
// dy, dx: (B, T, H, P); dt, ddt: (B, T, H) fp32; A, D, dA, dD: (H,) fp32;
// Bm, Cm, dB, dC: (B, T, G, N) of x's dtype; scratch: fp32 of
// B * nC * H * (2 * P * N + 3) + 2 * B * T * H * N floats, its contents on
// entry unused. All contiguous, x, dy, B and C 16-byte aligned; H % G ==
// 0; (P, N) is (64, 128) or (64, 64).
extern "C" int repro_ssd_scan_backward(
    int dtype, const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dD, void* scratch, int B, int T_,
    int H, int G, int P, int N, void* stream) {
  using namespace repro;
  if (H <= 0) return 0;
  if (B < 0 || T_ < 0 || G <= 0 || H % G != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Df = static_cast<const float*>(D);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dAf = static_cast<float*>(dA);
  auto* dDf = static_cast<float*>(dD);
  auto* sc = static_cast<float*>(scratch);
  if (dtype == kFloat32)
    return dispatch_bwd<float>(x, dtf, Af, Bm, Cm, Df, dy, dx, ddtf, dAf, dB,
                               dC, dDf, sc, B, T_, H, G, P, N, s);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, dy, dx, ddtf,
                                       dAf, dB, dC, dDf, sc, B, T_, H, G, P,
                                       N, s);
  return kBadArgument;
}
