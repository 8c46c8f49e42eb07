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
