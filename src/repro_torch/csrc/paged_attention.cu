// Fused paged attention over one layer's KV page pool: accept-masked insert
// of the window's new K/V rows, then GQA attention over the slot's pages,
// causal by absolute position with the horizon clamped to the last valid
// row. One call is two CUDA launches: a split kernel and a merge kernel.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// (`paged_attention` -> `_paged_kernel`). There the grid's page axis runs
// in order, carries (m, l, acc) in VMEM, and every visited page is written
// back through an aliased output. GPU blocks run in no order, so here the
// page axis is cut into splits of kSplit positions that run in parallel,
// and a second kernel merges their partial softmax states.
//
// What bounds it on the H100: bytes. A decode step reads each live slot's
// cached K and V once (2 * pos * KV * hd * itemsize per slot) and does ~4
// flops a byte, far below the card's balance point, so what counts is how
// many bytes are in flight at once. The first version (PR 11) ran one
// block per (slot, kv head, 32 query rows) that walked the slot's positions
// serially, 32 blocks on 132 SMs at decode with 3 of its 32 row slots
// live: 0.1369 ms for 8 slots (PR 13's chip run, NVIDIA H100 80GB HBM3,
// 700 W), ~150x its bytes bound. This design: 0.0149 ms for the same 8
// slots, 0.0172 ms for a 16-row suffix window (PR 13: 0.0411), bf16, same
// card and power limit (chip_smoke.py phase 3, PR 14's chip run). Most of
// what is left is two launches' latency and one block's chain of three
// dependent memory reads; the bytes bound is 0.0009 ms.
//
// Design (flash-decoding):
//
// * split kernel: one 128-thread block per (position split, kv head, row
//   chunk of up to kRows of the W * G query rows, slot). The number of
//   splits comes from host-known sizes only, ceil(T * ps / kSplit), so the
//   wrapper never reads positions or n_valid; a split wholly past its
//   chunk's horizon (including every split of an idle slot) writes an
//   empty partial (m = -1e30, l = 0) and exits. At decode (T = 64, ps =
//   16, 8 slots, 4 kv heads) that is 512 blocks. A block stages its
//   split's kSplit key and value rows in shared memory (16-byte loads, all
//   issued before any is used; the split's page-table entries load beside
//   the slot's position, so a key row's address waits on one memory
//   latency), then spreads the keys over threads: thread `key` scores
//   every live row of the chunk against its key (query rows read from
//   shared memory as broadcasts), a warp per row takes the split's max
//   and sum, and thread `d` accumulates the probability-weighted values of
//   output column d. Work scales with the chunk's live rows: a 3-row
//   decode chunk is not padded to kRows. It writes (m, l, acc) in fp32 to
//   the scratch the wrapper allocates.
// * merge kernel: one warp per output row rescales each split's state by
//   exp(m_split - M) and divides by the merged sum; splits with m = -1e30
//   contribute nothing, and a row whose every split is empty (an idle
//   slot) outputs zeros, as the reference's `alive` zeroing does. It is
//   launched as a programmatic dependent launch: it starts while the split
//   grid runs and waits for it on the card (griddepcontrol), so its launch
//   latency hides behind the split kernel.
// * the window rows (j < n_valid) are stored to the pool by exactly one
//   block per (slot, kv head): split 0 of row chunk 0. Every split whose
//   range covers positions pos .. pos + n_valid - 1 reads those rows from
//   k_new / v_new, never from the pool, so no block reads a row another
//   block writes. Nothing else is written: not the visited pages (blocks
//   of other slots may read a shared prefix page meanwhile), not rows past
//   n_valid, not the null page.
// * fp32 and bf16 share this design (fp32 FMAs on fp32-staged rows).
// * head dims 64 (paper_demo) and 128 (deepseek-coder, llama3, command-r)
//   are instantiated. The staged K and V rows, the chunk's query rows and
//   its scores live in dynamic shared memory: 41 KB at 64, 77 KB at 128,
//   past the 48 KB a kernel may declare statically. llama3's 16 q-heads a
//   KV head make a decode chunk of 16 rows; deepseek's 8 (7 real, one
//   zero-weight pad head) a chunk of 8.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kSplit = 64;     // positions per split, staged at once
constexpr int kRows = 16;      // query rows per row chunk
constexpr int kThreads = 128;
constexpr int kMergeWarps = 4;

// Dynamic shared memory of the split kernel: the chunk's query rows and
// scores (16-byte aligned, read as float4), then the K and V rows.
template <int HD>
constexpr int split_smem_bytes() {
  return (kRows * HD + kRows * kSplit + 2 * kSplit * (HD + 1))
         * static_cast<int>(sizeof(float));
}

// Partial state of split `sp` for output row `row` = (s * W + j) * H + h:
// acc at part_acc[(sp * rows_total + row) * HD], (m, l) at
// part_ml[2 * (sp * rows_total + row)].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_split_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_new,
                            const T* __restrict__ v_new, T* k_pages,
                            T* v_pages, const int* __restrict__ tables,
                            const int* __restrict__ positions,
                            const int* __restrict__ n_valid,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int S, int W, int H,
                            int KV, int ps, int T_, float scale) {
  static_assert(kThreads % kSplit == 0 && kThreads % HD == 0,
                "threads must tile keys and columns");
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kQIters = (kRows * kPerRow + kThreads - 1) / kThreads;
  constexpr int kKeyGroups = kThreads / kSplit;   // rows per key thread step
  constexpr int kColGroups = kThreads / HD;       // rows per column step
  extern __shared__ __align__(16) unsigned char paged_smem[];
  float* Qs = reinterpret_cast<float*>(paged_smem);
  float* Ps = Qs + kRows * HD;          // scores, then probs
  float* Ks = Ps + kRows * kSplit;
  float* Vs = Ks + kSplit * (HD + 1);
  __shared__ float Ms[kRows];
  __shared__ float Ls[kRows];
  __shared__ int pages[kSplit];   // the split's table entries

  // the merge kernel may launch now; it waits for this grid's results
  griddep_launch_dependents();

  const int split = blockIdx.x;
  const int kvh = blockIdx.y % KV;
  const int chunk = blockIdx.y / KV;
  const int s = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int r0 = chunk * kRows;
  const int rows = min(kRows, W * G - r0);      // live rows of the chunk
  const int k0 = split * kSplit;
  const int* table = tables + static_cast<size_t>(s) * T_;
  // the split's table entries load beside the slot's position and count,
  // so the key rows' addresses wait on one memory latency, not two
  const int e0 = k0 / ps;
  const int n_entries = (k0 + kSplit - 1) / ps - e0 + 1;
  const int page = tid < n_entries ? table[min(e0 + tid, T_ - 1)] : 0;
  const int pos = positions[s];
  const int nv = min(n_valid[s], W);
  const size_t rows_total = static_cast<size_t>(S) * W * H;
  const size_t kv_row = static_cast<size_t>(KV) * HD;  // pool row stride
  const T* kn = k_new + static_cast<size_t>(s) * W * kv_row
                + static_cast<size_t>(kvh) * HD;
  const T* vn = v_new + static_cast<size_t>(s) * W * kv_row
                + static_cast<size_t>(kvh) * HD;
  // output row of chunk row i
  auto out_row = [&](int i) {
    const int r = r0 + i;
    return (static_cast<size_t>(s) * W + r / G) * H + kvh * G + r % G;
  };

  if (split == 0 && chunk == 0) {
    // store the valid window rows; the entry clamp is the JAX reference's
    for (int e = tid; e < nv * kPerRow; e += kThreads) {
      const int jj = e / kPerRow;
      const int c = e - jj * kPerRow;
      const int a = pos + jj;
      const int entry = min(max(a / ps, 0), T_ - 1);
      const size_t dst =
          (static_cast<size_t>(table[entry]) * ps + a % ps) * kv_row
          + static_cast<size_t>(kvh) * HD;
      reinterpret_cast<uint4*>(k_pages + dst)[c] =
          reinterpret_cast<const uint4*>(kn + jj * kv_row)[c];
      reinterpret_cast<uint4*>(v_pages + dst)[c] =
          reinterpret_cast<const uint4*>(vn + jj * kv_row)[c];
    }
  }

  // causal horizon of the chunk's last row, clamped to the last valid row
  const int limit =
      nv > 0 ? min(pos + min((r0 + rows - 1) / G, nv - 1) + 1, T_ * ps) : 0;
  if (k0 >= limit) {  // empty split (every split of an idle slot)
    for (int i = tid; i < rows; i += kThreads) {
      part_ml[2 * (split * rows_total + out_row(i))] = kNegInf;
      part_ml[2 * (split * rows_total + out_row(i)) + 1] = 0.f;
    }
    return;
  }

  if (tid < n_entries) pages[tid] = page;
  __syncthreads();

  // the chunk's query rows: issue their loads, then the tile's, then use
  uint4 qbuf[kQIters];
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int e = tid + it * kThreads;
    qbuf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (e < rows * kPerRow) {
      const int i = e / kPerRow;
      qbuf[it] = reinterpret_cast<const uint4*>(
          q + out_row(i) * HD)[e - i * kPerRow];
    }
  }
  stage_tile<T, HD, kSplit, kThreads>(
      Ks, Vs, [&](int t, const T*& kr, const T*& vr) {
        const int a = k0 + t;
        if (a >= limit) return false;        // past the horizon: masked
        const int jj = a - pos;
        if (jj >= 0 && jj < nv) {  // a window row: read the new K/V
          kr = kn + jj * kv_row;
          vr = vn + jj * kv_row;
        } else {
          const size_t off =
              (static_cast<size_t>(pages[a / ps - e0]) * ps + a % ps) * kv_row
              + static_cast<size_t>(kvh) * HD;
          kr = k_pages + off;
          vr = v_pages + off;
        }
        return true;
      });
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int e = tid + it * kThreads;
    if (e < rows * kPerRow) {
      const T* qe = reinterpret_cast<const T*>(&qbuf[it]);
#pragma unroll
      for (int x = 0; x < kVec; ++x) Qs[e * kVec + x] = to_float(qe[x]);
    }
  }
  __syncthreads();

  {  // scores: thread `key` against every live row of the chunk
    const int key = tid % kSplit;
    const int a = k0 + key;
    float kr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) kr[d] = Ks[key * (HD + 1) + d];
    for (int i = tid / kSplit; i < rows; i += kKeyGroups) {
      const int qpos = pos + min((r0 + i) / G, nv - 1);
      const float4* qr = reinterpret_cast<const float4*>(Qs + i * HD);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 qv = qr[d4];
        dot = fmaf(qv.x, kr[4 * d4], dot);
        dot = fmaf(qv.y, kr[4 * d4 + 1], dot);
        dot = fmaf(qv.z, kr[4 * d4 + 2], dot);
        dot = fmaf(qv.w, kr[4 * d4 + 3], dot);
      }
      Ps[i * kSplit + key] = (a < limit && a <= qpos) ? dot * scale : kNegInf;
    }
  }
  __syncthreads();

  {  // the split's max and sum: one warp per row
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int i = warp; i < rows; i += kThreads / 32) {
      float* pr = Ps + i * kSplit;
      float m = kNegInf;
      for (int c = lane; c < kSplit; c += 32) m = fmaxf(m, pr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
      for (int c = lane; c < kSplit; c += 32) {
        // a row with no visible key in this split: p = 0, m stays -1e30
        const float p = (m <= kNegInf) ? 0.f : expf(pr[c] - m);
        pr[c] = p;
        l += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) {
        Ms[i] = m;
        Ls[i] = l;
      }
    }
  }
  __syncthreads();

  {  // values: thread `d` accumulates column d of its rows
    const int d = tid % HD;
    const int g = tid / HD;
    float acc[kRows / kColGroups];
#pragma unroll
    for (int x = 0; x < kRows / kColGroups; ++x) acc[x] = 0.f;
    for (int c = 0; c < kSplit; c += 4) {
      const float v0 = Vs[c * (HD + 1) + d];
      const float v1 = Vs[(c + 1) * (HD + 1) + d];
      const float v2 = Vs[(c + 2) * (HD + 1) + d];
      const float v3 = Vs[(c + 3) * (HD + 1) + d];
#pragma unroll
      for (int x = 0; x < kRows / kColGroups; ++x) {
        const int i = g + x * kColGroups;
        if (i < rows) {
          const float4 p = *reinterpret_cast<const float4*>(
              Ps + i * kSplit + c);
          acc[x] = fmaf(p.x, v0, fmaf(p.y, v1, fmaf(p.z, v2,
                                                    fmaf(p.w, v3, acc[x]))));
        }
      }
    }
#pragma unroll
    for (int x = 0; x < kRows / kColGroups; ++x) {
      const int i = g + x * kColGroups;
      if (i < rows) {
        const size_t at = split * rows_total + out_row(i);
        part_acc[at * HD + d] = acc[x];
        if (d == 0) {
          part_ml[2 * at] = Ms[i];
          part_ml[2 * at + 1] = Ls[i];
        }
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
    paged_attn_merge_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            T* __restrict__ o, int rows_total, int n_split) {
  // launched early (programmatic dependent launch): wait until the split
  // grid has finished and its partials are visible
  griddep_wait();
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (row >= rows_total) return;
  const int lane = threadIdx.x % 32;
  auto at = [&](int sp) {
    return static_cast<size_t>(sp) * rows_total + row;
  };
  // lanes read the splits' (m, l) side by side
  float M = kNegInf;
  for (int sp = lane; sp < n_split; sp += 32)
    M = fmaxf(M, part_ml[2 * at(sp)]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, x));
  float L = 0.f;
  float acc[HD / 32];
#pragma unroll
  for (int x = 0; x < HD / 32; ++x) acc[x] = 0.f;
  for (int base = 0; base < n_split; base += 32) {
    // lane i weighs split base + i; an empty split (m = -1e30) weighs 0
    // and its acc, which was never written, is not read
    float w = 0.f;
    if (base + lane < n_split) {
      const float m = part_ml[2 * at(base + lane)];
      if (m > kNegInf) {
        w = expf(m - M);
        L += w * part_ml[2 * at(base + lane) + 1];
      }
    }
    const int n = min(32, n_split - base);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(0xffffffffu, w, i);
      if (wi > 0.f) {
#pragma unroll
        for (int x = 0; x < HD / 32; ++x)
          acc[x] = fmaf(wi, part_acc[at(base + i) * HD + lane + 32 * x],
                        acc[x]);
      }
    }
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    L += __shfl_xor_sync(0xffffffffu, L, x);
  const float l = fmaxf(L, 1e-30f);  // no live split: acc = 0, output 0
#pragma unroll
  for (int x = 0; x < HD / 32; ++x)
    o[static_cast<size_t>(row) * HD + lane + 32 * x] =
        from_float<T>(acc[x] / l);
}

template <typename T, int HD>
int launch(const void* q, const void* k_new, const void* v_new,
           void* k_pages, void* v_pages, const int* tables,
           const int* positions, const int* n_valid, void* o,
           float* partials, int S, int W, int H, int KV, int ps, int T_,
           float scale, cudaStream_t stream) {
  const int n_split = (T_ * ps + kSplit - 1) / kSplit;
  const int n_chunks = (W * (H / KV) + kRows - 1) / kRows;
  const size_t rows_total = static_cast<size_t>(S) * W * H;
  if (static_cast<size_t>(KV) * n_chunks > 65535 || S > 65535
      || rows_total > 0x7fffffff)
    return kBadArgument;
  float* part_acc = partials;
  float* part_ml = partials + static_cast<size_t>(n_split) * rows_total * HD;
  constexpr int smem = split_smem_bytes<HD>();
  // once per process and instantiation: allow more than 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_attn_split_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_split, KV * n_chunks, S);
  paged_attn_split_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), tables, positions, n_valid, part_acc,
      part_ml, S, W, H, KV, ps, T_, scale);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // the merge launches while the split grid runs and waits for it on the
  // card (programmatic stream serialization), hiding its launch latency
  const int rows = static_cast<int>(rows_total);
  return static_cast<int>(launch_dependent(
      paged_attn_merge_kernel<T, HD>,
      dim3((rows + kMergeWarps - 1) / kMergeWarps), dim3(kMergeWarps * 32), 0,
      stream, static_cast<const float*>(part_acc),
      static_cast<const float*>(part_ml), static_cast<T*>(o), rows, n_split));
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const int* tables,
                const int* positions, const int* n_valid, void* o,
                float* partials, int S, int W, int H, int KV, int ps, int T_,
                float scale, cudaStream_t s) {
  // the head dims of the ported configs
  if (hd == 64)
    return launch<T, 64>(q, k_new, v_new, k_pages, v_pages, tables,
                         positions, n_valid, o, partials, S, W, H, KV, ps,
                         T_, scale, s);
  if (hd == 128)
    return launch<T, 128>(q, k_new, v_new, k_pages, v_pages, tables,
                          positions, n_valid, o, partials, S, W, H, KV, ps,
                          T_, scale, s);
  return kBadArgument;
}

}  // namespace
}  // namespace repro

// q, o: (S, W, H, hd); k_new, v_new: (S, W, KV, hd); k_pages, v_pages:
// (P + 1, ps, KV, hd), updated in place; tables: (S, T) int32; positions,
// n_valid: (S,) int32. All contiguous; H % KV == 0; hd in {64, 128}.
// partials: fp32 scratch of n_split * S * W * H * (hd + 2) floats, n_split =
// ceil(T * ps / split_len); split_len must be the kernel's kSplit (64).
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* k_new, const void* v_new,
                                     void* k_pages, void* v_pages,
                                     const void* tables,
                                     const void* positions,
                                     const void* n_valid, void* o,
                                     void* partials, int S, int W, int H,
                                     int KV, int hd, int ps, int T_,
                                     int split_len, float scale,
                                     void* stream) {
  using namespace repro;
  if (S <= 0 || W <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || ps <= 0 || T_ <= 0 || split_len != kSplit)
    return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const int*>(tables);
  const auto* pos = static_cast<const int*>(positions);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* part = static_cast<float*>(partials);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k_new, v_new, k_pages, v_pages, tab, pos,
                              nv, o, part, S, W, H, KV, ps, T_, scale, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_new, v_new, k_pages, v_pages,
                                      tab, pos, nv, o, part, S, W, H, KV, ps,
                                      T_, scale, s);
  return kBadArgument;
}
