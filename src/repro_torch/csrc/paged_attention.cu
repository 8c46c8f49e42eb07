// Fused paged attention over one layer's KV page pool: accept-masked insert
// of the window's new K/V rows, then flash-style GQA attention over the
// slot's pages, causal by absolute position with the horizon clamped to
// the last valid row.
//
// Replaces the TPU kernel repro/kernels/paged_attention/kernel.py
// (`paged_attention` -> `_paged_kernel`). There the grid's page axis runs
// in order, carries (m, l, acc) in VMEM, and every visited page is written
// back through an aliased output. Here:
//
// * the page axis is a loop inside the block over the slot's positions
//   0 .. pos + min(W, n_valid) - 1; no position past the horizon (and so no
//   page past it, including null-page table padding) is read;
// * the new rows are overlaid on the staged tile in shared memory (rows
//   j < n_valid of the window, at position pos + j), and only those rows
//   are stored to the pool. Nothing else is written: not the visited
//   pages (blocks of different slots run at once on a GPU, so writing back
//   a shared prefix page while another block reads it would race), not the
//   rows past n_valid, not the null page. The pool is updated in place,
//   with no per-slot contiguous view and no host-built write table;
// * an idle slot (n_valid == 0) writes zeros to its output and returns.
//
// What bounds it here: bytes. A decode step reads each live slot's cached
// K and V once (2 * pos * KV * hd * itemsize per slot) and does ~4 flops a
// byte, far below the card's balance point. The known limit of this first
// version: at S = 8 slots and KV = 4 heads the grid is 32 blocks on 132
// SMs, so most of the card idles at decode; splitting a slot's positions
// over several blocks is later work.
//
// Design: one 128-thread block per (slot, kv head, 32-row chunk of the
// W * G query rows; row r is window row r / G, head kvh * G + r % G). A
// quad of 4 lanes owns one query row, kept in registers; keys stream
// through shared memory 32 positions at a time, each position's row read
// as 16-byte vectors from the page the slot's table names for it (so any
// page size works) or, for a window row, from k_new / v_new. The chunk-0
// block of each (slot, kv head) also stores the window rows; other chunks
// never read those pool rows (they take them from k_new), so the store
// does not race them.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 32;    // query rows per block
constexpr int kKeys = 32;    // key positions per staged tile
constexpr int kThreads = 4 * kRows;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                      const T* __restrict__ v_new, T* k_pages, T* v_pages,
                      const int* __restrict__ tables,
                      const int* __restrict__ positions,
                      const int* __restrict__ n_valid, T* __restrict__ o,
                      int W, int H, int KV, int ps, int T_, float scale) {
  __shared__ float Ks[kKeys * (HD + 1)];
  __shared__ float Vs[kKeys * (HD + 1)];
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int chunk = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int sub = tid & 3;
  const int r = chunk * kRows + (tid >> 2);     // this quad's query row
  const bool row_live = r < W * G;
  const int j = row_live ? r / G : 0;           // window row
  const int h = kvh * G + (row_live ? r % G : 0);
  const int pos = positions[s];
  const int nv = min(n_valid[s], W);
  T* op = o + (static_cast<size_t>(s) * W + j) * H * HD
          + static_cast<size_t>(h) * HD;

  if (nv <= 0) {  // idle slot: zero output, no writes (block-uniform)
    if (row_live) {
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) op[sub + 4 * i] = from_float<T>(0.f);
    }
    return;
  }

  const int* table = tables + static_cast<size_t>(s) * T_;
  const size_t kv_row = static_cast<size_t>(KV) * HD;  // pool row stride
  const T* kn = k_new + static_cast<size_t>(s) * W * kv_row
                + static_cast<size_t>(kvh) * HD;
  const T* vn = v_new + static_cast<size_t>(s) * W * kv_row
                + static_cast<size_t>(kvh) * HD;

  if (chunk == 0) {
    // store the valid window rows; the entry clamp is the JAX reference's
    for (int e = tid; e < nv * HD; e += kThreads) {
      const int jj = e / HD;
      const int d = e - jj * HD;
      const int a = pos + jj;
      const int entry = min(max(a / ps, 0), T_ - 1);
      const size_t dst =
          (static_cast<size_t>(table[entry]) * ps + a % ps) * kv_row
          + static_cast<size_t>(kvh) * HD + d;
      k_pages[dst] = kn[jj * kv_row + d];
      v_pages[dst] = vn[jj * kv_row + d];
    }
  }

  // causal horizon, clamped to the last valid window row
  const int qpos = pos + min(j, nv - 1);
  const int r_last = min(chunk * kRows + kRows, W * G) - 1;
  const int limit = min(pos + min(r_last / G, nv - 1) + 1, T_ * ps);

  float qr[HD];
  {
    const T* qp = q + (static_cast<size_t>(s) * W + j) * H * HD
                  + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = row_live ? to_float(qp[d]) : 0.f;
  }
  RowState<HD> st;
  st.init();

  for (int k0 = 0; k0 < limit; k0 += kKeys) {
    __syncthreads();  // the previous tile has been consumed
    stage_tile<T, HD, kKeys, kThreads>(
        Ks, Vs, [&](int t, const T*& kr, const T*& vr) {
          const int a = k0 + t;
          if (a >= limit) return false;        // past the horizon: masked
          const int jj = a - pos;
          if (jj >= 0 && jj < nv) {  // a window row: overlay the new K/V
            kr = kn + jj * kv_row;
            vr = vn + jj * kv_row;
          } else {
            const size_t off =
                (static_cast<size_t>(table[a / ps]) * ps + a % ps) * kv_row
                + static_cast<size_t>(kvh) * HD;
            kr = k_pages + off;
            vr = v_pages + off;
          }
          return true;
        });
    __syncthreads();
    attend_tile<HD, kKeys>(st, qr, Ks, Vs, scale, sub, [&](int c) {
      const int a = k0 + c;
      return a < limit && a <= qpos;
    });
  }

  if (row_live) {
    const float l = fmaxf(st.l, 1e-30f);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      op[sub + 4 * i] = from_float<T>(st.acc[i] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k_new, const void* v_new,
           void* k_pages, void* v_pages, const int* tables,
           const int* positions, const int* n_valid, void* o, int S, int W,
           int H, int KV, int ps, int T_, float scale, cudaStream_t stream) {
  const dim3 grid(S, KV, (W * (H / KV) + kRows - 1) / kRows);
  paged_attn_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), tables, positions, n_valid,
      static_cast<T*>(o), W, H, KV, ps, T_, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const int* tables,
                const int* positions, const int* n_valid, void* o, int S,
                int W, int H, int KV, int ps, int T_, float scale,
                cudaStream_t s) {
  // paper_demo's head_dim; add an instantiation when a ported config needs one
  if (hd != 64) return kBadArgument;
  return launch<T, 64>(q, k_new, v_new, k_pages, v_pages, tables, positions,
                       n_valid, o, S, W, H, KV, ps, T_, scale, s);
}

}  // namespace
}  // namespace repro

// q, o: (S, W, H, hd); k_new, v_new: (S, W, KV, hd); k_pages, v_pages:
// (P + 1, ps, KV, hd), updated in place; tables: (S, T) int32; positions,
// n_valid: (S,) int32. All contiguous; H % KV == 0; hd == 64.
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* k_new, const void* v_new,
                                     void* k_pages, void* v_pages,
                                     const void* tables,
                                     const void* positions,
                                     const void* n_valid, void* o, int S,
                                     int W, int H, int KV, int hd, int ps,
                                     int T_, float scale, void* stream) {
  using namespace repro;
  if (S <= 0 || W <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || ps <= 0 || T_ <= 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const int*>(tables);
  const auto* pos = static_cast<const int*>(positions);
  const auto* nv = static_cast<const int*>(n_valid);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k_new, v_new, k_pages, v_pages, tab, pos,
                              nv, o, S, W, H, KV, ps, T_, scale, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_new, v_new, k_pages, v_pages,
                                      tab, pos, nv, o, S, W, H, KV, ps, T_,
                                      scale, s);
  return kBadArgument;
}
