// Forward attention with an online softmax: causal, sliding-window or
// non-causal, GQA by h // (H / KV), a q_offset, and a KV tail mask.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention` -> `_flash_kernel`), whose sequential kv grid axis
// carries (m, l, acc) in VMEM scratch. Here that axis becomes a loop inside
// the block, and the state lives in registers.
//
// What bounds it here: at prefill shapes (Sq = Sk = 512, H = 12, D = 64)
// the work is ~0.4 GFLOP on ~2.4 MB of q/k/v/o, so the tensor-core bound is
// well under a microsecond and the bytes bound about one; this first
// version does its products with fp32 FMAs (no mma/wgmma), so it is bound
// by FMA issue, not by either. It also runs only (Sq / 64) * H * B blocks
// (96 at the shape above) on 132 SMs.
//
// Design: one 256-thread block per (64-row q tile, q head, batch). Each
// quad of 4 lanes owns one query row: the whole row sits in registers
// (fp32), and lane `sub` keeps output columns sub + 4*i. The block loops
// over 64-row K/V tiles of kv head h / G, read as 16-byte vectors and
// staged in shared memory as fp32, and stops at the causal horizon; tiles
// wholly outside a sliding window are skipped. Scores, running max and
// running sum are fp32 with the JAX kernel's -1e30 mask and its guards for
// fully masked rows.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;     // query rows per block
constexpr int kKeys = 64;     // keys per staged tile
constexpr int kThreads = 4 * kRows;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int causal, int window,
                     int q_offset, float scale) {
  __shared__ float Ks[kKeys * (HD + 1)];
  __shared__ float Vs[kKeys * (HD + 1)];
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int sub = tid & 3;
  const int qi = qt * kRows + (tid >> 2);       // this quad's query row
  const int q_start = qt * kRows + q_offset;    // absolute pos of row 0
  const int qpos = qi + q_offset;

  float qr[HD];
  {
    const T* qp = q + (static_cast<size_t>(b) * Sq + min(qi, Sq - 1)) * H * HD
                  + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qi < Sq ? to_float(qp[d]) : 0.f;
  }
  RowState<HD> st;
  st.init();

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const T* kb = k + static_cast<size_t>(b) * Sk * row_stride
                + static_cast<size_t>(kvh) * HD;
  const T* vb = v + static_cast<size_t>(b) * Sk * row_stride
                + static_cast<size_t>(kvh) * HD;
  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * kKeys;
    // block-uniform skips, as in the JAX kernel: a tile wholly in the
    // future of every row ends the loop; one wholly before every row's
    // window is passed over
    if (causal && k_start > q_start + kRows - 1) break;
    if (window > 0 && k_start + kKeys - 1 <= q_start - window) continue;
    __syncthreads();  // the previous tile has been consumed
    stage_tile<T, HD, kKeys, kThreads>(
        Ks, Vs, [&](int r, const T*& kr, const T*& vr) {
          const int kp = k_start + r;
          if (kp >= Sk) return false;          // KV tail: zeros, masked
          kr = kb + kp * row_stride;
          vr = vb + kp * row_stride;
          return true;
        });
    __syncthreads();
    attend_tile<HD, kKeys>(st, qr, Ks, Vs, scale, sub, [&](int c) {
      const int kpos = k_start + c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      return ok;
    });
  }

  if (qi < Sq) {
    const float l = fmaxf(st.l, 1e-30f);
    T* op = o + (static_cast<size_t>(b) * Sq + qi) * H * HD
            + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      op[sub + 4 * i] = from_float<T>(st.acc[i] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Sk, int H, int KV, int causal, int window,
                int q_offset, float scale, cudaStream_t s) {
  // paper_demo's head_dim; add an instantiation when a ported config needs one
  if (D != 64) return kBadArgument;
  return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                       q_offset, scale, s);
}

}  // namespace
}  // namespace repro

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); all contiguous; H % KV == 0;
// D == 64.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KV, int D, int causal,
                                     int window, int q_offset, float scale,
                                     void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(D, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                              q_offset, scale, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KV, causal,
                                      window, q_offset, scale, s);
  return kBadArgument;
}
