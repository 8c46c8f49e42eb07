// Forward attention with an online softmax: causal, sliding-window or
// non-causal, GQA by h // (H / KV), a q_offset, and a KV tail mask.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention` -> `_flash_kernel`), whose sequential kv grid axis
// carries (m, l, acc) in VMEM scratch. Here that axis becomes a loop inside
// the block, and the state lives in registers.
//
// What bounds it on the H100: at prefill shapes (Sq = Sk = 512, H = 12,
// D = 64) the work is ~0.4 GFLOP on ~2.4 MB of q/k/v/o, so the tensor-core
// bound is under a microsecond and the bytes bound about one. What the
// kernel actually waits on is the serial walk of the last causal q tiles
// over the KV tiles: each tile's two products and its softmax lie on that
// path, and with loads cut out the kernel takes nearly as long, so each
// warp's chain of dependent instructions, not memory, is the limit. The
// first version (PR 11) ran both products on fp32 FMAs from fp32-staged
// shared memory: 0.0897 ms against 0.0136 ms for
// scaled_dot_product_attention (PR 13's chip run, NVIDIA H100 80GB HBM3,
// 700 W). This design: 0.0125 ms against SDPA's 0.0132 ms in the same
// run (0.94x), B = 1, Sq = Sk = 512 (chip_smoke.py phase 3, PR 14's chip
// run, same card and power limit).
//
// bf16 design (tensor cores): one block per (32-row q tile, head, batch)
// of 2 x 4 warps; each row warp owns 16 query rows, and the four KV
// groups of warps walk every fourth 32-key KV tile, so each warp's serial
// chain is a quarter of the walk; group 0 merges the four (m, l, acc)
// through shared memory at the end. QK^T and PV run as mma.sync.m16n8k16
// bf16 -> fp32, operands loaded with ldmatrix from bf16 shared memory
// (rows of 128 or 256 bytes, 16-byte chunks XOR-swizzled by row so ldmatrix is
// free of bank conflicts). The probabilities stay in registers: the QK^T
// accumulators are rounded to bf16 and reused as the A operand of PV (the
// plain version also rounds probabilities to q's dtype); the softmax runs
// in base 2 with the scale folded in. Rounds of four K/V tiles are
// double-buffered with cp.async, so the next round's loads overlap this
// round's products. Blocks are ordered heaviest-first (the last causal q
// tiles get the lowest block index) to shorten the causal tail. wgmma
// with TMA (the Hopper-native shape) would raise the tensor-core rate, but
// at these sizes (0.4 GFLOP a call) the serial latency of the KV walk, not
// the rate, bounds the kernel.
//
// Head dims 64 (paper_demo), 120 (h2o-danube3) and 128 (deepseek-coder,
// llama3, command-r) are instantiated. The bf16 kernel keeps Q/K/V rows in
// shared memory at a width rounded up to a multiple of 64 (128 for 120):
// the swizzle needs whole groups of eight 16-byte chunks, and the k16 MMA
// steps of QK^T need a width that is a multiple of 16. A 120-wide row is
// 15 chunks; the 16th is zero-filled by the cp.async (src-size 0), so it
// adds nothing to QK^T, and its PV columns (120..127) are computed from
// zero V and never stored. At 128 the stages take 136 KB of shared memory
// (one block per SM), at 64 68 KB.
//
// fp32 design (FMAs; tensor cores would mean TF32, which breaks the fp32
// tolerance): one 256-thread block per (64-row q tile, head, batch); each
// quad of 4 lanes owns one query row in registers; K/V tiles of 64 keys
// (32 above head_dim 64, so that the two fp32 tiles stay within 48 KB of
// static shared memory) are staged as fp32 (common.cuh stage_tile /
// attend_tile). It serves the fp32 identity checks, not speed.
//
// Both: scores, running max and running sum in fp32 with the JAX kernel's
// -1e30 mask and its guards for fully masked rows; tiles wholly in the
// causal future end the loop, tiles wholly before every row's window are
// skipped.
#include "common.cuh"

namespace repro {
namespace {

// ----------------------------------------------------------- fp32 (FMAs)
constexpr int kRows = 64;     // query rows per block
constexpr int kThreads = 4 * kRows;
// keys per staged fp32 tile: K and V tiles of (HD + 1)-float rows within
// the 48 KB of static shared memory
template <int HD>
__host__ __device__ constexpr int fp32_keys() {
  return HD <= 64 ? 64 : 32;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int causal, int window, int q_offset, float scale) {
  constexpr int kKeys = fp32_keys<HD>();
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
    // the row's log-sum-exp of its scaled scores, for the backward; a
    // fully masked row (l = 0) gets +inf, so the backward's p is 0 there
    if (lse != nullptr && sub == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] =
          st.l > 0.f ? st.m + logf(st.l) : CUDART_INF_F;
  }
}

// ------------------------------------------------- bf16 (tensor cores)
using bf16 = __nv_bfloat16;
constexpr int kMmaKeys = 32;    // keys per K/V tile

// 2^x in one MUFU instruction (inputs of -1e30 give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// With the fragment layouts of common.cuh each thread owns two query
// rows (g and g + 8 of its warp's 16).
//
// Block: kRowWarps x kGroups warps. Row warp rw owns query rows
// 16rw .. 16rw + 15 of the q tile; KV group grp walks the tile's KV tiles
// t_begin + grp, t_begin + grp + kGroups, ..., so the serial chain of each
// warp is 1 / kGroups of the walk. All warps load each round's kGroups
// tiles together (cp.async, two rounds in flight); at the end the groups'
// (m, l, acc) are merged through shared memory by group 0. The shape
// (2 row warps, 4 groups, 32-key tiles) is the fastest of those measured
// at the prefill shape (B = 1, Sq = 512): 32-row q tiles give 192 blocks
// on 132 SMs where 64-row ones give 96, and four groups of short tiles
// cut each warp's serial chain to a quarter of the walk.
constexpr int kRowWarps = 2;
constexpr int kGroups = 4;
constexpr int kMmaThreads = kRowWarps * kGroups * 32;

// Shared-memory layout of head_dim D: rows of HD = D rounded up to a
// multiple of 64 elements (8 or 16 swizzled 16-byte chunks), of which the
// first D / 8 chunks come from device memory.
template <int D>
struct MmaDims {
  static constexpr int HD = (D + 63) / 64 * 64;
  static constexpr int kChunks = HD / 8;
  static constexpr int kRealChunks = D / 8;
  static constexpr int kSmemBytes =
      (16 * kRowWarps * HD + 2 * kGroups * 2 * kMmaKeys * HD)
      * static_cast<int>(sizeof(bf16));
  static_assert(D % 8 == 0, "rows must split into 16-byte chunks");
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         int KV, int causal, int window, int q_offset,
                         float scale) {
  constexpr int HD = MmaDims<D>::HD;
  constexpr int kChunks = MmaDims<D>::kChunks;
  constexpr int kRealChunks = MmaDims<D>::kRealChunks;
  constexpr int kQRows = 16 * kRowWarps;
  constexpr int kNT = kMmaThreads;
  constexpr int kTile = kMmaKeys * HD;          // elements of one K tile
  constexpr int kState = HD / 8 * 4 + 4;        // acc, m[2], l[2] a lane
  static_assert((kGroups - 1) * kRowWarps * kState * 32 * 4
                    <= 2 * kGroups * 2 * kTile * 2,
                "the merge must fit in the K/V buffers");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + kQRows * HD;   // [stage][group][K, V][kMmaKeys][HD]
  auto k_tile = [&](int stage, int grp) {
    return KVs + (stage * kGroups + grp) * 2 * kTile;
  };

  // heaviest first: the q tile is the slowest grid index, counted down
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rw = warp % kRowWarps;
  const int grp = warp / kRowWarps;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q_row0 = qt * kQRows;              // first row of the tile
  const int q_start = q_row0 + q_offset;       // its absolute position
  const int q_last = min(q_row0 + kQRows, Sq) - 1 + q_offset;
  const int w_first = q_start + rw * 16;       // this warp's rows
  const int w_last = w_first + 15;
  // scores are kept as s * scale * log2(e), so exp(x) becomes 2^x
  const float scale_log2 = scale * 1.4426950408889634f;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(KV) * D;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_stride
                   + static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kv_stride
                   + static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * kv_stride
                   + static_cast<size_t>(kvh) * D;

  // the KV tiles this q tile visits, with the JAX kernel's skips
  const int n_tiles = (Sk + kMmaKeys - 1) / kMmaKeys;
  int t_end = n_tiles;
  if (causal) t_end = q_last < 0 ? 0 : min(n_tiles, q_last / kMmaKeys + 1);
  int t_begin = 0;
  if (window > 0) {
    const int x = q_start - window - kMmaKeys + 1;  // last skipped k_start
    t_begin = x < 0 ? 0 : x / kMmaKeys + 1;
  }
  const int n_rounds = max(0, (t_end - t_begin + kGroups - 1) / kGroups);

#pragma unroll
  for (int i = 0; i < kQRows * kChunks / kNT; ++i) {
    const int idx = tid + i * kNT;
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    // past the last row, or the pad chunk of a 120-wide row: zeros
    const bool ok = q_row0 + r < Sq && c < kRealChunks;
    cp_async16(smem_u32(&Qs[swz<HD>(r, c)]),
               qb + (ok ? (q_row0 + r) * q_stride + c * 8 : 0), ok);
  }
  auto load_round = [&](int round, int stage) {
#pragma unroll
    for (int i = 0; i < kGroups * kMmaKeys * kChunks / kNT; ++i) {
      const int idx = tid + i * kNT;
      const int gi = idx / (kMmaKeys * kChunks);
      const int r = (idx / kChunks) % kMmaKeys;
      const int c = idx % kChunks;
      const int t = t_begin + round * kGroups + gi;
      if (t >= t_end) continue;                // this group idles
      const int kp = t * kMmaKeys + r;
      const bool ok = kp < Sk && c < kRealChunks;   // KV tail, pad: zeros
      const size_t off = ok ? kp * kv_stride + c * 8 : 0;
      bf16* kt = k_tile(stage, gi);
      cp_async16(smem_u32(&kt[swz<HD>(r, c)]), kb + off, ok);
      cp_async16(smem_u32(&kt[kTile + swz<HD>(r, c)]), vb + off, ok);
    }
  };
  if (n_rounds > 0) load_round(0, 0);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};   // this thread's share of the row sums
  uint32_t qf[HD / 16][4];        // the warp's Q as A fragments

  for (int round = 0; round < n_rounds; ++round) {
    const int stage = round & 1;
    if (round + 1 < n_rounds) {
      load_round(round + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (round == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], smem_u32(&Qs[swz<HD>(rw * 16 + (lane & 7)
                                          + ((lane >> 3) & 1) * 8,
                                          kk * 2 + (lane >> 4))]));
    }
    const int t = t_begin + round * kGroups + grp;
    const int k0 = t * kMmaKeys;
    // a tile past the walk, or wholly in this warp's causal future, leaves
    // the warp's state as it is
    if (t < t_end && !(causal && k0 > w_last)) {
      const bf16* Kt = k_tile(stage, grp);
      const bf16* Vt = Kt + kTile;
      float s[kMmaKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int part = 0; part < HD / 32; ++part) {
        // 32 columns at a time: all fragments first, then the products
        uint32_t kf[kMmaKeys / 8][4];
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n)
          ldsm_x4(kf[n], smem_u32(&Kt[swz<HD>(n * 8 + (lane & 7),
                                              part * 4 + (lane >> 3))]));
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n)
          mma_bf16(s[n], qf[2 * part], kf[n][0], kf[n][1]);
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n)
          mma_bf16(s[n], qf[2 * part + 1], kf[n][2], kf[n][3]);
      }
      // scale and mask; a tile that every row of the warp sees whole
      // skips the per-element test
      const bool whole = k0 + kMmaKeys <= Sk
                         && (!causal || k0 + kMmaKeys - 1 <= w_first)
                         && (window <= 0 || k0 > w_last - window);
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = w_first + g + (e >> 1) * 8;
          bool ok = whole;
          if (!whole) {
            ok = kpos < Sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
          }
          s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
        }
      }
      // online softmax for the thread's two rows (a row spans a quad), in
      // the base-2 domain; max and sum as trees, not serial chains
      float mx[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t[kMmaKeys / 8];
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n)
          t[n] = fmaxf(s[n][2 * i], s[n][2 * i + 1]);
#pragma unroll
        for (int w = kMmaKeys / 16; w > 0; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
        mx[i] = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_row[i], mx[i]);
        alpha[i] = (m_row[i] <= kNegInf) ? 0.f : exp2_approx(m_row[i] - m_new);
        m_row[i] = m_new;
        // a fully masked row subtracts 0, so its -1e30 scores give p = 0
        // (exp(NEG_INF - NEG_INF) = 1 otherwise): the JAX kernel's guard
        m_use[i] = (m_new <= kNegInf) ? 0.f : m_new;
      }
      float rs[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t[kMmaKeys / 8];
#pragma unroll
        for (int n = 0; n < kMmaKeys / 8; ++n) {
          s[n][2 * i] = exp2_approx(s[n][2 * i] - m_use[i]);
          s[n][2 * i + 1] = exp2_approx(s[n][2 * i + 1] - m_use[i]);
          t[n] = s[n][2 * i] + s[n][2 * i + 1];
        }
#pragma unroll
        for (int w = kMmaKeys / 16; w > 0; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) t[n] += t[n + w];
        rs[i] = t[0];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_part[i] = l_part[i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // PV: the probabilities of keys 16kk..16kk+15 as an A fragment
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, smem_u32(&Vt[swz<HD>(kk * 16 + (lane & 7)
                                                 + ((lane >> 3) & 1) * 8,
                                                 np * 2 + (lane >> 4))]));
          mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (a tile-less q tile)

  float l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] = l_part[i];
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
  }
  {
    // groups 1.. hand their state to group 0 through the K/V buffers
    float* red = reinterpret_cast<float*>(KVs);
    __syncthreads();
    if (grp > 0) {
      float* mine = red + ((grp - 1) * kRowWarps + rw) * kState * 32 + lane;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32] = acc[n][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mine[(HD / 2 + i) * 32] = m_row[i];
        mine[(HD / 2 + 2 + i) * 32] = l_row[i];
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int og = 1; og < kGroups; ++og) {
      const float* theirs =
          red + ((og - 1) * kRowWarps + rw) * kState * 32 + lane;
      float a_me[2], a_them[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_them = theirs[(HD / 2 + i) * 32];
        const float m_new = fmaxf(m_row[i], m_them);
        a_me[i] = (m_row[i] <= kNegInf) ? 0.f : exp2_approx(m_row[i] - m_new);
        a_them[i] = (m_them <= kNegInf) ? 0.f : exp2_approx(m_them - m_new);
        l_row[i] = l_row[i] * a_me[i]
                   + theirs[(HD / 2 + 2 + i) * 32] * a_them[i];
        m_row[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * a_me[e >> 1]
                      + theirs[(4 * n + e) * 32] * a_them[e >> 1];
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(l_row[i], 1e-30f);
    const int qi = q_row0 + rw * 16 + g + 8 * i;
    if (qi >= Sq) continue;
    bf16* op = o + (static_cast<size_t>(b) * Sq + qi) * q_stride
               + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < kRealChunks; ++n)   // the pad columns are dropped
      *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t4) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    // log-sum-exp in the natural-log domain (m is kept in base 2); +inf
    // for a fully masked row
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] =
          l_row[i] > 0.f
              ? (m_row[i] + log2f(l_row[i])) * 0.6931471805599453f
              : CUDART_INF_F;
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
               int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr int smem = MmaDims<D>::kSmemBytes;
  // once per process and head_dim: allow more than 48 KB of shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qt = (Sq + 16 * kRowWarps - 1) / (16 * kRowWarps);
  if (n_qt > 65535 || B > 65535) return kBadArgument;
  const dim3 grid(H, B, n_qt);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      KV, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
           int window, int q_offset, float scale, cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_fp32<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window,
                          q_offset, scale, s);
  if (dtype == kBFloat16)
    return launch_mma<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
  return kBadArgument;
}

// ---------------------------------------------------------------- backward
// The gradient of the forward above (no TPU counterpart: the JAX package
// differentiates its XLA reference, and its Pallas kernel has no
// custom_vjp), in the FlashAttention-2 scheme. With P = exp(scale * Q K^T
// - lse) (lse the forward's row log-sum-exp, +inf on a fully masked row,
// so P is 0 there) and masked entries 0:
//   delta = rowsum(dO * O)                     (flash_bwd_delta_kernel)
//   dV = P^T dO,  dK = scale * dS^T Q          (flash_bwd_dkdv_kernel)
//   dQ = scale * dS K,  dS = P * (dO V^T - delta)   (flash_bwd_dq_kernel)
//
// What bounds it: at the training shape (B 8, S 1024, 12/4 heads of 64,
// causal) the work is five products of (pairs x 64) each, ~32 GFLOP a
// call against ~0.1 GB of q/k/v/o/dO/dq/dk/dv, so operations: ~0.5 ms at
// fp32's 67 TFLOP/s. This first version runs every product on fp32 FMAs
// (bf16 inputs are widened as they are staged), 64-row tiles staged in
// shared memory as fp32 rows of the head_dim rounded up to 64, plus one
// float (the pad spreads a column over the banks; head_dim 120 is staged
// as 128 with zero columns, and its 8 padded columns are never stored),
// and P and dS as 64 x 65 tiles. Each of 256 threads owns a 4 x 4
// interleaved sub-tile of S and dP (rows ty + 16i, columns tx + 16j) and
// 4 x (head_dim / 16) of dK, dV or dQ; the shared-memory reads, two a
// multiply-add pair, bound it well below the FMA peak. At head_dim 128
// the dK/dV block takes 162 KB of shared memory and the dQ block 146 KB:
// one block an SM. Tensor cores (mma.sync for bf16, wgmma) are later
// work.
//
// dK/dV: one block per (key tile, KV head, batch) loops over the G query
// heads of its group and over the query tiles that see its keys, so the
// group's sum stays in the block's registers. dQ: one block per (query
// tile, head, batch) loops over its visible key tiles. Nothing is summed
// across blocks: no atomics, the same result on every run. The masks and
// tile skips are the forward's (causal, window, q_offset, key tail).
constexpr int kBT = 64;            // rows (queries or keys) of a tile
constexpr int kBwdThreads = 256;   // 16 x 16 threads, 4 x 4 elements each

template <int HD>
struct BwdDims {
  // head_dim columns a tile stages: 120 is padded to 128 with zero
  // columns, as the forward's MmaDims rounds it; a thread owns kJ of them
  static constexpr int kHDP = (HD + 63) / 64 * 64;
  static constexpr int kJ = kHDP / 16;
  static constexpr int kLd = kHDP + 1;               // floats a staged row
  static constexpr int kTile = kBT * kLd;            // floats a q/k/v/dO tile
  static constexpr int kLdP = kBT + 1;               // floats a P/dS row
  static constexpr int kPTile = kBT * kLdP;
  static constexpr int kDkdvSmem = (4 * kTile + 2 * kPTile + 2 * kBT) * 4;
  static constexpr int kDqSmem = (4 * kTile + kPTile + 2 * kBT) * 4;
  static_assert(HD == 64 || HD == 120 || HD == 128,
                "the backward is instantiated at head_dim 64, 120 and 128");
};

// Stage kBT rows of HD elements of two tensors into shared memory as fp32
// (row stride LD), as common.cuh's stage_tile does, and zero the columns
// from HD to LD - 1 (head_dim 120's padding to 128).
template <typename T, int HD, int LD, class Row>
__device__ __forceinline__ void stage_bwd(float* As, float* Bs, Row row) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kTotal = kBT * kPerRow;
  constexpr int kIters = (kTotal + kBwdThreads - 1) / kBwdThreads;
  static_assert(HD % kVec == 0, "rows must split into 16-byte vectors");
  uint4 abuf[kIters], bbuf[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * kBwdThreads;
    abuf[i] = bbuf[i] = make_uint4(0u, 0u, 0u, 0u);
    const T* ar;
    const T* br;
    if (idx < kTotal && row(idx / kPerRow, ar, br)) {
      const int c = idx % kPerRow;
      abuf[i] = reinterpret_cast<const uint4*>(ar)[c];
      bbuf[i] = reinterpret_cast<const uint4*>(br)[c];
    }
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * kBwdThreads;
    if (idx < kTotal) {
      const int t = idx / kPerRow;
      const int d0 = (idx % kPerRow) * kVec;
      const T* ae = reinterpret_cast<const T*>(&abuf[i]);
      const T* be = reinterpret_cast<const T*>(&bbuf[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        As[t * LD + d0 + e] = to_float(ae[e]);
        Bs[t * LD + d0 + e] = to_float(be[e]);
      }
    }
  }
  constexpr int kPad = LD - 1 - HD;
  if constexpr (kPad > 0) {
    for (int idx = threadIdx.x; idx < kBT * kPad; idx += kBwdThreads) {
      const int at = (idx / kPad) * LD + HD + idx % kPad;
      As[at] = 0.f;
      Bs[at] = 0.f;
    }
  }
}

// acc[i][j] += sum_{d < K} A[ty + 16i][d] * B[tx + 16j][d]   (A B^T)
template <int K, int L>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         float (&acc)[4][4], int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < K; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * L + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * L + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r A[r][ty + 16i] * B[r][tx + 16j]   (A^T B, r < kBT)
template <int J, int LA, int LB>
__device__ __forceinline__ void tile_atb(const float* A, const float* B,
                                         float (&acc)[4][J], int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kBT; ++r) {
    float a[4], b[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[r * LA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[r * LB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c A[ty + 16i][c] * B[c][tx + 16j]   (A B, c < kBT)
template <int J, int LA, int LB>
__device__ __forceinline__ void tile_ab(const float* A, const float* B,
                                        float (&acc)[4][J], int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < kBT; ++c) {
    float a[4], b[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LA + c];
#pragma unroll
    for (int j = 0; j < J; ++j) b[j] = B[c * LB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int J>
__device__ __forceinline__ void zero_tile(float (&a)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) a[i][j] = 0.f;
}

// delta[b][h][q] = sum_d dO * O in fp32: one warp a (b, q, h) row
template <typename T, int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int Sq,
                           int H) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * HD;
  const T* grow = dout + static_cast<size_t>(row) * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32)
    s = fmaf(to_float(orow[d]), to_float(grow[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H;
    const int bq = row / H;
    delta[(static_cast<size_t>(bq / Sq) * H + h) * Sq + bq % Sq] = s;
  }
}

// P and dS of one (query tile, key tile) pair into shared memory, from
// S = Q K^T and dP = dO V^T in registers; masked entries and rows past Sq
// are 0
__device__ __forceinline__ void probs_and_ds(
    const float (&sacc)[4][4], const float (&pacc)[4][4], float* Ps,
    float* dSs, const float* lse_s, const float* delta_s, int q_row0,
    int k0, int Sq, int Sk, int causal, int window, int q_offset,
    float scale, int ty, int tx) {
  constexpr int L = kBT + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q_row0 + r + q_offset;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      bool ok = q_row0 + r < Sq && kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float p = ok ? expf(sacc[i][j] * scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * L + c] = p;
      dSs[r * L + c] = p * (pacc[i][j] - delta_s[r]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                          int causal, int window, int q_offset, float scale) {
  using Dm = BwdDims<HD>;
  constexpr int L = Dm::kLd, LP = Dm::kLdP, J = Dm::kJ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + Dm::kTile;
  float* Qs = Vs + Dm::kTile;
  float* dOs = Qs + Dm::kTile;
  float* Ps = dOs + Dm::kTile;
  float* dSs = Ps + Dm::kPTile;
  float* lse_s = dSs + Dm::kPTile;
  float* delta_s = lse_s + kBT;
  const int k0 = blockIdx.x * kBT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const T* kb = k + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
  const T* vb = v + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
  stage_bwd<T, HD, L>(
      Ks, Vs, [&](int r, const T*& kr, const T*& vr) {
        if (k0 + r >= Sk) return false;
        kr = kb + (k0 + r) * kv_stride;
        vr = vb + (k0 + r) * kv_stride;
        return true;
      });
  const int k_last = min(k0 + kBT, Sk) - 1;
  float dk_acc[4][J], dv_acc[4][J];
  zero_tile(dk_acc);
  zero_tile(dv_acc);
  const int n_qt = (Sq + kBT - 1) / kBT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + h * HD;
    const T* gb = dout + static_cast<size_t>(b) * Sq * q_stride + h * HD;
    const float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* db = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_row0 = qt * kBT;
      const int first = q_row0 + q_offset;
      const int last = min(q_row0 + kBT, Sq) - 1 + q_offset;
      // block-uniform skips: every row of the tile before the key tile
      // (causal), or every key of the tile before every row's window
      if (causal && last < k0) continue;
      if (window > 0 && k_last <= first - window) continue;
      __syncthreads();   // the previous query tile has been consumed
      stage_bwd<T, HD, L>(
          Qs, dOs, [&](int r, const T*& qr, const T*& gr) {
            if (q_row0 + r >= Sq) return false;
            qr = qb + (q_row0 + r) * q_stride;
            gr = gb + (q_row0 + r) * q_stride;
            return true;
          });
      if (tid < kBT) {
        const bool in = q_row0 + tid < Sq;
        lse_s[tid] = in ? lb[q_row0 + tid] : CUDART_INF_F;
        delta_s[tid] = in ? db[q_row0 + tid] : 0.f;
      }
      __syncthreads();
      float sacc[4][4], pacc[4][4];
      zero_tile(sacc);
      zero_tile(pacc);
      tile_abt<HD, L>(Qs, Ks, sacc, ty, tx);
      tile_abt<HD, L>(dOs, Vs, pacc, ty, tx);
      probs_and_ds(sacc, pacc, Ps, dSs, lse_s, delta_s, q_row0, k0, Sq, Sk,
                   causal, window, q_offset, scale, ty, tx);
      __syncthreads();
      tile_atb<J, LP, L>(Ps, dOs, dv_acc, ty, tx);
      tile_atb<J, LP, L>(dSs, Qs, dk_acc, ty, tx);
    }
  }
  T* dkb = dk + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
  T* dvb = dv + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int d = tx + 16 * j;
      if (d >= HD) continue;     // head_dim 120's padding
      dkb[kp * kv_stride + d] = from_float<T>(dk_acc[i][j] * scale);
      dvb[kp * kv_stride + d] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, int KV, int causal, int window,
                        int q_offset, float scale) {
  using Dm = BwdDims<HD>;
  constexpr int L = Dm::kLd, LP = Dm::kLdP, J = Dm::kJ;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + Dm::kTile;
  float* Ks = dOs + Dm::kTile;
  float* Vs = Ks + Dm::kTile;
  float* dSs = Vs + Dm::kTile;
  float* lse_s = dSs + Dm::kPTile;
  float* delta_s = lse_s + kBT;
  // heaviest first, as the forward: the last causal query tiles walk the
  // most key tiles
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const int q_row0 = qt * kBT;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + h * HD;
  const T* gb = dout + static_cast<size_t>(b) * Sq * q_stride + h * HD;
  stage_bwd<T, HD, L>(
      Qs, dOs, [&](int r, const T*& qr, const T*& gr) {
        if (q_row0 + r >= Sq) return false;
        qr = qb + (q_row0 + r) * q_stride;
        gr = gb + (q_row0 + r) * q_stride;
        return true;
      });
  if (tid < kBT) {
    const bool in = q_row0 + tid < Sq;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + q_row0 + tid;
    lse_s[tid] = in ? lse[at] : CUDART_INF_F;
    delta_s[tid] = in ? delta[at] : 0.f;
  }
  const T* kb = k + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
  const T* vb = v + static_cast<size_t>(b) * Sk * kv_stride + kvh * HD;
  // the key tiles this query tile sees, with the forward's skips
  const int q_start = q_row0 + q_offset;
  const int q_last = min(q_row0 + kBT, Sq) - 1 + q_offset;
  const int n_kt = (Sk + kBT - 1) / kBT;
  int t_end = n_kt;
  if (causal) t_end = q_last < 0 ? 0 : min(n_kt, q_last / kBT + 1);
  int t_begin = 0;
  if (window > 0) {
    const int x = q_start - window - kBT + 1;   // last skipped k0
    t_begin = x < 0 ? 0 : x / kBT + 1;
  }
  float dq_acc[4][J];
  zero_tile(dq_acc);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBT;
    __syncthreads();   // the previous key tile has been consumed
    stage_bwd<T, HD, L>(
        Ks, Vs, [&](int r, const T*& kr, const T*& vr) {
          if (k0 + r >= Sk) return false;
          kr = kb + (k0 + r) * kv_stride;
          vr = vb + (k0 + r) * kv_stride;
          return true;
        });
    __syncthreads();
    float sacc[4][4], pacc[4][4];
    zero_tile(sacc);
    zero_tile(pacc);
    tile_abt<HD, L>(Qs, Ks, sacc, ty, tx);
    tile_abt<HD, L>(dOs, Vs, pacc, ty, tx);
    probs_and_ds(sacc, pacc, nullptr, dSs, lse_s, delta_s, q_row0, k0, Sq,
                 Sk, causal, window, q_offset, scale, ty, tx);
    __syncthreads();
    tile_ab<J, LP, L>(dSs, Ks, dq_acc, ty, tx);
  }
  T* dqb = dq + static_cast<size_t>(b) * Sq * q_stride + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_row0 + ty + 16 * i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (tx + 16 * j < HD)      // head_dim 120's padding
        dqb[qi * q_stride + tx + 16 * j] =
            from_float<T>(dq_acc[i][j] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int causal, int window, int q_offset, float scale,
               cudaStream_t stream) {
  using Dm = BwdDims<HD>;
  // once per instantiation: allow more than 48 KB of shared memory
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Dm::kDkdvSmem);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Dm::kDqSmem);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  const int n_qt = (Sq + kBT - 1) / kBT;
  const int n_kt = (Sk + kBT - 1) / kBT;
  if (B > 65535 || H > 65535) return kBadArgument;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T, HD><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), gt, delta, rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3(n_kt, KV, B), kBwdThreads, Dm::kDkdvSmem, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Sk, H, KV, causal, window, q_offset,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HD>
      <<<dim3(n_qt, H, B), kBwdThreads, Dm::kDqSmem, stream>>>(
          qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KV,
          causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int D, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                 int Sk, int H, int KV, int causal, int window, int q_offset,
                 float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Sq, Sk, H, KV, causal, window, q_offset,
                               scale, s);
    case 120:
      return launch_bwd<T, 120>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Sk, H, KV, causal, window, q_offset,
                                scale, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Sk, H, KV, causal, window, q_offset,
                                scale, s);
    default:
      return kBadArgument;
  }
}

}  // namespace
}  // namespace repro

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); all contiguous; H % KV == 0;
// D in {64, 120, 128} (the head dims of the ported configs). lse: null, or
// (B, H, Sq) fp32 for each row's log-sum-exp (the backward's input).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse, int B,
                                     int Sq, int Sk, int H, int KV, int D,
                                     int causal, int window, int q_offset,
                                     float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                        window, q_offset, scale, s);
    case 120:
      return launch<120>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                         window, q_offset, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, l, B, Sq, Sk, H, KV, causal,
                         window, q_offset, scale, s);
    default:
      return kBadArgument;
  }
}

// The gradient of repro_flash_attention: q, o, dout, dq: (B, Sq, H, D);
// k, v, dk, dv: (B, Sk, KV, D); lse: the forward's (B, H, Sq) fp32; delta:
// (B, H, Sq) fp32 scratch; all contiguous; D in {64, 120, 128}.
extern "C" int repro_flash_attention_backward(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KV, int D, int causal,
    int window, int q_offset, float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == kFloat32)
    return dispatch_bwd<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq,
                               Sk, H, KV, causal, window, q_offset, scale, s);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk,
                                       dv, B, Sq, Sk, H, KV, causal, window,
                                       q_offset, scale, s);
  return kBadArgument;
}
