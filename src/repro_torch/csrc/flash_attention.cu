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
#include "hopper.cuh"

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
// The gradient of the forward above. No TPU kernel stands behind it: the
// JAX package differentiates its XLA reference (its Pallas kernel,
// repro/kernels/flash_attention/kernel.py `flash_attention`, has no
// custom_vjp), and the trainer needs a gradient of this forward. It runs
// in the FlashAttention-2 scheme: with P = exp(scale * Q K^T - lse) (lse
// the forward's row log-sum-exp, +inf on a row that sees no key, so P is
// 0 there) and masked entries 0,
//   delta = rowsum(dO * O)                          flash_bwd_delta_kernel
//   dV = P^T dO,  dK = scale * dS^T Q               the dK/dV kernels
//   dQ = scale * dS K,  dS = P * (dO V^T - delta)   the dQ kernels
// The dK/dV grid has one block per (64-key tile, KV head, batch, share of
// the group's query heads); it walks the (query head, query tile) pairs
// that see its keys and keeps dK and dV in registers. The dQ grid has one
// block per (64-row query tile, head, batch) and walks the key tiles its
// rows see, recomputing S and dP (two products: the price of a result
// without atomics). When the dK/dV blocks would fill fewer than about two
// waves of the 132 SMs (few KV heads, short sequences: 64/4 heads of 128
// at 1024 rows gives 64 blocks), the wrapper splits each group's query
// heads over `splits` blocks; each writes fp32 partial sums, and
// flash_bwd_split_sum_kernel adds them in split order. Nothing is summed
// with atomics, so a second call gives the same bits. The masks and tile
// skips are the forward's (causal, window, q_offset, ragged tails).
//
// What bounds it on the H100: five products of (visible pairs x
// head_dim), far more operations than bytes (B 8, S 1024, 12/4 heads of
// 64, causal: 32 GFLOP against 0.1 GB), so operations, on both dtypes:
// the tensor cores in bf16, the FMA pipes in fp32; and a dK/dV grid of
// one block a (key tile, KV head, batch) leaves most SMs idle at few KV
// heads, hence the split above.
//
// bf16 (tensor cores, whose rate only wgmma reaches): a block is one
// consumer warpgroup and one producer warp. The producer brings every
// tile in by TMA (cp.async.bulk.tensor; 4-D maps of the (B, S, heads, D)
// tensors, 64 x 64 boxes, 128-byte swizzle, zero fill past the ragged
// tails and head_dim 120's last 8 columns) into a ring of stages, each
// completing on an mbarrier (with, in dK/dV, the tile's lse and delta by
// cp.async), and the consumers release a stage on another. dK/dV: K and V
// rest in shared memory; for each query tile, S^T = K Q^T and dP^T = V
// dO^T run as wgmma m64n64k16 from shared memory into fp32 registers
// (keys on the accumulator's rows, the register layout of wgmma's A
// operand); P^T and dS^T are formed in registers, rounded once each to
// bf16, and feed dV += P^T dO and dK += dS^T Q as the register A operand
// against dO and Q read MN-major from shared memory. dQ: Q and dO rest;
// per key tile S = Q K^T, dP = dO V^T, then dQ += dS K (K MN-major).
// Head_dim 120 runs as 128 with zero columns. The exponent runs on the
// special-function unit (ex2.approx), and the per-pair visibility test
// only on tiles that need it (a causal diagonal, a window's edge, a
// ragged tail): evaluated on every tile it cost more than the products.
// At head_dim 128 the dK/dV consumers hold 128 accumulator registers of
// dK and dV beside the 64 of S^T and dP^T (no spills; one block an SM).
//
// fp32 (FMAs: tensor cores would mean TF32, and the trainer's steps are
// held to 1e-4 of the CPU's): a 256-thread block is two groups of 128. On
// each tile one group computes S^T (S in the dQ kernel) and the other
// dP^T, each thread a register micro-tile fed by 16-byte loads along
// head_dim; then one group adds P^T dO into dV and the other dS^T Q into
// dK as outer products over the query rows (dQ: both groups, dS K over
// the keys); the dV group starts as soon as P is written, while the
// other forms dS. At head_dim 64 the dK/dV block holds 128 keys and the
// dQ block 128 query rows, so every product is an 8 x 8 micro-tile (4
// multiply-adds a float loaded); at 120 and 128 the tiles are 64 rows
// (8 x 4 and 8 x 8) and fill the shared memory. Tiles are fp32 rows
// padded by one 16-byte chunk, which leaves the loops without index
// arithmetic, where they fit (dK/dV at head_dim 64, dQ at all), else
// with chunks XORed by the row's bits 0-2 and 3-5; either keeps every
// vector load free of bank conflicts. The next tile is copied in with
// cp.async while the current one computes; P and dS pass between the
// groups through shared memory.
constexpr int kBT = 64;            // rows (queries or keys) of a tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// which (query, key) pairs count, and which tiles have any
struct Visibility {
  int Sq, Sk, causal, window, q_offset;

  // the nq query rows from q0 see some key of the nk keys from k0
  __device__ __forceinline__ bool tiles(int q0, int nq, int k0,
                                        int nk) const {
    const int k_last = min(k0 + nk, Sk) - 1;
    const int first = q0 + q_offset;
    const int last = min(q0 + nq, Sq) - 1 + q_offset;
    if (causal && last < k0) return false;
    if (window > 0 && k_last <= first - window) return false;
    return true;
  }
  __device__ __forceinline__ bool tiles(int q0, int k0) const {
    return tiles(q0, kBT, k0, kBT);
  }
  // every pair of the two tiles counts (no mask needed)
  __device__ __forceinline__ bool whole(int q0, int nq, int k0,
                                        int nk) const {
    if (q0 + nq > Sq || k0 + nk > Sk) return false;
    if (causal && k0 + nk - 1 > q0 + q_offset) return false;
    if (window > 0 && k0 <= q0 + nq - 1 + q_offset - window) return false;
    return true;
  }
  __device__ __forceinline__ bool whole(int q0, int k0) const {
    return whole(q0, kBT, k0, kBT);
  }
  __device__ __forceinline__ bool pair(int qrow, int kpos) const {
    bool ok = qrow < Sq && kpos < Sk;
    const int qpos = qrow + q_offset;
    if (causal) ok = ok && kpos <= qpos;
    if (window > 0) ok = ok && kpos > qpos - window;
    return ok;
  }
};

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

// dk = scale * sum_s part[0][s], dv = sum_s part[1][s], in split order
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_split_sum_kernel(const float* __restrict__ part,
                               T* __restrict__ dk, T* __restrict__ dv,
                               size_t n, int splits, float scale) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[s * n + i];
      c += part[(splits + s) * n + i];
    }
    dk[i] = from_float<T>(a * scale);
    dv[i] = from_float<T>(c);
  }
}

// where a bf16 dK/dV block writes two neighbouring columns: the outputs
// themselves (dK scaled, both rounded), or, when the group is split, its
// fp32 partial sums
template <int HD>
struct DkdvOut {
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;   // [2][splits][B][Sk][KV][HD] fp32, or null
  int splits, split, b, kvh, Sk, KV, B;
  float scale;

  __device__ __forceinline__ void put(int kpos, int d, float k0v, float k1v,
                                      float v0, float v1) const {
    const size_t at =
        ((static_cast<size_t>(b) * Sk + kpos) * KV + kvh) * HD + d;
    if (part == nullptr) {
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(k0v * scale, k1v * scale);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(v0, v1);
    } else {
      const size_t n = static_cast<size_t>(B) * Sk * KV * HD;
      *reinterpret_cast<float2*>(part + split * n + at) =
          make_float2(k0v, k1v);
      *reinterpret_cast<float2*>(part + (splits + split) * n + at) =
          make_float2(v0, v1);
    }
  }
};

// ------------------------------------------------ bf16: wgmma fed by TMA
constexpr int kWgThreads = 160;   // one consumer warpgroup + a producer warp
// tiles in flight ahead of the consumers: four, but two in the dQ kernel
// above head_dim 64, where two blocks an SM then fit in shared memory
constexpr int kStages = 4;
template <int HD>
constexpr int dq_stages() {
  return HD == 64 ? 4 : 2;
}

template <int HD>
struct WgDims {
  static constexpr int kHDP = (HD + 63) / 64 * 64;   // 120 runs as 128
  static constexpr int kBoxes = kHDP / 64;           // 64-column boxes
  static constexpr int kBox = 64 * 64 * 2;           // bytes of a box
  static constexpr int kTile = kBoxes * kBox;        // bytes of 64 rows
  static constexpr int kAcc = kHDP / 2;   // fp32 registers of a 64 x kHDP
  // dK/dV: K, V; per stage Q, dO and the rows' lse and delta;
  // then the barriers. The extra 1024 bytes align the tiles for the
  // swizzle.
  static constexpr int kDkdvBars = 2 * kTile + kStages * 2 * kTile
                                   + kStages * 2 * kBT * 4;
  static constexpr int kDkdvSmem = 1024 + kDkdvBars + (1 + 2 * kStages) * 8;
  // dQ: Q, dO; per stage K, V; then the barriers
  static constexpr int kDqStages = dq_stages<HD>();
  static constexpr int kDqBars = 2 * kTile + kDqStages * 2 * kTile;
  static constexpr int kDqSmem = 1024 + kDqBars + (1 + 2 * kDqStages) * 8;
  static_assert(HD == 64 || HD == 120 || HD == 128,
                "the backward is instantiated at head_dim 64, 120 and 128");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// K-major descriptor of k16 step kk of a 64-row tile (k along the row)
template <int HD>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
  return sw128_desc(smem_u32(tile) + (kk >> 2) * WgDims<HD>::kBox +
                        (kk & 3) * 32,
                    16, 1024);
}
// MN-major descriptor of k16 step kk of a 64-row tile (k down the rows)
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
  return sw128_desc(smem_u32(tile) + kk * 2048, WgDims<HD>::kBox, 1024);
}

// acc (+)= A B^T over the tile's head_dim: A, B 64-row tiles, K-major
template <int HD>
__device__ __forceinline__ void gemm_rows(float (&acc)[32], const uint8_t* a,
                                          const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < WgDims<HD>::kHDP / 16; ++kk)
    wgmma_ss_m64n64(acc, kmajor<HD>(a, kk), kmajor<HD>(b, kk), kk > 0);
}

// acc += A B: A the 64 x 64 register operand (four k16 steps), B a 64-row
// tile read MN-major (its rows are the product's k)
template <int HD>
__device__ __forceinline__ void gemm_regs(float (&acc)[WgDims<HD>::kAcc],
                                          const uint32_t (&a)[4][4],
                                          const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (WgDims<HD>::kHDP == 64)
      wgmma_rs_m64n64_mn(acc, a[kk], mnmajor<HD>(b, kk));
    else
      wgmma_rs_m64n128_mn(acc, a[kk], mnmajor<HD>(b, kk));
  }
}

// issue the TMA loads of one 64-row tile (every 64-column box)
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int x = 0; x < WgDims<HD>::kBoxes; ++x)
    tma_load_4d(dst + x * WgDims<HD>::kBox, m, bar, x * 64, head, row0, b);
}

// P^T and dS^T of a dK/dV consumer thread, rounded to bf16 in the register
// layout of wgmma's A operand. The thread holds S^T and dP^T at key rows
// `key` and key + 8 (its warp's and lane's) and query columns
// 8j + 2 tq4 (+ 1) of the tile at q0; lse and delta of the tile's queries
// are in shared memory. kMasked applies the visibility of each pair (the
// tiles on a causal diagonal, a window's edge, a ragged tail); a tile that
// is wholly visible takes the loop without it.
template <bool kMasked>
__device__ __forceinline__ void dkdv_probs(const float (&s)[32],
                                           const float (&dp)[32],
                                           const float* lse_s,
                                           const float* dl_s,
                                           uint32_t (&pa)[4][4],
                                           uint32_t (&da)[4][4], float sl2,
                                           const Visibility& vis, int q0,
                                           int key, int tq4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {      // queries 8j .. 8j + 7
    float pv[4], dsv[4];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int qc = 8 * j + 2 * tq4 + x;
      const float nl = -lse_s[qc] * kLog2e, dl = dl_s[qc];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 2 * half + x;
        float p = fast_exp2(fmaf(s[4 * j + e], sl2, nl));
        if (kMasked && !vis.pair(q0 + qc, key + 8 * half)) p = 0.f;
        pv[e] = p;
        dsv[e] = p * (dp[4 * j + e] - dl);
      }
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(pv[0], pv[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    da[j >> 1][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
    da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
  }
}

// dS of a dQ consumer thread (rows `row` and row + 8, key columns
// 8j + 2 tq4 (+ 1) of the tile at k0), as dkdv_probs; ls holds the two
// rows' lse x log2 e, dls their delta
template <bool kMasked>
__device__ __forceinline__ void dq_probs(const float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&ls)[2],
                                         const float (&dls)[2],
                                         uint32_t (&da)[4][4], float sl2,
                                         const Visibility& vis, int row,
                                         int k0, int tq4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {        // keys 8j .. 8j + 7
    float dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(s[4 * j + e], sl2, -ls[e >> 1]));
      if (kMasked &&
          !vis.pair(row + ((e & 2) ? 8 : 0), k0 + 8 * j + 2 * tq4 + (e & 1)))
        p = 0.f;
      dsv[e] = p * (dp[4 * j + e] - dls[e >> 1]);
    }
    da[j >> 1][(j & 1) * 2] = pack_bf16(dsv[0], dsv[1]);
    da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int B, int Sq,
    int Sk, int H, int KV, int splits, Visibility vis, float scale) {
  using Dm = WgDims<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + Dm::kTile;
  uint8_t* stages = Vs + Dm::kTile;   // stage s: Q, then dO
  float* lse_s = reinterpret_cast<float*>(stages + kStages * 2 * Dm::kTile);
  float* dl_s = lse_s + kStages * kBT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Dm::kDkdvBars);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;
  const int k0 = blockIdx.x * kBT;
  const int kvh = blockIdx.y / splits;
  const int split = blockIdx.y % splits;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int g_begin = split * (G / splits);
  const int g_end = g_begin + G / splits;
  const int n_qt = (Sq + kBT - 1) / kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      // the producer's lane 0 (with the TMA bytes) and its 32 lanes'
      // lse/delta copies
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 128);   // the consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: K and V once, then Q, dO, lse, delta of each visible
    // (query head, query tile), up to kStages ahead of the consumers
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * Dm::kTile);
      load_tile<HD>(Ks, &tk, kv_bar, kvh, k0, b);
      load_tile<HD>(Vs, &tv, kv_bar, kvh, k0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = g_begin; g < g_end; ++g) {
      const int h = kvh * G + g;
      const float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
      const float* db = delta + (static_cast<size_t>(b) * H + h) * Sq;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * kBT;
        if (!vis.tiles(q0, k0)) continue;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* Qs = stages + stage * 2 * Dm::kTile;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * Dm::kTile);
          load_tile<HD>(Qs, &tq, &full[stage], h, q0, b);
          load_tile<HD>(Qs + Dm::kTile, &tdo, &full[stage], h, q0, b);
        }
        // rows past Sq arrive as 0 (the consumers mask them)
        for (int r = lane; r < kBT; r += 32) {
          const bool in = q0 + r < Sq;
          cp_async4(lse_s + stage * kBT + r, in ? lb + q0 + r : lb, in);
          cp_async4(dl_s + stage * kBT + r, in ? db + q0 + r : db, in);
        }
        cp_async_arrive(&full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, keys 16 * warp + (lane / 4) (+ 8)
  const int gq = lane / 4, tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float dk_acc[Dm::kAcc], dv_acc[Dm::kAcc];
#pragma unroll
  for (int i = 0; i < Dm::kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int g = g_begin; g < g_end; ++g) {
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBT;
      if (!vis.tiles(q0, k0)) continue;
      mbar_wait(&full[stage], phase);
      const uint8_t* Qs = stages + stage * 2 * Dm::kTile;
      const uint8_t* dOs = Qs + Dm::kTile;
      float s[32], dp[32];
      wgmma_fence();
      gemm_rows<HD>(s, Ks, Qs);     // S^T = K Q^T
      gemm_rows<HD>(dp, Vs, dOs);   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      uint32_t pa[4][4], da[4][4];
      if (vis.whole(q0, k0))
        dkdv_probs<false>(s, dp, lse_s + stage * kBT, dl_s + stage * kBT, pa,
                          da, sl2, vis, q0, k0 + 16 * warp + gq, tq4);
      else
        dkdv_probs<true>(s, dp, lse_s + stage * kBT, dl_s + stage * kBT, pa,
                         da, sl2, vis, q0, k0 + 16 * warp + gq, tq4);
      wgmma_fence();
      gemm_regs<HD>(dv_acc, pa, dOs);   // dV += P^T dO
      gemm_regs<HD>(dk_acc, da, Qs);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  const DkdvOut<HD> out{dk, dv, part, splits, split, b, kvh, Sk, KV, B,
                        scale};
#pragma unroll
  for (int j = 0; j < Dm::kHDP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = k0 + 16 * warp + gq + 8 * half;
      const int d = 8 * j + 2 * tq4;
      if (kpos < Sk && d < HD)
        out.put(kpos, d, dk_acc[4 * j + 2 * half],
                dk_acc[4 * j + 2 * half + 1], dv_acc[4 * j + 2 * half],
                dv_acc[4 * j + 2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int H, int KV, Visibility vis, float scale) {
  using Dm = WgDims<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Qs = base;
  uint8_t* dOs = Qs + Dm::kTile;
  uint8_t* stages = dOs + Dm::kTile;   // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Dm::kDqBars);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + Dm::kDqStages;
  // heaviest first, as the forward: the last causal query tiles walk the
  // most key tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int n_kt = (Sk + kBT - 1) / kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < Dm::kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Q and dO once, then K and V of each visible key tile
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * Dm::kTile);
      load_tile<HD>(Qs, &tq, q_bar, h, q0, b);
      load_tile<HD>(dOs, &tdo, q_bar, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        if (!vis.tiles(q0, t * kBT)) continue;
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* Ks = stages + stage * 2 * Dm::kTile;
        mbar_expect_tx(&full[stage], 2 * Dm::kTile);
        load_tile<HD>(Ks, &tk, &full[stage], kvh, t * kBT, b);
        load_tile<HD>(Ks + Dm::kTile, &tv, &full[stage], kvh, t * kBT, b);
        if (++stage == Dm::kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: rows 16 * warp + (lane / 4) (+ 8)
  const int gq = lane / 4, tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float ls[2], dls[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + 16 * warp + gq + 8 * half;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + qi;
    ls[half] = qi < Sq ? lse[at] * kLog2e : CUDART_INF_F;
    dls[half] = qi < Sq ? delta[at] : 0.f;
  }
  float dq_acc[Dm::kAcc];
#pragma unroll
  for (int i = 0; i < Dm::kAcc; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kBT;
    if (!vis.tiles(q0, k0)) continue;
    mbar_wait(&full[stage], phase);
    const uint8_t* Ks = stages + stage * 2 * Dm::kTile;
    const uint8_t* Vs = Ks + Dm::kTile;
    float s[32], dp[32];
    wgmma_fence();
    gemm_rows<HD>(s, Qs, Ks);     // S = Q K^T
    gemm_rows<HD>(dp, dOs, Vs);   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t da[4][4];
    if (vis.whole(q0, k0))
      dq_probs<false>(s, dp, ls, dls, da, sl2, vis, q0 + 16 * warp + gq, k0,
                      tq4);
    else
      dq_probs<true>(s, dp, ls, dls, da, sl2, vis, q0 + 16 * warp + gq, k0,
                     tq4);
    wgmma_fence();
    gemm_regs<HD>(dq_acc, da, Ks);    // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(da);
    mbar_arrive(&empty[stage]);
    if (++stage == Dm::kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  __nv_bfloat16* dqb = dq + static_cast<size_t>(b) * Sq * H * HD +
                       static_cast<size_t>(h) * HD;
#pragma unroll
  for (int j = 0; j < Dm::kHDP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = q0 + 16 * warp + gq + 8 * half;
      const int d = 8 * j + 2 * tq4;
      if (qi < Sq && d < HD)
        *reinterpret_cast<uint32_t*>(dqb + static_cast<size_t>(qi) * H * HD +
                                     d) =
            pack_bf16(dq_acc[4 * j + 2 * half] * scale,
                      dq_acc[4 * j + 2 * half + 1] * scale);
    }
  }
}

// ------------------------------------- fp32: register-tiled FMAs, cp.async
constexpr int kF32Threads = 256;   // two groups of 128

// Tile geometry of the fp32 kernels: a dK/dV block holds BC keys against
// 64-row query tiles, a dQ block BR query rows against 64-key tiles; 128
// at head_dim 64 (8 x 8 register micro-tiles on every product), 64 at 120
// and 128 (the tiles of 128 columns fill the shared memory).
template <int HD>
struct F32Dims {
  static constexpr int kHDP = (HD + 63) / 64 * 64;   // 120 runs as 128
  static constexpr int kC = kHDP / 4;                // 16-byte chunks a row
  static constexpr int kBC = kHDP == 64 ? 128 : 64;  // keys, dK/dV block
  static constexpr int kBR = kHDP == 64 ? 128 : 64;  // query rows, dQ block
  // Rows are padded by one 16-byte chunk (no index arithmetic in the
  // loops) where the tiles still fit: the dK/dV kernel at head_dim 64 and
  // the dQ kernel; the dK/dV kernel at 120 and 128 swizzles instead.
  static constexpr bool kPadKV = kHDP == 64;
  static constexpr bool kPadQ = true;
  // dK/dV: K, V (BC rows); two stages of Q, dO (64 rows); P, dS [64][BC]
  static constexpr int kLdKV = kHDP + (kPadKV ? 4 : 0);   // floats a row
  static constexpr int kLdP = kBC + (kPadKV ? 4 : 0);     // of a P/dS row
  static constexpr int kDkdvSmem =
      (2 * kBC * kLdKV + 4 * kBT * kLdKV + 2 * kBT * kLdP) * 4;
  // dQ: Q, dO (BR rows); two stages of K, V (64 rows); P then dS [64][BR]
  static constexpr int kLdQ = kHDP + 4;
  static constexpr int kLdPQ = kBR + 4;
  static constexpr int kDqSmem =
      (2 * kBR * kLdQ + 4 * kBT * kLdQ + kBT * kLdPQ) * 4;
  static_assert(HD == 64 || HD == 120 || HD == 128,
                "the backward is instantiated at head_dim 64, 120 and 128");
};

// float offset of 16-byte chunk c of row r in a tile of W-float rows:
// padded rows of W + 4 floats, or rows of W with the chunk XORed with the
// row's bits 0-2 and 3-5. Either way the eight rows r .. r + 7, which a
// quarter-warp reads at one chunk, land in distinct banks; swizzled, so
// do rows r + 8 j.
template <int W, bool PAD>
__device__ __forceinline__ int fswz(int r, int c) {
  if constexpr (PAD) return r * (W + 4) + (c << 2);
  return r * W + ((c ^ ((r ^ (r >> 3)) & 7)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// cp.async NR rows of a (B, S, N, D) fp32 tensor (head n, rows from row0)
// into a swizzled tile; rows past S and head_dim 120's last 8 columns are
// zeros
template <int HD, int NR, bool PAD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int S, int N, int row0, int n,
                                          int b) {
  using Dm = F32Dims<HD>;
  const size_t stride = static_cast<size_t>(N) * HD;
  const float* base = src + static_cast<size_t>(b) * S * stride +
                      static_cast<size_t>(n) * HD;
  for (int i = threadIdx.x; i < NR * Dm::kC; i += kF32Threads) {
    const int r = i / Dm::kC, c = i % Dm::kC;
    const bool ok = row0 + r < S && c * 4 < HD;
    const float* from = ok ? base + (row0 + r) * stride + c * 4 : src;
    cp_async16(smem_u32(dst + fswz<Dm::kHDP, PAD>(r, c)), from, ok);
  }
}

// An 8 x NB micro-tile of A B^T over head_dim: rows a0 .. a0 + 7 of A
// (shared by the thread's quarter-warp: broadcast loads), rows b0 + SB * i
// of B (distinct rows % 8 across the quarter-warp: no bank conflicts), 16
// bytes a load along head_dim
template <int HD, int NB, int SB, bool PAD>
__device__ __forceinline__ void rows_dot(float (&acc)[8][NB], const float* A,
                                         int a0, const float* Bm, int b0) {
  using Dm = F32Dims<HD>;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < NB; ++i) acc[j][i] = 0.f;
#pragma unroll 2
  for (int c = 0; c < Dm::kC; ++c) {
    float4 bv[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i)
      bv[i] = ld4(Bm + fswz<Dm::kHDP, PAD>(b0 + SB * i, c));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 av = ld4(A + fswz<Dm::kHDP, PAD>(a0 + j, c));
#pragma unroll
      for (int i = 0; i < NB; ++i) acc[j][i] = dot4(av, bv[i], acc[j][i]);
    }
  }
}

// acc[j][4x + e] += sum_r P[r][p0 .. p0 + 7] (x) O[r][chunks o0 + SO * x]:
// an outer-product micro-tile of 8 columns of P against NO chunks of O
// over R rows
template <int R, int WP, int WO, int NO, int SO, bool PAD>
__device__ __forceinline__ void outer(float (&acc)[8][4 * NO], const float* P,
                                      int pc, const float* O, int o0) {
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    const float4 p0 = ld4(P + fswz<WP, PAD>(r, pc));
    const float4 p1 = ld4(P + fswz<WP, PAD>(r, pc + 1));
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    float ov[4 * NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) {
      const float4 o4 = ld4(O + fswz<WO, PAD>(r, o0 + SO * x));
      ov[4 * x] = o4.x;
      ov[4 * x + 1] = o4.y;
      ov[4 * x + 2] = o4.z;
      ov[4 * x + 3] = o4.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4 * NO; ++e)
        acc[j][e] = fmaf(pv[j], ov[e], acc[j][e]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ part, int B, int Sq, int Sk,
                       int H, int KV, int splits, Visibility vis,
                       float scale) {
  using Dm = F32Dims<HD>;
  constexpr int W = Dm::kHDP, BC = Dm::kBC;
  constexpr int NQ = BC / 16;          // queries a thread in phase 1
  constexpr int QB = kBT / NQ;         // query blocks (16 or 8)
  constexpr int NO = BC * W / 128 / 8 / 4;   // dV/dK chunks a thread
  constexpr int DB = Dm::kC / NO;      // d blocks (16 or 8)
  extern __shared__ __align__(16) float fsm[];
  constexpr int LD = Dm::kLdKV, LDP = Dm::kLdP;
  constexpr bool PAD = Dm::kPadKV;
  float* Ks = fsm;
  float* Vs = Ks + BC * LD;
  float* Qst = Vs + BC * LD;            // stage s: Q at 2s tiles, dO after
  float* Ps = Qst + 4 * kBT * LD;       // [query][key]
  float* dSs = Ps + kBT * LDP;          // [query][key]
  const int k0 = blockIdx.x * BC;
  const int kvh = blockIdx.y / splits;
  const int split = blockIdx.y % splits;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int g_begin = split * (G / splits);
  const int g_end = g_begin + G / splits;
  const int n_qt = (Sq + kBT - 1) / kBT;
  const int grp = threadIdx.x / 128;    // 0: S, P, dV; 1: dP, dS, dK
  const int lt = threadIdx.x % 128;
  const int kb = lt / QB, qb = lt % QB;  // keys kb*8 + j, queries qb + QB i
  const int kb2 = lt / DB, db = lt % DB; // keys kb2*8 + j, chunks db + DB x
  const float sl2 = scale * kLog2e;

  // the visible (query head, query tile) pairs in order
  int g = g_begin, qt = -1;
  auto next = [&](int& gg, int& tt) {
    for (;;) {
      if (++tt == n_qt) {
        tt = 0;
        if (++gg >= g_end) return false;
      }
      if (gg < g_end && vis.tiles(tt * kBT, kBT, k0, BC)) return true;
    }
  };
  bool have = g < g_end && next(g, qt);
  copy_rows<HD, BC, PAD>(Ks, k, Sk, KV, k0, kvh, b);
  copy_rows<HD, BC, PAD>(Vs, v, Sk, KV, k0, kvh, b);
  if (have) {
    copy_rows<HD, kBT, PAD>(Qst, q, Sq, H, qt * kBT, kvh * G + g, b);
    copy_rows<HD, kBT, PAD>(Qst + kBT * LD, dout, Sq, H, qt * kBT, kvh * G + g,
                       b);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc2[8][4 * NO];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4 * NO; ++e) acc2[j][e] = 0.f;
  int stage = 0;
  while (have) {
    const int h = kvh * G + g;
    const int q0 = qt * kBT;
    int ng = g, nqt = qt;
    const bool more = next(ng, nqt);
    if (more) {   // the next pair's rows, while this one computes
      float* nx = Qst + (stage ^ 1) * 2 * kBT * LD;
      copy_rows<HD, kBT, PAD>(nx, q, Sq, H, nqt * kBT, kvh * G + ng, b);
      copy_rows<HD, kBT, PAD>(nx + kBT * LD, dout, Sq, H, nqt * kBT, kvh * G + ng,
                         b);
    }
    cp_async_commit();
    const float* Qs = Qst + stage * 2 * kBT * LD;
    const float* dOs = Qs + kBT * LD;
    // this thread's queries' lse (x log2 e, group 0) or delta (group 1)
    float rowv[NQ];
    const float* src = (grp ? delta : lse) +
                       (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int qi = q0 + qb + QB * i;
      rowv[i] = qi < Sq ? src[qi] * (grp ? 1.f : kLog2e)
                        : (grp ? 0.f : CUDART_INF_F);
    }
    // phase 1: S^T = K Q^T (group 0), dP^T = V dO^T (group 1)
    float acc1[8][NQ];
    rows_dot<HD, NQ, QB, PAD>(acc1, grp ? Vs : Ks, kb * 8, grp ? dOs : Qs, qb);
    const bool whole = vis.whole(q0, kBT, k0, BC);
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int qr = qb + QB * i;
        float p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p[j] = fast_exp2(fmaf(acc1[j][i], sl2, -rowv[i]));
        if (!whole) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!vis.pair(q0 + qr, k0 + kb * 8 + j)) p[j] = 0.f;
        }
        st4(Ps + fswz<BC, PAD>(qr, 2 * kb), make_float4(p[0], p[1], p[2], p[3]));
        st4(Ps + fswz<BC, PAD>(qr, 2 * kb + 1),
            make_float4(p[4], p[5], p[6], p[7]));
      }
    }
    __syncthreads();
    if (grp == 1) {   // dS; group 0 goes on to dV meanwhile
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int qr = qb + QB * i;
        const float4 p0 = ld4(Ps + fswz<BC, PAD>(qr, 2 * kb));
        const float4 p1 = ld4(Ps + fswz<BC, PAD>(qr, 2 * kb + 1));
        const float d = rowv[i];
        st4(dSs + fswz<BC, PAD>(qr, 2 * kb),
            make_float4(p0.x * (acc1[0][i] - d), p0.y * (acc1[1][i] - d),
                        p0.z * (acc1[2][i] - d), p0.w * (acc1[3][i] - d)));
        st4(dSs + fswz<BC, PAD>(qr, 2 * kb + 1),
            make_float4(p1.x * (acc1[4][i] - d), p1.y * (acc1[5][i] - d),
                        p1.z * (acc1[6][i] - d), p1.w * (acc1[7][i] - d)));
      }
      // the group's dS rows written, for its own reads (barrier 1: the
      // group's 128 threads only)
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    // phase 2: dV += P^T dO (group 0), dK += dS^T Q (group 1), outer
    // products over the query rows
    outer<kBT, BC, W, NO, DB, PAD>(acc2, grp ? dSs : Ps, 2 * kb2,
                              grp ? Qs : dOs, db);
    cp_async_wait<0>();
    __syncthreads();
    g = ng;
    qt = nqt;
    have = more;
    stage ^= 1;
  }
  // group 0 holds dV, group 1 dK: scaled and written, or the split's
  // fp32 partial sums
  const size_t n = static_cast<size_t>(B) * Sk * KV * HD;
  float* outp = part != nullptr ? part + ((grp ? 0 : splits) + split) * n
                                : (grp ? dk : dv);
  const float mul = (grp && part == nullptr) ? scale : 1.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kpos = k0 + kb2 * 8 + j;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int x = 0; x < NO; ++x) {
      const int d = 4 * (db + DB * x);
      if (d >= HD) continue;
      const size_t at =
          ((static_cast<size_t>(b) * Sk + kpos) * KV + kvh) * HD + d;
      st4(outp + at, make_float4(acc2[j][4 * x] * mul,
                                 acc2[j][4 * x + 1] * mul,
                                 acc2[j][4 * x + 2] * mul,
                                 acc2[j][4 * x + 3] * mul));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int Sq, int Sk, int H, int KV, Visibility vis,
                     float scale) {
  using Dm = F32Dims<HD>;
  constexpr int W = Dm::kHDP, BR = Dm::kBR;
  constexpr int NK = BR / 16;          // keys a thread in phase 1
  constexpr int KB = kBT / NK;         // key blocks (16 or 8)
  constexpr int QR = BR * W / 256 / 4; // dQ rows a thread (one chunk)
  extern __shared__ __align__(16) float fsm[];
  constexpr int LD = Dm::kLdQ;
  constexpr bool PAD = Dm::kPadQ;
  float* Qs = fsm;
  float* dOs = Qs + BR * LD;
  float* Kst = dOs + BR * LD;           // stage s: K at 2s tiles, V after
  float* PdS = Kst + 4 * kBT * LD;      // [key][query]: P, then dS
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int n_kt = (Sk + kBT - 1) / kBT;
  const int grp = threadIdx.x / 128;    // 0: S and P; 1: dP and dS
  const int lt = threadIdx.x % 128;
  const int qb = lt / KB, kb = lt % KB;   // queries qb*8 + j, keys kb + KB i
  const int rb = threadIdx.x / Dm::kC;    // dQ rows rb*QR + j
  const int cb = threadIdx.x % Dm::kC;    // dQ chunk
  const float sl2 = scale * kLog2e;
  float rowv[8];   // lse (x log2 e) of the thread's rows, or their delta
  {
    const float* src = (grp ? delta : lse) +
                       (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qi = q0 + qb * 8 + j;
      rowv[j] = qi < Sq ? src[qi] * (grp ? 1.f : kLog2e)
                        : (grp ? 0.f : CUDART_INF_F);
    }
  }
  int t = -1;
  auto next = [&](int& tt) {
    while (++tt < n_kt)
      if (vis.tiles(q0, BR, tt * kBT, kBT)) return true;
    return false;
  };
  bool have = next(t);
  copy_rows<HD, BR, PAD>(Qs, q, Sq, H, q0, h, b);
  copy_rows<HD, BR, PAD>(dOs, dout, Sq, H, q0, h, b);
  if (have) {
    copy_rows<HD, kBT, PAD>(Kst, k, Sk, KV, t * kBT, kvh, b);
    copy_rows<HD, kBT, PAD>(Kst + kBT * LD, v, Sk, KV, t * kBT, kvh, b);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc2[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;
  int stage = 0;
  while (have) {
    const int k0 = t * kBT;
    int nt = t;
    const bool more = next(nt);
    if (more) {
      float* nx = Kst + (stage ^ 1) * 2 * kBT * LD;
      copy_rows<HD, kBT, PAD>(nx, k, Sk, KV, nt * kBT, kvh, b);
      copy_rows<HD, kBT, PAD>(nx + kBT * LD, v, Sk, KV, nt * kBT, kvh, b);
    }
    cp_async_commit();
    const float* Ks = Kst + stage * 2 * kBT * LD;
    const float* Vs = Ks + kBT * LD;
    // phase 1: S = Q K^T (group 0), dP = dO V^T (group 1)
    float acc1[8][NK];
    rows_dot<HD, NK, KB, PAD>(acc1, grp ? dOs : Qs, qb * 8, grp ? Vs : Ks, kb);
    const bool whole = vis.whole(q0, BR, k0, kBT);
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int kr = kb + KB * i;
        float p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          p[j] = fast_exp2(fmaf(acc1[j][i], sl2, -rowv[j]));
        if (!whole) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!vis.pair(q0 + qb * 8 + j, k0 + kr)) p[j] = 0.f;
        }
        st4(PdS + fswz<BR, PAD>(kr, 2 * qb), make_float4(p[0], p[1], p[2], p[3]));
        st4(PdS + fswz<BR, PAD>(kr, 2 * qb + 1),
            make_float4(p[4], p[5], p[6], p[7]));
      }
    }
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int kr = kb + KB * i;
        float* at0 = PdS + fswz<BR, PAD>(kr, 2 * qb);
        float* at1 = PdS + fswz<BR, PAD>(kr, 2 * qb + 1);
        const float4 p0 = ld4(at0), p1 = ld4(at1);
        st4(at0, make_float4(p0.x * (acc1[0][i] - rowv[0]),
                             p0.y * (acc1[1][i] - rowv[1]),
                             p0.z * (acc1[2][i] - rowv[2]),
                             p0.w * (acc1[3][i] - rowv[3])));
        st4(at1, make_float4(p1.x * (acc1[4][i] - rowv[4]),
                             p1.y * (acc1[5][i] - rowv[5]),
                             p1.z * (acc1[6][i] - rowv[6]),
                             p1.w * (acc1[7][i] - rowv[7])));
      }
    }
    __syncthreads();
    // phase 2: dQ += dS K, outer products over the tile's keys (every
    // thread: 8 rows of one 4-column chunk)
    static_assert(QR == 8, "8 dQ rows a thread");
    outer<kBT, BR, W, 1, 1, PAD>(acc2, PdS, 2 * rb, Ks, cb);
    cp_async_wait<0>();
    __syncthreads();
    t = nt;
    have = more;
    stage ^= 1;
  }
  float* dqb = dq + static_cast<size_t>(b) * Sq * H * HD +
               static_cast<size_t>(h) * HD;
  const int d = 4 * cb;
  if (d < HD) {
#pragma unroll
    for (int j = 0; j < QR; ++j) {
      const int qi = q0 + rb * QR + j;
      if (qi < Sq)
        st4(dqb + static_cast<size_t>(qi) * H * HD + d,
            make_float4(acc2[j][0] * scale, acc2[j][1] * scale,
                        acc2[j][2] * scale, acc2[j][3] * scale));
    }
  }
}

// ------------------------------------------------------------- launches
template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* part, void* dq, void* dk, void* dv, int B, int Sq,
                    int Sk, int H, int KV, int splits, Visibility vis,
                    float scale, cudaStream_t stream) {
  using Dm = WgDims<HD>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dm::kDkdvSmem);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dm::kDqSmem);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  CUtensorMap tq, tk, tv, tdo;
  if (!rows_map(&tq, q, B, Sq, H, HD) || !rows_map(&tk, k, B, Sk, KV, HD) ||
      !rows_map(&tv, v, B, Sk, KV, HD) || !rows_map(&tdo, dout, B, Sq, H, HD))
    return kBadArgument;
  const int n_qt = (Sq + kBT - 1) / kBT;
  const int n_kt = (Sk + kBT - 1) / kBT;
  auto* dkt = static_cast<__nv_bfloat16*>(dk);
  auto* dvt = static_cast<__nv_bfloat16*>(dv);
  flash_bwd_dkdv_wgmma<HD>
      <<<dim3(n_kt, KV * splits, B), kWgThreads, Dm::kDkdvSmem, stream>>>(
          tq, tk, tv, tdo, lse, delta, dkt, dvt,
          splits > 1 ? part : nullptr, B, Sq, Sk, H, KV, splits, vis, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma<HD>
      <<<dim3(n_qt, H, B), kWgThreads, Dm::kDqSmem, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), Sq,
          Sk, H, KV, vis, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* part, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int splits, Visibility vis,
                   float scale, cudaStream_t stream) {
  using Dm = F32Dims<HD>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dm::kDkdvSmem);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dq_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dm::kDqSmem);
  if (a1 != cudaSuccess) return static_cast<int>(a1);
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  const int n_qt = (Sq + Dm::kBR - 1) / Dm::kBR;
  const int n_kt = (Sk + Dm::kBC - 1) / Dm::kBC;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32<HD>
      <<<dim3(n_kt, KV * splits, B), kF32Threads, Dm::kDkdvSmem, stream>>>(
          qf, kf, vf, gf, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), splits > 1 ? part : nullptr, B, Sq, Sk, H,
          KV, splits, vis, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_f32<HD>
      <<<dim3(n_qt, H, B), kF32Threads, Dm::kDqSmem, stream>>>(
          qf, kf, vf, gf, lse, delta, static_cast<float*>(dq), Sq, Sk, H, KV,
          vis, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, float* part,
               void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
               int KV, int splits, int causal, int window, int q_offset,
               float scale, cudaStream_t stream) {
  if (B > 65535 || KV * splits > 65535 || H > 65535) return kBadArgument;
  if (splits < 1 || (H / KV) % splits != 0) return kBadArgument;
  if (splits > 1 && part == nullptr) return kBadArgument;
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T, HD><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Visibility vis{Sq, Sk, causal, window, q_offset};
  int rc;
  if constexpr (sizeof(T) == 2)
    rc = launch_bwd_bf16<HD>(q, k, v, dout, lse, delta, part, dq, dk, dv, B,
                             Sq, Sk, H, KV, splits, vis, scale, stream);
  else
    rc = launch_bwd_f32<HD>(q, k, v, dout, lse, delta, part, dq, dk, dv, B,
                            Sq, Sk, H, KV, splits, vis, scale, stream);
  if (rc != 0 || splits == 1) return rc;
  const size_t n = static_cast<size_t>(B) * Sk * KV * HD;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_split_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), n, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int D, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, float* part, void* dq, void* dk, void* dv,
                 int B, int Sq, int Sk, int H, int KV, int splits, int causal,
                 int window, int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, part, dq, dk,
                               dv, B, Sq, Sk, H, KV, splits, causal, window,
                               q_offset, scale, s);
    case 120:
      return launch_bwd<T, 120>(q, k, v, o, dout, lse, delta, part, dq, dk,
                                dv, B, Sq, Sk, H, KV, splits, causal, window,
                                q_offset, scale, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, delta, part, dq, dk,
                                dv, B, Sq, Sk, H, KV, splits, causal, window,
                                q_offset, scale, s);
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
// (B, H, Sq) fp32 scratch; all contiguous; D in {64, 120, 128}. splits
// divides H / KV: the dK/dV grid's blocks a KV group's query heads are
// split over; above 1, part is fp32 scratch of 2 * splits * B * Sk * KV * D
// floats for their partial sums (else unused, may be null).
extern "C" int repro_flash_attention_backward(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* part, void* dq,
    void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, int D,
    int splits, int causal, int window, int q_offset, float scale,
    void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* pt = static_cast<float*>(part);
  if (dtype == kFloat32)
    return dispatch_bwd<float>(D, q, k, v, o, dout, l, dl, pt, dq, dk, dv, B,
                               Sq, Sk, H, KV, splits, causal, window,
                               q_offset, scale, s);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, pt, dq, dk,
                                       dv, B, Sq, Sk, H, KV, splits, causal,
                                       window, q_offset, scale, s);
  return kBadArgument;
}
