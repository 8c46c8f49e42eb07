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
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int causal, int window,
                     int q_offset, float scale) {
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
                         int Sq, int Sk, int H, int KV, int causal,
                         int window, int q_offset, float scale) {
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
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, KV,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KV, int causal, int window,
                int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<float, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_fp32<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                          q_offset, scale, s);
  if (dtype == kBFloat16)
    return launch_mma<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
  return kBadArgument;
}

}  // namespace
}  // namespace repro

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); all contiguous; H % KV == 0;
// D in {64, 120, 128} (the head dims of the ported configs).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KV, int D, int causal,
                                     int window, int q_offset, float scale,
                                     void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 120:
      return launch<120>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
    default:
      return kBadArgument;
  }
}
