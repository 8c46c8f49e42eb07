// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated for float and __nv_bfloat16, launches on the
// stream it is handed, allocates nothing, and its C entry point returns
// cudaGetLastError() (the Python wrapper raises when that is not 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace repro {

// dtype codes shared with kernels/_build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// returned for an argument the kernel does not take (the wrapper validates
// first, so this only guards direct C callers)
constexpr int kBadArgument = 1000;

constexpr float kNegInf = -1e30f;  // the JAX kernels' mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------ tensor-core helpers
// Used by the bf16 flash kernel and the bf16 SSD kernels: 16-byte
// cp.async copies into XOR-swizzled bf16 tiles, ldmatrix loads of
// m16n8k16 fragments, and the mma itself.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, lane = 4 * g + t): A holds
// rows g and g + 8, columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1
// (+ 8) of column g; the accumulator holds rows g (c0, c1) and g + 8
// (c2, c3), columns 2t, 2t + 1.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of 16-byte chunk c of row r in a [rows][W] bf16 tile,
// the chunk index XORed with the row's low 3 bits, so the 8 rows an
// ldmatrix reads at one chunk fall in distinct banks
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(W % 64 == 0, "rows of at least 8 16-byte chunks");
  return r * W + ((c ^ (r & 7)) << 3);
}

// 16-byte global -> shared copy; with `full` false it writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------ programmatic dependent launch
// A grid launched with launch_dependent() may start while the grid before
// it on the stream still runs, once every block of that grid has called
// griddep_launch_dependents() (or exited); griddep_wait() then blocks
// until that grid has finished and its writes are visible.

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Stage KT key rows of K and V into shared memory as fp32 (row stride
// HD + 1 floats). Used by the paged kernel (both dtypes) and the fp32
// flash kernel. `row(t, k, v)` points k and v at key row t's HD elements
// in device memory and returns true, or returns false for a row that is
// staged as zeros. Every row is read as 16-byte vectors, and all of a
// thread's loads are issued before any is used, so a tile costs about one
// memory latency, not one per element. Row pointers must be 16-byte
// aligned (HD * sizeof(T) a multiple of 16, aligned base pointers).
template <typename T, int HD, int KT, int NT, class Row>
__device__ __forceinline__ void stage_tile(float* Ks, float* Vs, Row row) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kTotal = KT * kPerRow;
  constexpr int kIters = (kTotal + NT - 1) / NT;
  static_assert(HD % kVec == 0, "rows must split into 16-byte vectors");
  uint4 kbuf[kIters], vbuf[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * NT;
    kbuf[i] = vbuf[i] = make_uint4(0u, 0u, 0u, 0u);
    const T* kr;
    const T* vr;
    if (idx < kTotal && row(idx / kPerRow, kr, vr)) {
      const int c = idx % kPerRow;
      kbuf[i] = reinterpret_cast<const uint4*>(kr)[c];
      vbuf[i] = reinterpret_cast<const uint4*>(vr)[c];
    }
  }
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (idx < kTotal) {
      const int t = idx / kPerRow;
      const int d0 = (idx % kPerRow) * kVec;
      const T* ke = reinterpret_cast<const T*>(&kbuf[i]);
      const T* ve = reinterpret_cast<const T*>(&vbuf[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        Ks[t * (HD + 1) + d0 + e] = to_float(ke[e]);
        Vs[t * (HD + 1) + d0 + e] = to_float(ve[e]);
      }
    }
  }
}

// RowState and attend_tile serve only the fp32 flash kernel (the bf16 one
// runs on tensor cores, the paged one spreads keys over threads).
//
// Online-softmax state of one query row. The row is split over a quad of 4
// consecutive lanes; lane `sub` of the quad owns output columns
// d = sub + 4*i (interleaved, so the quad's shared-memory reads of a value
// row fall in 4 distinct banks).
template <int HD>
struct RowState {
  float m;
  float l;
  float acc[HD / 4];

  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;
  }
};

// Fold one tile of KT keys into a row's state: scores, running max and sum
// in fp32, with the JAX kernels' guards for fully masked rows (a row whose
// max is still the mask value contributes p = 0, and a first real score
// gets alpha = 0). `q` is the thread's whole query row in registers; Ks/Vs
// are the tile staged in shared memory with row stride HD + 1 floats (the
// pad keeps the quad's 4 key rows in 4 banks). `visible(c)` says whether
// tile key c is visible to this row. All 32 lanes of every warp must call
// this together (quad shuffles).
template <int HD, int KT, class Visible>
__device__ __forceinline__ void attend_tile(RowState<HD>& st, const float* q,
                                            const float* Ks, const float* Vs,
                                            float scale, int sub,
                                            Visible visible) {
  static_assert(KT % 4 == 0, "key tile must split over a quad");
  float p[KT / 4];
  float mloc = kNegInf;
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) {
    const int c = sub + 4 * i;
    const float* kr = Ks + c * (HD + 1);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
    p[i] = visible(c) ? dot * scale : kNegInf;
    mloc = fmaxf(mloc, p[i]);
  }
  mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
  mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
  const float m_new = fmaxf(st.m, mloc);
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) {
    p[i] = (m_new <= kNegInf) ? 0.f : expf(p[i] - m_new);
    psum += p[i];
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  psum += __shfl_xor_sync(0xffffffffu, psum, 2);
  const float alpha = (st.m <= kNegInf) ? 0.f : expf(st.m - m_new);
  st.l = st.l * alpha + psum;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) st.acc[i] *= alpha;
  const int quad = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int c = 0; c < KT; ++c) {
    // key c's probability lives in lane (c % 4) of the quad, slot c / 4
    const float pc = __shfl_sync(0xffffffffu, p[c / 4], quad | (c & 3));
    const float* vr = Vs + c * (HD + 1);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      st.acc[i] = fmaf(pc, vr[sub + 4 * i], st.acc[i]);
  }
  st.m = m_new;
}

}  // namespace repro
