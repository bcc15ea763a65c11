// Device helpers shared by the cluster kernels of squeezed_attention.cu and
// expansion_epilogue.cu, and by mbconv.cu: 256-thread blocks, cp.async
// staging, ldmatrix and mma.sync m16n8k16 (bf16 operands, fp32
// accumulators), cluster barriers, and the launch configuration and
// occupancy query of a thread-block cluster. Each .cu builds into its own
// library; this header is included by all three and hashed into their
// build keys (kernels/_build.py).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // portable cluster size

using bf16 = __nv_bfloat16;

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy the [rows x cols] tile at X (row stride ld) into dst (row stride
// ldd) by 16-byte vectors, zero outside `valid_rows` x `valid_cols`.
// Whole vectors only: the wrapper guarantees 16-byte rows.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(T* dst, int ldd, const T* X,
                                           long long ld, int valid_rows,
                                           int valid_cols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  constexpr int NV = ROWS * PER_ROW;
  static_assert(NV % kThreads == 0, "tile vectors split evenly");
#pragma unroll
  for (int i = 0; i < NV / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / PER_ROW, c = (v % PER_ROW) * VEC;
    const bool in = r < valid_rows && c < valid_cols;
    cp_async16(dst + r * ldd + c, in ? X + r * ld + c : X, in ? 16 : 0);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c[4] += a (16 x 16 bf16, row) . b (16 x 8 bf16, col), fp32
__device__ __forceinline__ void mma16816(float* c, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (rows m0 + [0, 16), depth k0 + [0, 16)) of A = X, X stored
// [m][k], or of A = X^T (kTrans), X stored [k][m]; row stride ld
template <bool kTrans>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* X,
                                       int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  if constexpr (kTrans) {
    const int j = l >> 3, i = l & 7;
    ldsm_x4_t(a, X + (k0 + i + (j >> 1) * 8) * ld + m0 + (j & 1) * 8);
  } else {
    ldsm_x4(a, X + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
  }
}
// B fragments of the n8 tiles n0 and n0 + 8 (b[0..1] and b[2..3]) at depth
// k0 + [0, 16), B stored [k][n]
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4], const bf16* X,
                                          int ld, int k0, int n0) {
  const int l = threadIdx.x & 31, j = l >> 3, i = l & 7;
  ldsm_x4_t(b, X + (k0 + i + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
}

__device__ __forceinline__ void store_pair(bf16* at, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* at, float x, float y) {
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a launch of `grid` in clusters of C CTAs along x
inline cudaLaunchConfig_t cluster_config(dim3 grid, int C, size_t smem,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the shared-memory bytes of `kern` and how many of its clusters of C CTAs
// the card holds at once
template <typename Kern>
cudaError_t occupancy(Kern kern, size_t bytes, int C, int* smem,
                      int* clusters) {
  *smem = static_cast<int>(bytes);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(C, 1, 1), C, bytes, &attr, 0);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

}  // namespace
