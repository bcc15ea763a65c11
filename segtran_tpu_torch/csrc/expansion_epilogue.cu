// Fused expansion epilogue for Hopper (sm_90a): per mode m,
//
//     mid_m = gelu(P_m @ VW1_m + b1)        (or a given mid_m)
//     z_m   = mid_m @ W2_m + b2_m           (private output linear)
//     l_m   = LayerNorm(z_m)                (fp32 stats, var clamped at 0)
//     s_m   = l_m @ ws + bs                 (feat2score)
//     out   = sum_m softmax_m(s) * l_m      (or emit one mode's l_m, s_m)
//
// Replaces the Pallas kernels of segtran_tpu/kernels/expansion_epilogue.py:
//   fused_mid_output_pool          (_mid_epilogue_kernel)  FROM_P, POOL
//   fused_mid_output_pool_permode  (_mode_mid_ln_kernel)   FROM_P, !POOL
//   fused_private_output_pool      (_epilogue_kernel)      !FROM_P, POOL
// One template with two switches covers all three.
//
// Rounding follows the JAX kernels point for point: each product
// accumulates in fp32 and is rounded to the compute dtype T before its bias
// is added in T; gelu runs in fp32 (erff) and rounds once; the LayerNorm
// statistics are fp32, the normalize/scale/shift run in T; the score
// accumulates in fp32; the mode softmax and weighted sum run in fp32 (online
// over modes) and the result is rounded to T.
//
// What bounds it on an H100 SXM: at B=8, M=4, N=1296, A=256 in bf16 the
// work is matrix products (per-mode F=1792 ~7.6e10 FLOP, ~77 us at
// 989 TFLOP/s; full F=896 ~8.6e10, ~87 us; full F=448 ~2.6e10, ~26 us)
// against 40-60 MB of compulsory traffic (~12-18 us at 3.35 TB/s), so it is
// bound by operations.
//
// The design: W2 [M, F, F] (25.7 MB at F=1792) cannot stay on chip as it
// did in TPU VMEM, so it is streamed from L2. A block owns TM whole rows of
// N for one image (LayerNorm needs whole rows, and blocks cannot carry
// anything between them) and loops over the modes and over NC-column
// passes of F itself. Both operands of each product are staged through a
// ring of shared-memory [TM, KC] and [KC, NC] tiles filled by cp.async,
// two tiles in flight, with row strides padded so that WMMA fragment rows
// fall into different banks. mid and z go to block-owned scratch rows in
// device memory, which stay in L2, so shared memory does not limit F. bf16
// products run on the tensor cores through WMMA 16x16x16 (fp32
// accumulate); fp32 products run on the CUDA cores in full fp32 (no TF32),
// so the fp32 build is an exact-precision check of the algorithm.
// Measured on the card it stays far from the bound: each B fragment feeds
// one product and is reloaded from shared memory, every KC-deep step ends
// in a block barrier, and the LayerNorm/pool pass goes through L2-resident
// scratch. wgmma with TMA and larger warp tiles are the next step.
//
// Ragged edges (N not a multiple of TM, A or F not a multiple of the tile)
// are masked in-kernel: out-of-range rows, columns and depths load as zero
// and are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

// Tile shape per compute type: rows per block (TM), output columns per
// product pass (NC), depth of one staged tile (KC), and the shared-memory
// row strides of the A stage, the B stage and the fp32 result (LDA, LDB,
// LDS). The bf16 strides are padded off multiples of 128 bytes so that the
// 16 rows of a WMMA fragment fall into different banks.
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int TM = 32, NC = 128, KC = 64;
  static constexpr int LDA = KC + 8, LDB = NC + 8, LDS = NC + 4;
};
template <> struct Tile<float> {
  static constexpr int TM = 32, NC = 128, KC = 32;
  static constexpr int LDA = KC, LDB = NC, LDS = NC;
};
constexpr int kStages = 3;  // ring of staged tiles in flight (cp.async)

template <typename T>
constexpr size_t smem_bytes() {
  using S = Tile<T>;
  return sizeof(T) * kStages * (S::TM * S::LDA + S::KC * S::LDB) +
         sizeof(float) * S::TM * S::LDS;
}

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// round an fp32 value to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* p;   long long p_sb, p_sm;      // probs [B, M, N, A]
  const void* vw1; long long v_sb, v_sm;      // V W1 [B, M, A, F]
  const void* mid; long long mid_sb, mid_sm;  // mid [B, M, N, F]
  const void* b1;                             // [F]
  const void* w2;                             // [M, F, F] (in, out)
  const void* b2;                             // [M, F]
  const void* scale;                          // [F]
  const void* lnb;                            // [F]
  const void* ws;                             // [F]
  const float* bs;                            // [1]
  void* out;       // pooled [B, N, F], or l_m [B, N, F]; holds z first
  float* s_out;    // per-mode score [B, N]
  void* mid_g;     // [B, N, F] scratch for mid (FROM_P)
  float* acc_g;    // [B, N, F] fp32 pool accumulator (POOL)
  int N, A, F, mode0, nmodes;
  float eps;
};

// Stage the 16-byte vector at (r, c) of a row-major matrix X (rows x cols,
// row stride ld) into dst, zero outside. Whole in-range aligned vectors go
// by cp.async (also the all-zero ones, with a zero source size); a vector
// that straddles the edge or is misaligned is copied element by element.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* X, long long ld,
                                          int rows, int cols, int r, int c,
                                          bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const bool in = r < rows && c < cols;
  if (!in || (vec_ok && c + VEC <= cols)) {
    cp_async16(dst, in ? X + r * ld + c : X, in ? 16 : 0);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    dst[j] = c + j < cols ? X[r * ld + c + j] : from_f<T>(0.f);
}

// scr[TM][NC] (row stride LDS) = A[0:TM][0:K] @ B[0:K][c0:c0+NC] in fp32.
// A (row stride lda, `rows` valid rows) and B (row stride ldb, Fc valid
// columns) are in device memory; both are staged through a ring of
// kStages shared-memory tiles (as: [TM][KC], bs: [KC][NC]) filled by
// cp.async, so kStages - 1 tiles are in flight while one is multiplied.
// Starts and ends with a block barrier.
template <typename T>
__device__ void gemm_tile(const T* A, long long lda, int rows, const T* B,
                          long long ldb, int K, int Fc, int c0, T* as, T* bs,
                          float* scr) {
  using S = Tile<T>;
  constexpr int TM = S::TM, NC = S::NC, KC = S::KC;
  constexpr int LDA = S::LDA, LDB = S::LDB, LDS = S::LDS;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NA = TM * KC / VEC / kThreads;  // A vectors per thread
  constexpr int NB = KC * NC / VEC / kThreads;  // B vectors per thread
  constexpr int AV = KC / VEC, BV = NC / VEC;   // vectors per tile row
  static_assert(NA >= 1 && NB >= 1, "tile too small for the block");
  const int tid = threadIdx.x;
  const bool a_vec = reinterpret_cast<uintptr_t>(A) % 16 == 0 && lda % VEC == 0;
  const bool b_vec = reinterpret_cast<uintptr_t>(B) % 16 == 0 && ldb % VEC == 0;
  const int nk = (K + KC - 1) / KC;

  // issue the copies of depth tile t into ring slot t % kStages
  auto issue = [&](int t) {
    if (t < nk) {
      const int k0 = t * KC;
      T* sa = as + (t % kStages) * TM * LDA;
      T* sb = bs + (t % kStages) * KC * LDB;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int v = tid + i * kThreads, r = v / AV, c = (v % AV) * VEC;
        // A's columns are the depth: valid while k < K
        stage_vec<T>(sa + r * LDA + c, A + k0, lda, rows, K - k0, r, c, a_vec);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int v = tid + i * kThreads, r = v / BV, c = (v % BV) * VEC;
        stage_vec<T>(sb + r * LDB + c, B + (long long)k0 * ldb + c0, ldb,
                     K - k0, Fc - c0, r, c, b_vec);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  __syncthreads();  // A may have just been written by this block; the ring
                    // may still be read by the previous call
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    // warp w owns row tile w % RTL (16 rows) and column group w / RTL
    // (NC / CG columns, FR fragments of 16)
    constexpr int RTL = TM / 16, CG = kWarps / RTL, FR = NC / CG / 16;
    static_assert(RTL * CG == kWarps && FR * CG * 16 == NC, "warp layout");
    const int warp = tid >> 5, rt = warp % RTL, ch = warp / RTL;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR];
#pragma unroll
    for (int j = 0; j < FR; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
      __syncthreads();               // everyone's; slot t-1 is free again
      issue(t + kStages - 1);
      const T* sa = as + (t % kStages) * TM * LDA;
      const T* sb = bs + (t % kStages) * KC * LDB;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sa + rt * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < FR; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sb + kk * LDB + ch * (NC / CG) + j * 16, LDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < FR; ++j)
      wmma::store_matrix_sync(scr + rt * 16 * LDS + ch * (NC / CG) + j * 16,
                              acc[j], LDS, wmma::mem_row_major);
  } else {
    // thread t: column t % NC, rows t / NC + RS * i
    constexpr int RS = kThreads / NC, RT = TM / RS;
    const int col = tid % NC, r0 = tid / NC;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(t + kStages - 1);
      const T* sa = as + (t % kStages) * TM * LDA;
      const T* sb = bs + (t % kStages) * KC * LDB;
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float bv = to_f(sb[kk * LDB + col]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i] = fmaf(to_f(sa[(r0 + RS * i) * LDA + kk]), bv, acc[i]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < RT; ++i) scr[(r0 + RS * i) * LDS + col] = acc[i];
  }
  __syncthreads();
}

template <typename T, bool FROM_P, bool POOL>
__global__ void __launch_bounds__(kThreads, 2)
epilogue_kernel(Params q) {
  using S = Tile<T>;
  constexpr int TM = S::TM, NC = S::NC, LDS = S::LDS;
  constexpr int RPW = TM / kWarps;  // rows owned by each warp
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = as + kStages * TM * S::LDA;
  float* scr = reinterpret_cast<float*>(bs + kStages * S::KC * S::LDB);

  const int F = q.F, N = q.N, A = q.A;
  const T* B1 = static_cast<const T*>(q.b1);
  const T* B2 = static_cast<const T*>(q.b2);
  const T* SCALE = static_cast<const T*>(q.scale);
  const T* LNB = static_cast<const T*>(q.lnb);
  const T* WS = static_cast<const T*>(q.ws);

  const int b = blockIdx.y, n0 = blockIdx.x * TM;
  const int rows = min(TM, N - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)b * N + n0;  // first [B, N] row owned
  T* zg = static_cast<T*>(q.out) + row0 * F;      // z, then l or the pool
  float run_max[RPW], denom[RPW];
  const float bs_v = *q.bs;

  for (int mi = 0; mi < q.nmodes; ++mi) {
    const int m = q.mode0 + mi;
    const T* a2;  // the A operand of the output product
    if constexpr (FROM_P) {
      // mid = gelu(P_m @ VW1_m + b1) into the block's scratch rows
      const T* pg = static_cast<const T*>(q.p) + b * q.p_sb + m * q.p_sm +
                    (long long)n0 * A;
      const T* vg = static_cast<const T*>(q.vw1) + b * q.v_sb + m * q.v_sm;
      T* mg = static_cast<T*>(q.mid_g) + row0 * F;
      for (int c0 = 0; c0 < F; c0 += NC) {
        gemm_tile<T>(pg, A, rows, vg, F, A, F, c0, as, bs, scr);
        for (int i = tid; i < TM * NC; i += kThreads) {
          const int r = i / NC, c = c0 + i % NC;
          if (r >= rows || c >= F) continue;
          const float v = rnd<T>(rnd<T>(scr[r * LDS + i % NC]) + to_f(B1[c]));
          mg[(long long)r * F + c] =
              from_f<T>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
        }
      }
      a2 = mg;
    } else {
      a2 = static_cast<const T*>(q.mid) + b * q.mid_sb + m * q.mid_sm +
           (long long)n0 * F;
    }
    // z = mid @ W2_m + b2_m, rounded to T before and after the bias
    const T* w2 = static_cast<const T*>(q.w2) + (long long)m * F * F;
    const T* b2 = B2 + (long long)m * F;
    for (int c0 = 0; c0 < F; c0 += NC) {
      gemm_tile<T>(a2, F, rows, w2, F, F, F, c0, as, bs, scr);
      for (int i = tid; i < TM * NC; i += kThreads) {
        const int r = i / NC, c = c0 + i % NC;
        if (r < rows && c < F)
          zg[(long long)r * F + c] =
              from_f<T>(rnd<T>(scr[r * LDS + i % NC]) + to_f(b2[c]));
      }
    }
    __syncthreads();
    // LayerNorm + score + pool/emit: each warp owns whole rows; l goes
    // back into z's row, since the pool weight needs the row's full score
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + j * kWarps;
      if (r >= rows) continue;  // uniform across the warp
      T* zr = zg + (long long)r * F;
      float sum = 0.f, sq = 0.f;
      for (int c = lane; c < F; c += 32) {
        const float v = to_f(zr[c]);
        sum += v;
        sq += v * v;
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mean = sum / F;
      const float var = fmaxf(0.f, sq / F - mean * mean);
      const float mean_t = rnd<T>(mean);
      const float inv_t = rnd<T>(1.f / sqrtf(var + q.eps));
      float sc = 0.f;
      for (int c = lane; c < F; c += 32) {
        float t = rnd<T>(to_f(zr[c]) - mean_t);
        t = rnd<T>(t * inv_t);
        t = rnd<T>(t * to_f(SCALE[c]));
        const T l = from_f<T>(t + to_f(LNB[c]));
        zr[c] = l;
        sc += to_f(l) * to_f(WS[c]);
      }
      const float s = warp_sum(sc) + bs_v;
      if constexpr (POOL) {
        float* ar = q.acc_g + (row0 + r) * F;
        if (mi == 0) {
          run_max[j] = s;
          denom[j] = 1.f;
          for (int c = lane; c < F; c += 32) ar[c] = to_f(zr[c]);
        } else {
          const float nm = fmaxf(run_max[j], s);
          const float alpha = expf(run_max[j] - nm), e = expf(s - nm);
          denom[j] = denom[j] * alpha + e;
          run_max[j] = nm;
          for (int c = lane; c < F; c += 32)
            ar[c] = ar[c] * alpha + e * to_f(zr[c]);
        }
      } else {
        if (lane == 0) q.s_out[row0 + r] = s;
      }
    }
    __syncthreads();
  }
  if constexpr (POOL) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + j * kWarps;
      if (r >= rows) continue;
      const float* ar = q.acc_g + (row0 + r) * F;
      T* o = zg + (long long)r * F;
      for (int c = lane; c < F; c += 32) o[c] = from_f<T>(ar[c] / denom[j]);
    }
  }
}

template <typename T, bool FROM_P, bool POOL>
cudaError_t launch(const Params& q, int B, cudaStream_t stream) {
  constexpr int TM = Tile<T>::TM;
  const size_t smem = smem_bytes<T>();
  auto kern = epilogue_kernel<T, FROM_P, POOL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((q.N + TM - 1) / TM, B);
  kern<<<grid, kThreads, smem, stream>>>(q);
  return cudaGetLastError();
}

template <bool FROM_P, bool POOL>
int dispatch(int is_bf16, const Params& q, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<bf16, FROM_P, POOL>(q, B, st)
                                  : launch<float, FROM_P, POOL>(q, B, st));
}

Params base(const void* b1, const void* w2, const void* b2, const void* scale,
            const void* lnb, const void* ws, const void* bs, int N, int A,
            int F, double eps) {
  Params q = {};
  q.b1 = b1; q.w2 = w2; q.b2 = b2; q.scale = scale; q.lnb = lnb; q.ws = ws;
  q.bs = static_cast<const float*>(bs);
  q.N = N; q.A = A; q.F = F;
  q.eps = static_cast<float>(eps);
  return q;
}

}  // namespace

extern "C" {

// fused_mid_output_pool: probs [B,M,N,A], vw1 [B,M,A,F] -> out [B,N,F];
// mid_scratch [B,N,F] (compute dtype), acc_scratch [B,N,F] fp32
int epi_mid_pool(int is_bf16, const void* p, const void* vw1, const void* b1,
                 const void* w2, const void* b2, const void* scale,
                 const void* lnb, const void* ws, const void* bs, void* out,
                 void* mid_scratch, float* acc_scratch, int B, int M, int N,
                 int A, int F, double eps, void* stream) {
  Params q = base(b1, w2, b2, scale, lnb, ws, bs, N, A, F, eps);
  q.p = p; q.p_sb = (long long)M * N * A; q.p_sm = (long long)N * A;
  q.vw1 = vw1; q.v_sb = (long long)M * A * F; q.v_sm = (long long)A * F;
  q.out = out; q.mid_g = mid_scratch; q.acc_g = acc_scratch;
  q.mode0 = 0; q.nmodes = M;
  return dispatch<true, true>(is_bf16, q, B, stream);
}

// one mode of fused_mid_output_pool_permode: emits l_m [B,N,F], s_m [B,N]
int epi_mid_mode(int is_bf16, const void* p, const void* vw1, const void* b1,
                 const void* w2, const void* b2, const void* scale,
                 const void* lnb, const void* ws, const void* bs, void* l_out,
                 float* s_out, void* mid_scratch, int mode, int B, int M,
                 int N, int A, int F, double eps, void* stream) {
  Params q = base(b1, w2, b2, scale, lnb, ws, bs, N, A, F, eps);
  q.p = p; q.p_sb = (long long)M * N * A; q.p_sm = (long long)N * A;
  q.vw1 = vw1; q.v_sb = (long long)M * A * F; q.v_sm = (long long)A * F;
  q.out = l_out; q.s_out = s_out; q.mid_g = mid_scratch;
  q.mode0 = mode; q.nmodes = 1;
  return dispatch<true, false>(is_bf16, q, B, stream);
}

// fused_private_output_pool: mid [B,M,N,F] -> out [B,N,F];
// acc_scratch [B,N,F] fp32
int epi_private_pool(int is_bf16, const void* mid, const void* w2,
                     const void* b2, const void* scale, const void* lnb,
                     const void* ws, const void* bs, void* out,
                     float* acc_scratch, int B, int M, int N, int F,
                     double eps, void* stream) {
  Params q = base(nullptr, w2, b2, scale, lnb, ws, bs, N, 0, F, eps);
  q.mid = mid; q.mid_sb = (long long)M * N * F; q.mid_sm = (long long)N * F;
  q.out = out; q.acc_g = acc_scratch; q.mode0 = 0; q.nmodes = M;
  return dispatch<false, true>(is_bf16, q, B, stream);
}

}  // extern "C"
