// Flash cross-attention forward for Hopper (sm_90a):
//
//     s   = clip(q k^T * scale, -clip, clip)      fp32, padded keys -inf
//     m   = max_n s,  l = sum_n exp(s - m)        fp32
//     out = (sum_n T(exp(s - m)) v) / l           fp32 sum, rounded to T
//     lse = m + log(l)                            fp32
//
// with q [G, Q, D], k [G, N, D], v [G, N, F] in the compute type T (bf16 or
// fp32). Replaces the Pallas forward of segtran_tpu/kernels/
// squeezed_attention.py (_fused_forward / _attn_kernel).
//
// What bounds it on an H100 SXM: at the BraTS whole-volume shapes (bf16;
// in-squeeze G=1, Q=1024, N=8640, D=F=1024; out-squeeze G=4, Q=8640,
// N=1024, D=256, F=1024) the work is 2*G*Q*N*(D+F) FLOP of matrix products
// (3.6e10 and 9.1e10, 37 and 92 us at 989 TFLOP/s) against 20-90 MB of
// compulsory traffic (6-27 us at 3.35 TB/s): bound by operations.
//
// The design. The TPU kernel keeps a [TQ, F] fp32 accumulator in VMEM and
// rescales it as its online softmax walks the keys; at F=1024 a 64-row
// accumulator is 256 KB, more than a block's 227 KB of shared memory. So
// the softmax statistics and the product are two kernels:
//
// 1. stats_kernel: per (G, 64-row query tile, slice of the keys) an online
//    max and sum over 64-key tiles, written as partial (m, l) per slice.
//    Slicing the keys across blocks fills the card when Q is small (the
//    in-squeeze has 16 query tiles on 132 SMs).
// 2. out_kernel: per (G, query tile, 128-column slice of F) it merges the
//    partial (m, l) and walks all key tiles once more: recomputes s, forms
//    p = exp(s - m) in T and accumulates p v in fp32 registers, with no
//    rescaling since m is final. Every F slice recomputes q k^T: the price
//    of keeping the accumulator on chip, F/128 times the q k^T work.
//
// q and k are streamed over D through a ring of [64, KC] shared-memory
// tiles filled by cp.async (D up to 1792 on the 2D path), with row strides
// padded off multiples of 128 bytes against bank conflicts; each key
// tile's v slice is fetched with the first depth stage. bf16 products run
// on the tensor cores through WMMA 16x16x16 (fp32 accumulate); fp32
// products run on the CUDA cores in full fp32, so the fp32 build is an
// exact-precision check. Ragged Q, N and F are masked in-kernel; D and F
// must be multiples of 16 bytes' worth of elements (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TQ = 64;  // query rows per block
constexpr int TN = 64;  // keys per tile
constexpr int TF = 128; // output columns per block
constexpr int kStages = 3;

using bf16 = __nv_bfloat16;

// depth of one staged q/k tile and the shared-memory row strides: q/k
// stage (LDK), scores (LDS), p (LDP), v (LDV), output staging (LDO)
template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int KC = 64, LDK = KC + 8, LDS = TN + 4, LDP = TN + 8,
                       LDV = TF + 8, LDO = TF + 4;
};
template <> struct Tile<float> {
  static constexpr int KC = 32, LDK = KC + 4, LDS = TN + 4, LDP = TN + 4,
                       LDV = TF + 4, LDO = TF + 4;
};

template <typename T> constexpr size_t ring_bytes() {
  return sizeof(T) * 2 * kStages * TQ * Tile<T>::LDK;  // q ring + k ring
}
template <typename T> constexpr size_t stats_smem() {
  return ring_bytes<T>() + sizeof(float) * TQ * Tile<T>::LDS;
}
template <typename T> constexpr size_t out_smem() {
  using S = Tile<T>;
  return ring_bytes<T>() + sizeof(float) * TQ * S::LDS +
         sizeof(T) * TQ * S::LDP + sizeof(T) * TN * S::LDV +
         sizeof(float) * 2 * TQ;
}
static_assert(sizeof(float) * TQ * Tile<bf16>::LDO <= ring_bytes<bf16>(),
              "output staging reuses the q/k ring");
static_assert(sizeof(float) * TQ * Tile<float>::LDO <= ring_bytes<float>(),
              "output staging reuses the q/k ring");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

// scr[TQ][TN] (row stride LDS, fp32) = q[0:TQ] . k[0:TN]^T over depth D,
// unscaled. q and k point at the tile's first rows (row stride D). `pre`
// issues extra copies into the first cp.async group. Starts and ends with
// a block barrier; on return every copy of this call has landed.
template <typename T, typename Pre>
__device__ void score_tile(const T* q, int q_rows, const T* k, int k_rows,
                           int D, T* sq, T* sk, float* scr, Pre pre) {
  using S = Tile<T>;
  constexpr int KC = S::KC, LDK = S::LDK, LDS = S::LDS;
  const int nk = (D + KC - 1) / KC;
  auto issue = [&](int t) {
    if (t == 0) pre();
    if (t < nk) {
      const int k0 = t * KC;
      stage_tile<T, TQ, KC>(sq + (t % kStages) * TQ * LDK, LDK, q + k0, D,
                            q_rows, D - k0);
      stage_tile<T, TN, KC>(sk + (t % kStages) * TN * LDK, LDK, k + k0, D,
                            k_rows, D - k0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  __syncthreads();      // the ring, scr and v may still be read
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    // warp w: row tile w % 4 (16 rows), key columns (w / 4) * 32 + [0, 32)
    const int warp = tid >> 5, rt = warp % 4, ch = warp / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(t + kStages - 1);
      const T* a = sq + (t % kStages) * TQ * LDK + rt * 16 * LDK;
      const T* b = sk + (t % kStages) * TN * LDK + ch * 32 * LDK;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + kk, LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // k^T as a column-major [KC, TN] operand: (d, n) at n * LDK + d
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, b + j * 16 * LDK + kk, LDK);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(scr + rt * 16 * LDS + ch * 32 + j * 16, acc[j],
                              LDS, wmma::mem_row_major);
  } else {
    // thread t: key column t % TN, query rows t / TN + 4 i
    constexpr int RS = kThreads / TN, RT = TQ / RS;
    const int col = tid % TN, r0 = tid / TN;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
    for (int t = 0; t < nk; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(t + kStages - 1);
      const T* a = sq + (t % kStages) * TQ * LDK;
      const T* b = sk + (t % kStages) * TN * LDK + col * LDK;
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float bv = b[kk];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i] = fmaf(a[(r0 + RS * i) * LDK + kk], bv, acc[i]);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < RT; ++i) scr[(r0 + RS * i) * LDS + col] = acc[i];
  }
  __syncthreads();
}

struct Params {
  const void* q;  // [G, Q, D]
  const void* k;  // [G, N, D]
  const void* v;  // [G, N, F]
  void* out;      // [G, Q, F]
  float* lse;     // [G, Q]
  float* pm;      // [G, splits, Q] partial max
  float* pl;      // [G, splits, Q] partial sum
  int Q, N, D, F, splits;
  float scale, clip;
};

// the score the softmax sees: scaled, clipped, -inf past the last key
__device__ __forceinline__ float score(float dot, int col, int n_valid,
                                       float scale, float clip) {
  const float s = fminf(fmaxf(dot * scale, -clip), clip);
  return col < n_valid ? s : -INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) stats_kernel(Params p) {
  using S = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kStages * TQ * S::LDK;
  float* scr = reinterpret_cast<float*>(sk + kStages * TN * S::LDK);

  const int g = blockIdx.z, q0 = blockIdx.x * TQ;
  const int q_rows = min(TQ, p.Q - q0);
  const int nt = (p.N + TN - 1) / TN;
  const int per = (nt + p.splits - 1) / p.splits;
  const int t0 = blockIdx.y * per, t1 = min(nt, t0 + per);
  const T* qg = static_cast<const T*>(p.q) + ((long long)g * p.Q + q0) * p.D;
  const T* kg = static_cast<const T*>(p.k) + (long long)g * p.N * p.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int RPW = TQ / kWarps;  // rows of each warp
  float m[RPW], l[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * TN;
    score_tile<T>(qg, q_rows, kg + (long long)n0 * p.D, min(TN, p.N - n0),
                  p.D, sq, sk, scr, [] {});
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float* row = scr + (warp * RPW + j) * S::LDS;
      const float a = score(row[lane], n0 + lane, p.N, p.scale, p.clip);
      const float b =
          score(row[lane + 32], n0 + lane + 32, p.N, p.scale, p.clip);
      const float mn = fmaxf(m[j], warp_max(fmaxf(a, b)));
      l[j] = l[j] * expf(m[j] - mn) + warp_sum(expf(a - mn) + expf(b - mn));
      m[j] = mn;
    }
  }
  if (lane == 0) {
    const long long base = ((long long)g * p.splits + blockIdx.y) * p.Q + q0;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j;
      if (r < q_rows) {
        p.pm[base + r] = m[j];
        p.pl[base + r] = l[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) out_kernel(Params p) {
  using S = Tile<T>;
  constexpr int LDS = S::LDS, LDP = S::LDP, LDV = S::LDV, LDO = S::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kStages * TQ * S::LDK;
  float* scr = reinterpret_cast<float*>(sk + kStages * TN * S::LDK);
  T* sp = reinterpret_cast<T*>(scr + TQ * LDS);
  T* sv = sp + TQ * LDP;
  float* row_m = reinterpret_cast<float*>(sv + TN * LDV);
  float* row_l = row_m + TQ;
  float* so = reinterpret_cast<float*>(smem);  // output staging, after use

  const int g = blockIdx.z, q0 = blockIdx.x * TQ, f0 = blockIdx.y * TF;
  const int q_rows = min(TQ, p.Q - q0), f_cols = p.F - f0;
  const int tid = threadIdx.x;
  const T* qg = static_cast<const T*>(p.q) + ((long long)g * p.Q + q0) * p.D;
  const T* kg = static_cast<const T*>(p.k) + (long long)g * p.N * p.D;
  const T* vg = static_cast<const T*>(p.v) + (long long)g * p.N * p.F + f0;

  // merge the partial statistics of the key slices
  if (tid < TQ) {
    float mm = 0.f, ll = 1.f;
    if (tid < q_rows) {
      const long long base = (long long)g * p.splits * p.Q + q0 + tid;
      mm = -INFINITY;
      for (int s = 0; s < p.splits; ++s) mm = fmaxf(mm, p.pm[base + s * p.Q]);
      ll = 0.f;
      for (int s = 0; s < p.splits; ++s)
        ll += p.pl[base + s * p.Q] * expf(p.pm[base + s * p.Q] - mm);
      if (blockIdx.y == 0)
        p.lse[(long long)g * p.Q + q0 + tid] = mm + logf(ll);
    }
    row_m[tid] = mm;
    row_l[tid] = ll;
  }

  using namespace nvcuda;
  constexpr bool kTC = std::is_same<T, bf16>::value;
  // bf16: warp w owns rows (w % 4) * 16 and columns (w / 4) * 64, 4 frags
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[kTC ? 4 : 1];
  // fp32: thread t owns column t % TF and rows t / TF + 2 i
  constexpr int RS = kThreads / TF, RT = TQ / RS;
  float acc[kTC ? 1 : RT];
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(facc[j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
  }
  const int warp = tid >> 5, rt = warp % 4, ch = warp / 4;

  const int nt = (p.N + TN - 1) / TN;
  for (int t = 0; t < nt; ++t) {
    const int n0 = t * TN, k_rows = min(TN, p.N - n0);
    score_tile<T>(qg, q_rows, kg + (long long)n0 * p.D, k_rows, p.D, sq, sk,
                  scr, [&] {
                    stage_tile<T, TN, TF>(sv, LDV, vg + (long long)n0 * p.F,
                                          p.F, k_rows, f_cols);
                  });
    // p = exp(s - m) rounded to T; zero past the last key
    for (int i = tid; i < TQ * TN; i += kThreads) {
      const int r = i / TN, c = i % TN;
      const float s = score(scr[r * LDS + c], n0 + c, p.N, p.scale, p.clip);
      sp[r * LDP + c] = from_f<T>(expf(s - row_m[r]));
    }
    __syncthreads();
    if constexpr (kTC) {
#pragma unroll
      for (int kk = 0; kk < TN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sp + rt * 16 * LDP + kk, LDP);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sv + kk * LDV + ch * 64 + j * 16, LDV);
          wmma::mma_sync(facc[j], fa, fb, facc[j]);
        }
      }
    } else {
      const int col = tid % TF, r0 = tid / TF;
#pragma unroll 8
      for (int kk = 0; kk < TN; ++kk) {
        const float bv = to_f(sv[kk * LDV + col]);
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i] = fmaf(to_f(sp[(r0 + RS * i) * LDP + kk]), bv, acc[i]);
      }
    }
  }
  __syncthreads();  // the ring is free: stage the accumulator there
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(so + rt * 16 * LDO + ch * 64 + j * 16, facc[j],
                              LDO, wmma::mem_row_major);
  } else {
    const int col = tid % TF, r0 = tid / TF;
#pragma unroll
    for (int i = 0; i < RT; ++i) so[(r0 + RS * i) * LDO + col] = acc[i];
  }
  __syncthreads();
  T* og = static_cast<T*>(p.out) + ((long long)g * p.Q + q0) * p.F + f0;
  for (int i = tid; i < TQ * TF; i += kThreads) {
    const int r = i / TF, c = i % TF;
    if (r < q_rows && c < f_cols)
      og[(long long)r * p.F + c] = from_f<T>(so[r * LDO + c] / row_l[r]);
  }
}

// ------------------------------------------------------------ backward ----
//
// Replaces the Pallas flash backward of segtran_tpu/kernels/
// squeezed_attention.py (_flash_bwd_impl: _dkdv_kernel and _dq_kernel over
// _bwd_common). Per (query i, key j), recomputed from the saved fp32 lse and
// delta_i = sum_f dO_if O_if:
//
//     s_raw = scale q_i.k_j          p  = exp(clip(s_raw) - lse_i), 0 if padded
//     dp    = dO_i.v_j               ds = p (dp - delta_i) [|s_raw| < clip] scale
//     dV_j = sum_i p dO_i    dK_j = sum_i ds q_i    dQ_i = sum_j ds k_j
//
// all sums in fp32, each output rounded to T once. No [G, Q, N] tensor
// reaches device memory: O(Q + N) traffic, like the forward.
//
// What bounds it on an H100 SXM: at the path shape (in-squeeze at
// 160x192x144, bf16: G=1, Q=1024, N=8640, D=F=1024) the minimal work is
// five passes of 2 G Q N 1024 FLOP (S, dP, dV, dK, dQ): 9.1e10 FLOP, 92 us
// at 989 TFLOP/s, against ~60 MB of compulsory traffic (18 us at 3.35
// TB/s): bound by operations.
//
// The design. At D = F = 1024 a 64-key dK + dV fp32 accumulator is 512 KB,
// more than an SM holds, so the width is split over the CTAs of a
// thread-block cluster. With W = 128 columns (256 where D or F exceeds
// 1024), CTA c of a cluster of C = max(ceil(D/W), ceil(F/W)) <= 8 owns D
// slice c (if c < ceil(D/W)) and F slice c (if c < ceil(F/W)). For each
// (query tile, key tile) cell, CTA c computes the partial scores S_c =
// q[:, Dc] k[:, Dc]^T and dP_c = dO[:, Fc] v[:, Fc]^T over its slices; the
// cluster sums the partials through distributed shared memory (CTA c owns
// TB/C rows of the cell, reads them from every rank and sums them in rank
// order: deterministic, no atomics), forms p and ds for its rows from the
// lse and delta staged with the query tile, and stores them into every
// CTA's p / ds buffers. S and dP are computed once per cell:
//
// 1. dkdv_kernel: one cluster per (G, key tile). k[:, Dc] and v[:, Fc]
//    stay in shared memory; q[:, Dc] and dO[:, Fc] stream through a
//    3-slot cp.async ring. dV[:, Fc] += p^T dO[:, Fc] and dK[:, Dc] +=
//    ds^T q[:, Dc] accumulate in registers. Executed passes: S, dP, dV, dK
//    = 4. (The previous design gave each block one 128-column slice of one
//    output and recomputed S per slice and dP per dK slice: 26 passes at
//    D = F = 1024.)
// 2. dq_kernel: one cluster per (G, query tile, key split). q[:, Dc] and
//    dO[:, Fc] stay resident; k and v stream. dQ[:, Dc] += ds k[:, Dc]
//    into an fp32 partial per key split (scratch [splits, G, Q, D]), which
//    dq_sum_kernel sums in split order and rounds to T. The wrapper picks
//    the splits for about eight waves of clusters. Executed passes: S, dP,
//    dQ = 3 (17 before).
//
// Each cell costs two cluster barriers, each split into arrive and wait
// around half of the previous cell's products (dV, then dK; or the two
// key halves of dQ) to hide its latency: the first publishes the
// partials, the second p and ds, which alternate between two buffers so
// that a peer's stores of one cell never meet this CTA's products of the
// last. Tiles are TB x W with TB W sizeof(T) = 16 KB (bf16: 64 x 128 or 32
// x 256; fp32: 32 x 128 or 16 x 256); the carve-up takes 138-208 KB, one
// CTA of 8 warps per SM. What holds it back (tools/ablate_flash_bwd.py):
// each cell's chain of two cluster barriers and the DSMEM reduction, not
// the tensor cores. bf16 products run on the tensor cores through mma.sync
// m16n8k16 with ldmatrix operands and fp32 accumulators; p and ds are
// rounded to bf16 as operands, as before. mma.sync rather than wgmma: each
// warp owns 16 rows, which fits the 32-row tiles of the wide path and the
// row ownership of the cluster reduction, and needs no wgmma shared-memory
// layout for operands that are written by other CTAs. fp32 runs the same
// decomposition on the CUDA cores in full fp32 (no TF32), so the fp32
// build checks the indexing and the reduction exactly.

namespace cg = cooperative_groups;

constexpr int kRing = 3;        // slots of the streamed tiles' ring
constexpr int kMaxCluster = 8;  // portable cluster size

struct BwdParams {
  const void* q;       // [G, Q, D]
  const void* k;       // [G, N, D]
  const void* v;       // [G, N, F]
  const void* dout;    // [G, Q, F]
  const float* lse;    // [G, Q]
  const float* delta;  // [G, Q]
  void* dq;            // [G, Q, D]
  void* dk;            // [G, N, D]
  void* dv;            // [G, N, F]
  float* dq_part;      // [splits, G, Q, D] fp32
  int Q, N, D, F, splits;
  float scale, clip;
};

// tile rows TB, row strides (LD: W-wide tiles in T; LDS: fp32 partials;
// LDP: p / ds in T; each padded by 16 bytes against bank conflicts) and the
// accumulator floats per thread of one [TB, W] output
template <typename T, int W> struct Bwd {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int TB = 16384 / (W * static_cast<int>(sizeof(T)));
  static constexpr int LD = W + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDS = TB + 4;
  static constexpr int LDP = TB + 16 / static_cast<int>(sizeof(T));
  static constexpr int ACC = TB * W / kThreads;
  static constexpr int TILE = TB * LD;
  static constexpr size_t smem() {
    return sizeof(T) * (2 + 2 * kRing) * TILE +
           sizeof(float) * (2 * TB * LDS + 2 * kRing * TB) +
           sizeof(T) * 4 * TB * LDP;
  }
};

// the shared-memory carve-up of both backward kernels (the same in every
// CTA, so a peer's buffer is this CTA's address mapped to its rank)
template <typename T, int W> struct BwdSmem {
  T* res[2];  // resident tiles: k and v (dK/dV) or q and dO (dQ)
  T* ring;    // kRing slots of two streamed tiles
  float *ps, *pdp;      // this CTA's partial S and dP of the cell
  float* stats;         // kRing slots of lse [TB] and delta [TB]
  T* pds;               // two buffers of the cell's whole p and ds
  __device__ explicit BwdSmem(unsigned char* smem) {
    using B = Bwd<T, W>;
    res[0] = reinterpret_cast<T*>(smem);
    res[1] = res[0] + B::TILE;
    ring = res[1] + B::TILE;
    ps = reinterpret_cast<float*>(ring + 2 * kRing * B::TILE);
    pdp = ps + B::TB * B::LDS;
    stats = pdp + B::TB * B::LDS;
    pds = reinterpret_cast<T*>(stats + 2 * kRing * B::TB);
  }
  // lse (which 0) or delta (which 1) of the query rows of step t
  __device__ float* stat(int t, int which) const {
    return stats + (2 * (t % kRing) + which) * Bwd<T, W>::TB;
  }
  // p (which 0) or ds (which 1) of the cells of parity `buf`
  __device__ T* cell(int buf, int which) const {
    return pds + (2 * (buf & 1) + which) * Bwd<T, W>::TB * Bwd<T, W>::LDP;
  }
  // streamed tile `which` (0: D-wide, 1: F-wide) of step t
  __device__ T* slot(int t, int which) const {
    return ring + (2 * (t % kRing) + which) * Bwd<T, W>::TILE;
  }
};

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
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
// B fragment of the n8 tile n0 at depth k0 + [0, 16), B stored [n][k]
__device__ __forceinline__ void load_b_nk(unsigned (&b)[2], const bf16* X,
                                          int ld, int k0, int n0) {
  const int l = threadIdx.x & 15;  // lanes 16-31 repeat 0-15's addresses
  ldsm_x2(b, X + (n0 + (l & 7)) * ld + k0 + (l >> 3) * 8);
}
// the same for the n8 tiles n0 and n0 + 8 (b[0..1] and b[2..3])
__device__ __forceinline__ void load_b_nk2(unsigned (&b)[4], const bf16* X,
                                           int ld, int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, X + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
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

// out[TB][TB] (fp32, row stride LDS) = A . B^T over the W columns of one
// slice; A and B [TB][W] stored by rows (row stride LD)
template <typename T, int W>
__device__ void slice_scores(const T* A, const T* B, float* out) {
  using K = Bwd<T, W>;
  constexpr int TB = K::TB, LD = K::LD, LDS = K::LDS;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    // warp w: rows (w % WM) * 16, key columns (w / WM) * TB / WN
    constexpr int WM = TB / 16, WN = kWarps / WM, NT = TB / WN / 8;
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = (warp % WM) * 16, n0 = (warp / WM) * (TB / WN);
    float acc[NT][4] = {};
#pragma unroll 4
    for (int k0 = 0; k0 < W; k0 += 16) {
      unsigned a[4];
      load_a<false>(a, A, LD, m0, k0);
      if constexpr (NT % 2 == 0) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned b[4];
          load_b_nk2(b, B, LD, k0, n0 + j * 8);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          unsigned b[2];
          load_b_nk(b, B, LD, k0, n0 + j * 8);
          mma16816(acc[j], a, b[0], b[1]);
        }
      }
    }
    const int r = m0 + (lane >> 2), c = n0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      store_pair(out + r * LDS + c + j * 8, acc[j][0], acc[j][1]);
      store_pair(out + (r + 8) * LDS + c + j * 8, acc[j][2], acc[j][3]);
    }
  } else {
    // thread t: key column t % TB, rows t / TB + RS i
    constexpr int RS = kThreads / TB, RT = TB * TB / kThreads;
    const int col = tid % TB, r0 = tid / TB;
    float acc[RT] = {};
#pragma unroll 4
    for (int k = 0; k < W; k += 4) {
      const float4 b = *reinterpret_cast<const float4*>(B + col * LD + k);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(A + (r0 + RS * i) * LD + k);
        acc[i] = fmaf(a.x, b.x, acc[i]);
        acc[i] = fmaf(a.y, b.y, acc[i]);
        acc[i] = fmaf(a.z, b.z, acc[i]);
        acc[i] = fmaf(a.w, b.w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) out[(r0 + RS * i) * LDS + col] = acc[i];
  }
}

// acc[TB][W] += A . B over the rows [K0, K1) of a cell: A = X [TB][TB] or
// X^T (kTransA; X row stride LDP), B [TB][W] stored [k][n] (row stride
// LD). bf16: warp w owns rows (w % WM) * 16 and columns (w / WM) * 64,
// eight n8 tiles of four floats; fp32: thread t owns column t % W and rows
// t / W + RS i.
template <typename T, int W, bool kTransA, int K0, int K1>
__device__ __forceinline__ void accumulate(const T* X, const T* B,
                                           float (&acc)[Bwd<T, W>::ACC]) {
  using K = Bwd<T, W>;
  constexpr int TB = K::TB;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    constexpr int WM = TB / 16;
    const int warp = tid >> 5;
    const int m0 = (warp % WM) * 16, n0 = (warp / WM) * 64;
    static_assert(K0 % 16 == 0 && K1 % 16 == 0 && K1 <= TB, "k16 steps");
#pragma unroll
    for (int k0 = K0; k0 < K1; k0 += 16) {
      unsigned a[4];
      load_a<kTransA>(a, X, K::LDP, m0, k0);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned b[4];
        load_b_kn(b, B, K::LD, k0, n0 + j * 8);
        mma16816(acc + 4 * j, a, b[0], b[1]);
        mma16816(acc + 4 * j + 4, a, b[2], b[3]);
      }
    }
  } else {
    constexpr int RS = kThreads / W;
    const int col = tid % W, r0 = tid / W;
#pragma unroll 4
    for (int k = K0; k < K1; ++k) {
      const float b = B[k * K::LD + col];
#pragma unroll
      for (int i = 0; i < K::ACC; ++i) {
        const int r = r0 + RS * i;
        acc[i] = fmaf(kTransA ? X[k * K::LDP + r] : X[r * K::LDP + k], b,
                      acc[i]);
      }
    }
  }
}

// Write the [TB, W] accumulator to out (row stride ld, element type O:
// T, or fp32 for the dQ partials), rows < rows and columns < cols.
template <typename T, int W, typename O>
__device__ __forceinline__ void store_acc(const float (&acc)[Bwd<T, W>::ACC],
                                          O* out, long long ld, int rows,
                                          int cols) {
  using K = Bwd<T, W>;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    constexpr int WM = K::TB / 16;
    const int warp = tid >> 5, lane = tid & 31;
    const int r = (warp % WM) * 16 + (lane >> 2);
    const int c0 = (warp / WM) * 64 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j * 8;  // cols is even: a pair never straddles it
      if (c >= cols) continue;
      if (r < rows) store_pair(out + r * ld + c, acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < rows)
        store_pair(out + (r + 8) * ld + c, acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    constexpr int RS = kThreads / W;
    const int col = tid % W, r0 = tid / W;
    if (col >= cols) return;
#pragma unroll
    for (int i = 0; i < K::ACC; ++i) {
      const int r = r0 + RS * i;
      if (r < rows) out[r * ld + col] = acc[i];
    }
  }
}

// The rows of a cell that CTA `rank` owns: sum the partial S (ranks < nD)
// and dP (ranks < nF) in rank order through distributed shared memory,
// form ds and, with kWantP, p in T from the rows' lse and delta (lse_t,
// delta_t: [TB] in shared memory), and store them at their place in the
// p / ds buffers `buf` of every CTA of the cluster. q0, n0: the cell's
// first query and key.
template <typename T, int W, bool kWantP>
__device__ void publish_rows(const BwdParams& p, const BwdSmem<T, W>& sm,
                             const float* lse_t, const float* delta_t,
                             int buf, int q0, int n0, int rank, int C,
                             int nD, int nF) {
  using K = Bwd<T, W>;
  constexpr int TB = K::TB, HALF = TB / 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int rpc = (TB + C - 1) / C, r0 = rank * rpc, r1 = min(TB, r0 + rpc);
  for (int e = threadIdx.x; e < (r1 - r0) * HALF; e += kThreads) {
    const int r = r0 + e / HALF, c = (e % HALF) * 2;
    float2 xs[kMaxCluster], xd[kMaxCluster];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {  // all loads first, then sums
      if (i < nD)
        xs[i] = *cluster.map_shared_rank(
            reinterpret_cast<float2*>(sm.ps + r * K::LDS + c), i);
      if (i < nF)
        xd[i] = *cluster.map_shared_rank(
            reinterpret_cast<float2*>(sm.pdp + r * K::LDS + c), i);
    }
    float s[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < nD) {
        s[0] += xs[i].x;
        s[1] += xs[i].y;
      }
      if (i < nF) {
        dp[0] += xd[i].x;
        dp[1] += xd[i].y;
      }
    }
    const bool in_q = q0 + r < p.Q;
    const float lse = lse_t[r], delta = delta_t[r];
    float pv[2], dsv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float sr = s[j] * p.scale;
      const bool valid = in_q && n0 + c + j < p.N;
      pv[j] = valid ? expf(fminf(fmaxf(sr, -p.clip), p.clip) - lse) : 0.f;
      dsv[j] = fabsf(sr) < p.clip ? pv[j] * (dp[j] - delta) * p.scale : 0.f;
    }
    T* at_ds = sm.cell(buf, 1) + r * K::LDP + c;
    T* at_p = sm.cell(buf, 0) + r * K::LDP + c;
    for (int i = 0; i < C; ++i) {
      store_pair(cluster.map_shared_rank(at_ds, i), dsv[0], dsv[1]);
      if (kWantP) store_pair(cluster.map_shared_rank(at_p, i), pv[0], pv[1]);
    }
  }
}

// Stage lse and delta of the query rows [q0, q0 + TB) of group g into
// lse_t and delta_t, zero past the last query.
template <int TB>
__device__ __forceinline__ void stage_stats(const BwdParams& p, int g, int q0,
                                            float* lse_t, float* delta_t) {
  const int r = threadIdx.x;
  if (r < TB) {
    const bool in = q0 + r < p.Q;
    const long long at = in ? static_cast<long long>(g) * p.Q + q0 + r : 0;
    cp_async4(lse_t + r, p.lse + at, in ? 4 : 0);
    cp_async4(delta_t + r, p.delta + at, in ? 4 : 0);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(BwdParams p) {
  using K = Bwd<T, W>;
  constexpr int TB = K::TB;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T, W> sm(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int nD = (p.D + W - 1) / W, nF = (p.F + W - 1) / W;
  const bool has_d = rank < nD, has_f = rank < nF;
  const int g = blockIdx.y, n0 = blockIdx.x / C * TB, c0 = rank * W;
  const int k_rows = min(TB, p.N - n0);
  const T* qg = static_cast<const T*>(p.q) + (long long)g * p.Q * p.D + c0;
  const T* dog =
      static_cast<const T*>(p.dout) + (long long)g * p.Q * p.F + c0;
  if (has_d)
    stage_tile<T, TB, W>(sm.res[0], K::LD,
                         static_cast<const T*>(p.k) +
                             ((long long)g * p.N + n0) * p.D + c0,
                         p.D, k_rows, p.D - c0);
  if (has_f)
    stage_tile<T, TB, W>(sm.res[1], K::LD,
                         static_cast<const T*>(p.v) +
                             ((long long)g * p.N + n0) * p.F + c0,
                         p.F, k_rows, p.F - c0);
  const int nqt = (p.Q + TB - 1) / TB;
  auto issue = [&](int t) {  // q[:, Dc], dO[:, Fc], lse, delta of tile t
    if (t < nqt) {
      const int q0 = t * TB, rows = min(TB, p.Q - q0);
      stage_stats<TB>(p, g, q0, sm.stat(t, 0), sm.stat(t, 1));
      if (has_d)
        stage_tile<T, TB, W>(sm.slot(t, 0), K::LD, qg + (long long)q0 * p.D,
                             p.D, rows, p.D - c0);
      if (has_f)
        stage_tile<T, TB, W>(sm.slot(t, 1), K::LD, dog + (long long)q0 * p.F,
                             p.F, rows, p.F - c0);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  issue(0);
  cluster_arrive();  // every CTA of the cluster runs before any peer access
  float acc_k[K::ACC], acc_v[K::ACC];
#pragma unroll
  for (int i = 0; i < K::ACC; ++i) acc_k[i] = acc_v[i] = 0.f;
  cluster_wait();

  // Step t: the partials of query tile t; barrier X (they are published;
  // its latency hidden by dV of tile t - 1); tile t's p and ds, stored in
  // every CTA; barrier Y (they are published; hidden by dK of tile t - 1).
  // p / ds alternate between two buffers, so a peer's stores of tile t
  // never meet this CTA's products of tile t - 1.
  for (int t = 0; t <= nqt; ++t) {
    __syncthreads();  // the products of step t - 1 are done with its slot
    issue(t + 1);     // into the slot of tile t - 2
    cp_async_wait<1>();
    __syncthreads();
    if (t < nqt) {
      if (has_d) slice_scores<T, W>(sm.slot(t, 0), sm.res[0], sm.ps);
      if (has_f) slice_scores<T, W>(sm.slot(t, 1), sm.res[1], sm.pdp);
    }
    cluster_arrive();
    if (t > 0 && has_f)
      accumulate<T, W, true, 0, TB>(sm.cell(t - 1, 0), sm.slot(t - 1, 1),
                                    acc_v);
    cluster_wait();
    if (t < nqt)
      publish_rows<T, W, true>(p, sm, sm.stat(t, 0), sm.stat(t, 1), t,
                               t * TB, n0, rank, C, nD, nF);
    cluster_arrive();
    if (t > 0 && has_d)
      accumulate<T, W, true, 0, TB>(sm.cell(t - 1, 1), sm.slot(t - 1, 0),
                                    acc_k);
    cluster_wait();
  }
  if (has_d)
    store_acc<T, W>(acc_k,
                    static_cast<T*>(p.dk) + ((long long)g * p.N + n0) * p.D +
                        c0,
                    p.D, k_rows, p.D - c0);
  if (has_f)
    store_acc<T, W>(acc_v,
                    static_cast<T*>(p.dv) + ((long long)g * p.N + n0) * p.F +
                        c0,
                    p.F, k_rows, p.F - c0);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(BwdParams p) {
  using K = Bwd<T, W>;
  constexpr int TB = K::TB;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<T, W> sm(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int nD = (p.D + W - 1) / W, nF = (p.F + W - 1) / W;
  const bool has_d = rank < nD, has_f = rank < nF;
  const int g = blockIdx.z, q0 = blockIdx.x / C * TB, c0 = rank * W;
  const int q_rows = min(TB, p.Q - q0);
  const int nt = (p.N + TB - 1) / TB, per = (nt + p.splits - 1) / p.splits;
  const int t0 = blockIdx.y * per, m = min(nt, t0 + per) - t0;
  if (has_d)
    stage_tile<T, TB, W>(sm.res[0], K::LD,
                         static_cast<const T*>(p.q) +
                             ((long long)g * p.Q + q0) * p.D + c0,
                         p.D, q_rows, p.D - c0);
  if (has_f)
    stage_tile<T, TB, W>(sm.res[1], K::LD,
                         static_cast<const T*>(p.dout) +
                             ((long long)g * p.Q + q0) * p.F + c0,
                         p.F, q_rows, p.F - c0);
  stage_stats<TB>(p, g, q0, sm.stat(0, 0), sm.stat(0, 1));  // for every step
  const T* kg = static_cast<const T*>(p.k) + (long long)g * p.N * p.D + c0;
  const T* vg = static_cast<const T*>(p.v) + (long long)g * p.N * p.F + c0;
  auto issue = [&](int i) {  // k[:, Dc] and v[:, Fc] of the split's tile i
    if (i < m) {
      const int n0 = (t0 + i) * TB, rows = min(TB, p.N - n0);
      if (has_d)
        stage_tile<T, TB, W>(sm.slot(i, 0), K::LD, kg + (long long)n0 * p.D,
                             p.D, rows, p.D - c0);
      if (has_f)
        stage_tile<T, TB, W>(sm.slot(i, 1), K::LD, vg + (long long)n0 * p.F,
                             p.F, rows, p.F - c0);
    }
    cp_async_commit();
  };
  issue(0);
  cluster_arrive();
  float acc[K::ACC];
#pragma unroll
  for (int i = 0; i < K::ACC; ++i) acc[i] = 0.f;
  cluster_wait();

  // the schedule of dkdv_kernel over the split's key tiles; the two
  // barriers are hidden by the two halves (keys) of tile i - 1's product
  for (int i = 0; i <= m; ++i) {
    __syncthreads();
    issue(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (i < m) {
      if (has_d) slice_scores<T, W>(sm.res[0], sm.slot(i, 0), sm.ps);
      if (has_f) slice_scores<T, W>(sm.res[1], sm.slot(i, 1), sm.pdp);
    }
    cluster_arrive();
    if (i > 0 && has_d)
      accumulate<T, W, false, 0, TB / 2>(sm.cell(i - 1, 1),
                                         sm.slot(i - 1, 0), acc);
    cluster_wait();
    if (i < m)
      publish_rows<T, W, false>(p, sm, sm.stat(0, 0), sm.stat(0, 1), i, q0,
                                (t0 + i) * TB, rank, C, nD, nF);
    cluster_arrive();
    if (i > 0 && has_d)
      accumulate<T, W, false, TB / 2, TB>(sm.cell(i - 1, 1),
                                          sm.slot(i - 1, 0), acc);
    cluster_wait();
  }
  if (has_d)
    store_acc<T, W>(acc,
                    p.dq_part +
                        (((long long)blockIdx.y * gridDim.z + g) * p.Q + q0) *
                            p.D +
                        c0,
                    p.D, q_rows, p.D - c0);
}

// dq = the key splits' fp32 partials summed in split order, rounded to T;
// four elements per thread (D is a multiple of 4)
template <typename T>
__global__ void dq_sum_kernel(const float* part, T* dq, long long count,
                              int splits) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= count) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int k = 1; k < splits; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(part + k * count + i);
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  dq[i] = from_f<T>(s.x);
  dq[i + 1] = from_f<T>(s.y);
  dq[i + 2] = from_f<T>(s.z);
  dq[i + 3] = from_f<T>(s.w);
}

template <typename T, int W>
cudaLaunchConfig_t bwd_config(const BwdParams& p, int G, bool dkdv, int C,
                              cudaLaunchAttribute* attr, cudaStream_t stream) {
  using K = Bwd<T, W>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dkdv ? dim3(C * ((p.N + K::TB - 1) / K::TB), G, 1)
                     : dim3(C * ((p.Q + K::TB - 1) / K::TB), p.splits, G);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = K::smem();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int W>
cudaError_t launch_bwd_w(const BwdParams& p, int G, bool dkdv, int C,
                         cudaStream_t stream) {
  auto kern = dkdv ? dkdv_kernel<T, W> : dq_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Bwd<T, W>::smem()));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_config<T, W>(p, G, dkdv, C, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess || dkdv) return e;
  const long long count = static_cast<long long>(G) * p.Q * p.D;
  const unsigned blocks =
      static_cast<unsigned>((count / 4 + kThreads - 1) / kThreads);
  dq_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(
      p.dq_part, static_cast<T*>(p.dq), count, p.splits);
  return cudaGetLastError();
}

// the cluster size of width W, or 0 where W is not one of the kernels'
int bwd_cluster(int D, int F, int W) {
  if (W != 128 && W != 256) return 0;
  const int C = max((D + W - 1) / W, (F + W - 1) / W);
  return C <= kMaxCluster ? C : 0;
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int G, bool dkdv, int W,
                       cudaStream_t stream) {
  const int C = bwd_cluster(p.D, p.F, W);
  if (C == 0 || p.splits < 1) return cudaErrorInvalidValue;
  return W == 128 ? launch_bwd_w<T, 128>(p, G, dkdv, C, stream)
                  : launch_bwd_w<T, 256>(p, G, dkdv, C, stream);
}

template <typename T, int W>
cudaError_t bwd_occupancy_w(bool dkdv, int C, int* smem, int* clusters) {
  auto kern = dkdv ? dkdv_kernel<T, W> : dq_kernel<T, W>;
  *smem = static_cast<int>(Bwd<T, W>::smem());
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  BwdParams p = {};
  p.Q = p.N = Bwd<T, W>::TB;
  p.splits = 1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_config<T, W>(p, 1, dkdv, C, &attr, 0);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

template <typename T>
cudaError_t launch(const Params& p, int G, cudaStream_t stream) {
  const int qt = (p.Q + TQ - 1) / TQ;
  auto sk = stats_kernel<T>;
  auto ok = out_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      sk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(stats_smem<T>()));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ok, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(out_smem<T>()));
  if (e != cudaSuccess) return e;
  sk<<<dim3(qt, p.splits, G), kThreads, stats_smem<T>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ok<<<dim3(qt, (p.F + TF - 1) / TF, G), kThreads, out_smem<T>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [G,Q,D], k [G,N,D], v [G,N,F] -> out [G,Q,F] (compute type), lse [G,Q]
// fp32; pm, pl: fp32 scratch of G*splits*Q each. Every one of the `splits`
// key slices must hold at least one key tile (the wrapper picks splits).
int flash_fwd(int is_bf16, const void* q, const void* k, const void* v,
              void* out, float* lse, float* pm, float* pl, int G, int Q, int N,
              int D, int F, int splits, double scale, double clip,
              void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse; p.pm = pm; p.pl = pl;
  p.Q = Q; p.N = N; p.D = D; p.F = F; p.splits = splits;
  p.scale = static_cast<float>(scale);
  p.clip = static_cast<float>(clip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<bf16>(p, G, st)
                                  : launch<float>(p, G, st));
}

// The flash backward: `dkdv` != 0 writes dk [G,N,D] and dv [G,N,F], else
// dq [G,Q,D] (compute type; the other outputs may be null) through the fp32
// scratch dq_part of splits*G*Q*D floats. lse, delta: fp32 [G,Q]. `width`
// (128 or 256) is the column slice of each CTA of a cluster; `splits` the
// dQ key splits, each holding at least one key tile (the wrapper's plan).
int flash_bwd(int is_bf16, int dkdv, const void* q, const void* k,
              const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv,
              float* dq_part, int G, int Q, int N, int D, int F, int width,
              int splits, double scale, double clip, void* stream) {
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dq_part = dq_part;
  p.Q = Q; p.N = N; p.D = D; p.F = F; p.splits = splits;
  p.scale = static_cast<float>(scale);
  p.clip = static_cast<float>(clip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_bwd<bf16>(p, G, dkdv != 0, width, st)
              : launch_bwd<float>(p, G, dkdv != 0, width, st));
}

// The shared-memory bytes of one CTA of a backward kernel at `width`, and
// how many of its clusters of `cluster` CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters).
int flash_bwd_occupancy(int is_bf16, int dkdv, int width, int cluster,
                        int* smem_bytes, int* max_clusters) {
  if ((width != 128 && width != 256) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool dk = dkdv != 0;
  int* sm = smem_bytes;
  int* mc = max_clusters;
  cudaError_t e;
  if (is_bf16)
    e = width == 128 ? bwd_occupancy_w<bf16, 128>(dk, cluster, sm, mc)
                     : bwd_occupancy_w<bf16, 256>(dk, cluster, sm, mc);
  else
    e = width == 128 ? bwd_occupancy_w<float, 128>(dk, cluster, sm, mc)
                     : bwd_occupancy_w<float, 256>(dk, cluster, sm, mc);
  return static_cast<int>(e);
}

}  // extern "C"
