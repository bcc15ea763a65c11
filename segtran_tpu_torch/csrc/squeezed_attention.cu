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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
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
// Replaces the Pallas flash backward (_flash_bwd_impl): _dkdv_kernel and
// _dq_kernel over _bwd_common. Per (query i, key j), recomputed from the
// saved fp32 lse and delta_i = sum_f dO_if O_if:
//
//     s_raw = scale q_i.k_j          p  = exp(clip(s_raw) - lse_i), 0 if padded
//     dp    = dO_i.v_j               ds = p (dp - delta_i) [|s_raw| < clip] scale
//     dV_j = sum_i p dO_i    dK_j = sum_i ds q_i    dQ_i = sum_j ds k_j
//
// all sums in fp32, outputs rounded to T. No [G, Q, N] tensor reaches
// device memory: O(Q + N) traffic, like the forward.
//
// What bounds it on an H100 SXM: at the path shape (in-squeeze at
// 160x192x144, bf16: G=1, Q=1024, N=8640, D=F=1024) the minimal work is
// 2 G Q N (3D + 2F) = 9.1e10 FLOP (92 us at 989 TFLOP/s) against ~60 MB of
// compulsory traffic (18 us): bound by operations.
//
// The design. The TPU kernels keep [TN, D] + [TN, F] (dK/dV) or [TQ, D]
// (dQ) fp32 accumulators in VMEM; at D = F = 1024 a 64-row dK+dV
// accumulator is 512 KB, more than the register file and shared memory.
// So, as the forward splits F, every block owns one 128-column slice of
// one output and recomputes what that slice needs:
//
// 1. dkdv_kernel: per (G, 64-key tile, slice) it walks every 64-row query
//    tile. A dV slice needs only p: s = q k^T over all of D (the forward's
//    cp.async ring), then acc += p^T dO[:, slice]. A dK slice needs ds: s
//    over D and dp = dO v^T over all of F, then acc += ds^T q[:, slice].
//    blockIdx.y < F/128 picks a dV slice, the rest dK slices.
// 2. dq_kernel: per (G, 64-row query tile, D slice) it walks every key
//    tile: s, dp, ds, then acc += ds k[:, slice].
//
// Each block sums its own slice in a fixed order, so the results are
// deterministic (no atomics). The price is the recompute: q k^T once per
// slice and dO v^T once per dK/dQ slice, ~8x the minimal work at D = F =
// 1024. bf16 products run on the tensor cores through WMMA (p and ds are
// rounded to bf16 as operands, fp32 accumulate); fp32 runs on the CUDA
// cores in full fp32. Padded queries and keys are masked in-kernel.

struct BwdParams {
  const void* q;     // [G, Q, D]
  const void* k;     // [G, N, D]
  const void* v;     // [G, N, F]
  const void* dout;  // [G, Q, F]
  const float* lse;  // [G, Q]
  const float* delta;  // [G, Q]
  void* dq;          // [G, Q, D]
  void* dk;          // [G, N, D]
  void* dv;          // [G, N, F]
  int Q, N, D, F;
  float scale, clip;
};

template <typename T> constexpr size_t bwd_smem() {
  using S = Tile<T>;
  return ring_bytes<T>() + sizeof(float) * 2 * TQ * S::LDS +
         sizeof(T) * TQ * S::LDP + sizeof(T) * TN * S::LDV +
         sizeof(float) * 2 * TQ;
}

// p (or ds when `want_ds`) of one (query tile, key tile) cell into sp[q][k]
// in T, from the raw dots in ss (q k^T) and sd (dO v^T).
template <typename T>
__device__ __forceinline__ void probs_tile(const BwdParams& p, const float* ss,
                                           const float* sd, const float* lse,
                                           const float* delta, T* sp, int q0,
                                           int n0, bool want_ds) {
  using S = Tile<T>;
  for (int i = threadIdx.x; i < TQ * TN; i += kThreads) {
    const int r = i / TN, c = i % TN;
    const float sr = ss[r * S::LDS + c] * p.scale;
    const bool valid = q0 + r < p.Q && n0 + c < p.N;
    float x = valid ? expf(fminf(fmaxf(sr, -p.clip), p.clip) - lse[r]) : 0.f;
    if (want_ds)
      x = fabsf(sr) < p.clip ? x * (sd[r * S::LDS + c] - delta[r]) * p.scale
                             : 0.f;
    sp[r * S::LDP + c] = from_f<T>(x);
  }
}

// acc[64 rows, 128 cols] += A . sx, A = sp (kTransA: sp^T), 64 deep.
template <typename T, bool kTransA, typename Frag>
__device__ __forceinline__ void accumulate(const T* sp, const T* sx,
                                           Frag* facc, float* acc) {
  using S = Tile<T>;
  constexpr int LDP = S::LDP, LDV = S::LDV;
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid >> 5, rt = warp % 4, ch = warp / 4;
    using Layout = typename std::conditional<kTransA, wmma::col_major,
                                             wmma::row_major>::type;
#pragma unroll
    for (int kk = 0; kk < TQ; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout> fa;
      // sp^T as a column-major A: (row, col) at col * LDP + row
      wmma::load_matrix_sync(fa, kTransA ? sp + kk * LDP + rt * 16
                                         : sp + rt * 16 * LDP + kk, LDP);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sx + kk * LDV + ch * 64 + j * 16, LDV);
        wmma::mma_sync(facc[j], fa, fb, facc[j]);
      }
    }
  } else {
    constexpr int RS = kThreads / TF, RT = TQ / RS;
    const int col = tid % TF, r0 = tid / TF;
#pragma unroll 8
    for (int kk = 0; kk < TQ; ++kk) {
      const float bv = to_f(sx[kk * LDV + col]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + RS * i;
        acc[i] = fmaf(to_f(kTransA ? sp[kk * LDP + r] : sp[r * LDP + kk]), bv,
                      acc[i]);
      }
    }
  }
}

// Write the [64, 128] fp32 accumulator, rounded to T, to out (row stride
// ld), rows < rows_valid and cols < cols_valid; staged through `so`.
template <typename T, typename Frag>
__device__ __forceinline__ void store_acc(Frag* facc, const float* acc,
                                          float* so, T* out, long long ld,
                                          int rows_valid, int cols_valid) {
  constexpr int LDO = Tile<T>::LDO;
  const int tid = threadIdx.x;
  __syncthreads();  // the ring is free: stage the accumulator there
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int warp = tid >> 5, rt = warp % 4, ch = warp / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(so + rt * 16 * LDO + ch * 64 + j * 16, facc[j],
                              LDO, wmma::mem_row_major);
  } else {
    constexpr int RS = kThreads / TF, RT = TQ / RS;
    const int col = tid % TF, r0 = tid / TF;
#pragma unroll
    for (int i = 0; i < RT; ++i) so[(r0 + RS * i) * LDO + col] = acc[i];
  }
  __syncthreads();
  for (int i = tid; i < TQ * TF; i += kThreads) {
    const int r = i / TF, c = i % TF;
    if (r < rows_valid && c < cols_valid)
      out[(long long)r * ld + c] = from_f<T>(so[r * LDO + c]);
  }
}

// the shared-memory carve-up of both backward kernels
template <typename T> struct BwdSmem {
  T *sq, *sk, *sp, *sx;
  float *ss, *sd, *lse, *delta, *so;
  __device__ explicit BwdSmem(unsigned char* smem) {
    using S = Tile<T>;
    sq = reinterpret_cast<T*>(smem);
    sk = sq + kStages * TQ * S::LDK;
    ss = reinterpret_cast<float*>(sk + kStages * TN * S::LDK);
    sd = ss + TQ * S::LDS;
    sp = reinterpret_cast<T*>(sd + TQ * S::LDS);
    sx = sp + TQ * S::LDP;
    lse = reinterpret_cast<float*>(sx + TN * S::LDV);
    delta = lse + TQ;
    so = reinterpret_cast<float*>(smem);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem<T> sm(smem);
  const int g = blockIdx.z, n0 = blockIdx.x * TN;
  const int n_dv = (p.F + TF - 1) / TF;
  const bool is_dk = blockIdx.y >= n_dv;
  const int c0 = (is_dk ? blockIdx.y - n_dv : blockIdx.y) * TF;
  const int width = is_dk ? p.D : p.F;  // of the output and of the X slice
  const int k_rows = min(TN, p.N - n0);
  const T* qg = static_cast<const T*>(p.q) + (long long)g * p.Q * p.D;
  const T* kt = static_cast<const T*>(p.k) + ((long long)g * p.N + n0) * p.D;
  const T* vt = static_cast<const T*>(p.v) + ((long long)g * p.N + n0) * p.F;
  const T* dog = static_cast<const T*>(p.dout) + (long long)g * p.Q * p.F;
  // X = q[:, slice] (dK) or dO[:, slice] (dV)
  const T* xg = (is_dk ? qg : dog) + c0;

  using namespace nvcuda;
  constexpr bool kTC = std::is_same<T, bf16>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[kTC ? 4 : 1];
  constexpr int RT = TQ / (kThreads / TF);
  float acc[kTC ? 1 : RT];
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(facc[j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
  }

  const int nqt = (p.Q + TQ - 1) / TQ;
  for (int t = 0; t < nqt; ++t) {
    const int q0 = t * TQ, q_rows = min(TQ, p.Q - q0);
    // the previous tile's reads of these ended at its post-probs barrier
    if (threadIdx.x < TQ) {
      const bool in = threadIdx.x < q_rows;
      const long long at = (long long)g * p.Q + q0 + threadIdx.x;
      sm.lse[threadIdx.x] = in ? p.lse[at] : 0.f;
      sm.delta[threadIdx.x] = in ? p.delta[at] : 0.f;
    }
    score_tile<T>(qg + (long long)q0 * p.D, q_rows, kt, k_rows, p.D, sm.sq,
                  sm.sk, sm.ss, [&] {
                    stage_tile<T, TQ, TF>(sm.sx, Tile<T>::LDV,
                                          xg + (long long)q0 * width, width,
                                          q_rows, width - c0);
                  });
    if (is_dk)
      score_tile<T>(dog + (long long)q0 * p.F, q_rows, vt, k_rows, p.F, sm.sq,
                    sm.sk, sm.sd, [] {});
    probs_tile<T>(p, sm.ss, sm.sd, sm.lse, sm.delta, sm.sp, q0, n0, is_dk);
    __syncthreads();
    accumulate<T, true>(sm.sp, sm.sx, facc, acc);
  }
  T* out = static_cast<T*>(is_dk ? p.dk : p.dv) +
           ((long long)g * p.N + n0) * width + c0;
  store_acc<T>(facc, acc, sm.so, out, width, k_rows, width - c0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem<T> sm(smem);
  const int g = blockIdx.z, q0 = blockIdx.x * TQ, c0 = blockIdx.y * TF;
  const int q_rows = min(TQ, p.Q - q0);
  const T* qt = static_cast<const T*>(p.q) + ((long long)g * p.Q + q0) * p.D;
  const T* kg = static_cast<const T*>(p.k) + (long long)g * p.N * p.D;
  const T* vg = static_cast<const T*>(p.v) + (long long)g * p.N * p.F;
  const T* dot = static_cast<const T*>(p.dout) + ((long long)g * p.Q + q0) * p.F;
  if (threadIdx.x < TQ) {  // read after score_tile's first barrier
    const bool in = threadIdx.x < q_rows;
    const long long at = (long long)g * p.Q + q0 + threadIdx.x;
    sm.lse[threadIdx.x] = in ? p.lse[at] : 0.f;
    sm.delta[threadIdx.x] = in ? p.delta[at] : 0.f;
  }

  using namespace nvcuda;
  constexpr bool kTC = std::is_same<T, bf16>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[kTC ? 4 : 1];
  constexpr int RT = TQ / (kThreads / TF);
  float acc[kTC ? 1 : RT];
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(facc[j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
  }

  const int nt = (p.N + TN - 1) / TN;
  for (int t = 0; t < nt; ++t) {
    const int n0 = t * TN, k_rows = min(TN, p.N - n0);
    score_tile<T>(qt, q_rows, kg + (long long)n0 * p.D, k_rows, p.D, sm.sq,
                  sm.sk, sm.ss, [&] {
                    stage_tile<T, TN, TF>(sm.sx, Tile<T>::LDV,
                                          kg + (long long)n0 * p.D + c0, p.D,
                                          k_rows, p.D - c0);
                  });
    score_tile<T>(dot, q_rows, vg + (long long)n0 * p.F, k_rows, p.F, sm.sq,
                  sm.sk, sm.sd, [] {});
    probs_tile<T>(p, sm.ss, sm.sd, sm.lse, sm.delta, sm.sp, q0, n0, true);
    __syncthreads();
    accumulate<T, false>(sm.sp, sm.sx, facc, acc);
  }
  T* out = static_cast<T*>(p.dq) + ((long long)g * p.Q + q0) * p.D + c0;
  store_acc<T>(facc, acc, sm.so, out, p.D, q_rows, p.D - c0);
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int G, bool dkdv,
                       cudaStream_t stream) {
  auto kern = dkdv ? dkdv_kernel<T> : dq_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem<T>()));
  if (e != cudaSuccess) return e;
  const dim3 grid =
      dkdv ? dim3((p.N + TN - 1) / TN, (p.F + TF - 1) / TF + (p.D + TF - 1) / TF,
                  G)
           : dim3((p.Q + TQ - 1) / TQ, (p.D + TF - 1) / TF, G);
  kern<<<grid, kThreads, bwd_smem<T>(), stream>>>(p);
  return cudaGetLastError();
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

// The flash backward, one kernel per call: `dkdv` != 0 writes dk [G,N,D]
// and dv [G,N,F], else dq [G,Q,D] (compute type; the other outputs may be
// null). lse, delta: fp32 [G,Q].
int flash_bwd(int is_bf16, int dkdv, const void* q, const void* k,
              const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, int G, int Q,
              int N, int D, int F, double scale, double clip, void* stream) {
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.Q = Q; p.N = N; p.D = D; p.F = F;
  p.scale = static_cast<float>(scale);
  p.clip = static_cast<float>(clip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_bwd<bf16>(p, G, dkdv != 0, st)
                                  : launch_bwd<float>(p, G, dkdv != 0, st));
}

}  // extern "C"
