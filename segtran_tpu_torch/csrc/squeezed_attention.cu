// Flash cross-attention for Hopper (sm_90a), forward and backward. The
// forward:
//
//     s   = clip(q k^T * scale, -clip, clip)      fp32, padded keys -inf
//     m   = max_n s,  l = sum_n exp(s - m)        fp32, online over key tiles
//     out = (sum_n T(exp(s - m)) v) / l           fp32 sum, rounded to T once
//     lse = m + log(l)                            fp32
//
// with q [G, Q, D], k [G, N, D], v [G, N, F] in the compute type T (bf16 or
// fp32). Replaces the Pallas forward of segtran_tpu/kernels/
// squeezed_attention.py (_fused_forward / _attn_kernel): per key tile the
// running max m and sum l are updated, p = exp(s - m_new) is rounded to T
// against the running max (JAX's rounding point, `p.astype(v.dtype)`), and
// the fp32 accumulator is rescaled by alpha = exp(m_old - m_new).
//
// What bounds it on an H100 SXM: at the BraTS whole-volume shapes (bf16;
// in-squeeze G=1, Q=1024, N=8640, D=F=1024; out-squeeze G=4, Q=8640,
// N=1024, D=256, F=1024) the work is 2*G*Q*N*(D+F) FLOP of matrix products
// (3.6e10 and 9.1e10, 37 and 92 us at 989 TFLOP/s) against 20-90 MB of
// compulsory traffic (6-27 us at 3.35 TB/s): bound by operations.
//
// The design (fwd_kernel, after the backward below, whose machinery it
// shares). The TPU kernel keeps a [TQ, F] fp32 accumulator in VMEM; at
// F=1024 a 64-row accumulator is 256 KB, more than an SM holds. So the
// width is split over the CTAs of a thread-block cluster, as in the
// backward: with W = 128 columns (256 where D or F exceeds 1024), CTA c of a
// cluster of C = max(ceil(D/W), ceil(F/W)) <= 8 owns F slice c and keeps
// q[:, D slice c % nD] of its TB-row query tile resident (nD = ceil(D/W),
// TB W sizeof(T) = 16 KB). A cell is that query tile by a tile of TK = 2 TB
// keys (64 x 128 in bf16 at W = 128). Per cell, the ranks below nD compute
// the partial scores q k^T over their D slice, each over all TK keys or,
// where the cluster has room for two ranks per slice (2 nD <= C, as at the
// out-squeeze's D=256), ranks [0, 2 nD) over one key half each; the owner
// of each row (TB/C rows per CTA) sums the partials in slice order through
// distributed shared memory, scales, clips and masks them, updates the
// row's m and l in its own shared memory, and stores p and alpha into
// every CTA's buffers; ranks < ceil(F/W) rescale their accumulator rows by
// alpha and add p v[:, Fc]. Each score tile is computed once, and the keys
// are walked once.
//
// The schedule: one cluster barrier per cell. Step i computes tile i's
// partial scores, passes the barrier (after which they, and tile i - 1's p
// and alpha, are visible everywhere), loads k of tile i + 1 and v of tile
// i, publishes tile i's p and alpha and adds tile i - 1's p v. Partial
// scores, p and alpha alternate between two buffers, so one barrier orders
// both the reads and the reuse; k has one slot (loaded after its scores)
// and v two: 227,584 bytes of shared memory in bf16 at W = 128, one CTA of
// 8 warps per SM. What holds it back is not the tensor work but each
// cell's chain: the scores of the ranks that compute them, the barrier
// and distributed shared memory, the softmax step and the loads, each
// 10-25% (tools/ablate_flash_fwd.py). The cell of 2 TB keys, the single
// barrier and the key halves each took 15-30% off the time at the path
// shapes; the wider W = 256 (half the rows per cell) measured slower at
// every shape where both fit, so the plan keeps W = 128 up to D, F = 1024.
//
// Executed passes of 2 G Q N x (width), counted against the minimal S + PV:
// the previous pair of kernels (a statistics pass, then one output block
// per 128-column F slice recomputing q k^T) executed 10 at the in-squeeze
// (S 1 + 8, PV 1), 3.25 at the out-squeeze and 16 at D=F=1792 (S 1 + 14,
// PV 1); this kernel executes 2, 1.25 and 2, the minimum.
//
// Q=1024 gives only 16 query tiles, so the keys are split over clusters
// (about eight waves, as dQ splits them). With one split the kernel writes
// out = acc / l (each CTA reads its rows' l from their owners) and lse;
// with more, each split writes its fp32 acc and (m, l) to scratch and
// fwd_merge_kernel rescales them to the common max in split order: no
// atomics, bit-for-bit repeatable. Every split holds at least one key tile
// and every key tile at least one valid key, so m is finite after a
// split's first tile and no -inf - (-inf) arises.
//
// mma.sync (m16n8k16, ldmatrix operands, fp32 accumulators) rather than
// wgmma: each warp owns 16 rows of a 64- or 32-row tile, which fits the
// row ownership of the cluster reduction and the per-row rescale (a
// thread's accumulator rows are r and r + 8, two multiplies per fragment),
// and the p operand is written by other CTAs, so it needs no wgmma
// shared-memory layout. fp32 runs the same decomposition on the CUDA cores
// in full fp32 (no TF32), so the fp32 build checks the indexing, the
// rescale and the merge exactly. Ragged Q, N, D and F are masked in-kernel;
// D and F must be multiples of 16 bytes' worth of elements (the wrapper
// checks).

#include <math.h>

#include <type_traits>

#include "cluster_mma.cuh"

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

constexpr int kRing = 3;        // slots of the streamed tiles' ring

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

// The cell geometry of the cluster kernels (forward and backward): tile
// rows TB, row strides (LD: W-wide tiles in T; LDS: fp32 partials; LDP: p /
// ds in T; each padded by 16 bytes against bank conflicts) and the
// accumulator floats per thread of one [TB, W] output
template <typename T, int W> struct Cell {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int TB = 16384 / (W * static_cast<int>(sizeof(T)));
  static constexpr int LD = W + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDS = TB + 4;
  static constexpr int LDP = TB + 16 / static_cast<int>(sizeof(T));
  static constexpr int ACC = TB * W / kThreads;
  static constexpr int TILE = TB * LD;
};

// the shared-memory carve-up of both backward kernels (the same in every
// CTA, so a peer's buffer is this CTA's address mapped to its rank)
template <typename T, int W> struct BwdSmem {
  static constexpr size_t bytes() {
    using B = Cell<T, W>;
    return sizeof(T) * (2 + 2 * kRing) * B::TILE +
           sizeof(float) * (2 * B::TB * B::LDS + 2 * kRing * B::TB) +
           sizeof(T) * 4 * B::TB * B::LDP;
  }
  T* res[2];  // resident tiles: k and v (dK/dV) or q and dO (dQ)
  T* ring;    // kRing slots of two streamed tiles
  float *ps, *pdp;      // this CTA's partial S and dP of the cell
  float* stats;         // kRing slots of lse [TB] and delta [TB]
  T* pds;               // two buffers of the cell's whole p and ds
  __device__ explicit BwdSmem(unsigned char* smem) {
    using B = Cell<T, W>;
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
    return stats + (2 * (t % kRing) + which) * Cell<T, W>::TB;
  }
  // p (which 0) or ds (which 1) of the cells of parity `buf`
  __device__ T* cell(int buf, int which) const {
    return pds + (2 * (buf & 1) + which) * Cell<T, W>::TB * Cell<T, W>::LDP;
  }
  // streamed tile `which` (0: D-wide, 1: F-wide) of step t
  __device__ T* slot(int t, int which) const {
    return ring + (2 * (t % kRing) + which) * Cell<T, W>::TILE;
  }
};

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
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

// out[TB][NB] (fp32, row stride LDS) = A . B^T over the W columns of one
// slice; A [TB][W] and B [NB][W] stored by rows (row stride LD)
template <typename T, int W, int LDS = Cell<T, W>::LDS,
          int NB = Cell<T, W>::TB>
__device__ void slice_scores(const T* A, const T* B, float* out) {
  using K = Cell<T, W>;
  constexpr int TB = K::TB, LD = K::LD;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    // warp w: rows (w % WM) * 16, key columns (w / WM) * NB / WN
    constexpr int WM = TB / 16, WN = kWarps / WM, NT = NB / WN / 8;
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = (warp % WM) * 16, n0 = (warp / WM) * (NB / WN);
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
    // thread t: key column t % NB, rows t / NB + RS i
    constexpr int RS = kThreads / NB, RT = TB * NB / kThreads;
    const int col = tid % NB, r0 = tid / NB;
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

// acc[TB][W] += A . B over the rows [K0, K1) of a cell: A = X [TB][K1] or
// X^T (kTransA; X row stride LDX), B [K1][W] stored [k][n] (row stride
// LD). bf16: warp w owns rows (w % WM) * 16 and columns (w / WM) * 64,
// eight n8 tiles of four floats; fp32: thread t owns column t % W and rows
// t / W + RS i.
template <typename T, int W, bool kTransA, int K0, int K1,
          int LDX = Cell<T, W>::LDP>
__device__ __forceinline__ void accumulate(const T* X, const T* B,
                                           float (&acc)[Cell<T, W>::ACC]) {
  using K = Cell<T, W>;
  constexpr int TB = K::TB;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    constexpr int WM = TB / 16;
    const int warp = tid >> 5;
    const int m0 = (warp % WM) * 16, n0 = (warp / WM) * 64;
    static_assert(K0 % 16 == 0 && K1 % 16 == 0, "k16 steps");
#pragma unroll
    for (int k0 = K0; k0 < K1; k0 += 16) {
      unsigned a[4];
      load_a<kTransA>(a, X, LDX, m0, k0);
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
        acc[i] = fmaf(kTransA ? X[k * LDX + r] : X[r * LDX + k], b, acc[i]);
      }
    }
  }
}

// Write the [TB, W] accumulator to out (row stride ld, element type O:
// T, or fp32 for the dQ partials), rows < rows and columns < cols.
template <typename T, int W, typename O>
__device__ __forceinline__ void store_acc(const float (&acc)[Cell<T, W>::ACC],
                                          O* out, long long ld, int rows,
                                          int cols) {
  using K = Cell<T, W>;
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
  using K = Cell<T, W>;
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
  using K = Cell<T, W>;
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
  using K = Cell<T, W>;
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

// ------------------------------------------------------------- forward ----
//
// fwd_kernel: one cluster per (G, query tile, key split), over the split's
// key tiles (the note at the top of this file).

struct FwdParams {
  const void* q;    // [G, Q, D]
  const void* k;    // [G, N, D]
  const void* v;    // [G, N, F]
  void* out;        // [G, Q, F]
  float* lse;       // [G, Q]
  float* acc_part;  // [splits, G, Q, F] fp32 (more than one split)
  float* ml_part;   // [2, splits, G, Q] fp32: m, then l
  int Q, N, D, F, splits;
  float scale, clip;
};

// The forward's cell: TB query rows by TK = 2 TB keys (the backward's
// cells are TB x TB), so that each cluster barrier covers twice the keys:
// k and v tiles of TK rows, fp32 partial scores (row stride LDS, 8 banks
// past a multiple of 32, so the MMA fragments' pair stores do not
// conflict) and p in T (row stride LDP, padded by 16 bytes)
template <typename T, int W> struct FwdCell {
  static constexpr int TB = Cell<T, W>::TB, TK = 2 * TB;
  static constexpr int LDS = TK + 8;
  static constexpr int LDP = TK + 16 / static_cast<int>(sizeof(T));
  static constexpr int KTILE = TK * Cell<T, W>::LD;
};

// the forward's shared-memory carve-up (the same in every CTA)
template <typename T, int W> struct FwdSmem {
  static constexpr size_t bytes() {
    using F = FwdCell<T, W>;
    return sizeof(T) * (Cell<T, W>::TILE + 3 * F::KTILE) +
           sizeof(float) * (2 * F::TB * F::LDS + 5 * F::TB) +
           sizeof(T) * 2 * F::TB * F::LDP;
  }
  T* q;           // q[:, Dc] of the query tile, resident
  T* kv;          // a slot of k[:, Dc], then two of v[:, Fc]
  float* ps;      // two buffers of this CTA's partial scores of the cell
  float* alpha;   // two buffers of the cell's rescale factors [TB]
  float *m, *l;   // running max and sum of the rows this CTA owns [TB]
  float* fin;     // the final l of every row, read from its owner [TB]
  T* pb;          // two buffers of the cell's p
  __device__ explicit FwdSmem(unsigned char* smem) {
    using F = FwdCell<T, W>;
    q = reinterpret_cast<T*>(smem);
    kv = q + Cell<T, W>::TILE;
    ps = reinterpret_cast<float*>(kv + 3 * F::KTILE);
    alpha = ps + 2 * F::TB * F::LDS;
    m = alpha + 2 * F::TB;
    l = m + F::TB;
    fin = l + F::TB;
    pb = reinterpret_cast<T*>(fin + F::TB);
  }
  // partial scores, p and alpha of the cells of parity `buf`
  __device__ float* scores(int buf) const {
    return ps + (buf & 1) * FwdCell<T, W>::TB * FwdCell<T, W>::LDS;
  }
  __device__ T* cell(int buf) const {
    return pb + (buf & 1) * FwdCell<T, W>::TB * FwdCell<T, W>::LDP;
  }
  __device__ float* alphas(int buf) const {
    return alpha + (buf & 1) * FwdCell<T, W>::TB;
  }
  // the k tile, and the v tile of key tile t
  __device__ T* kslot() const { return kv; }
  __device__ T* vslot(int t) const {
    return kv + (1 + (t & 1)) * FwdCell<T, W>::KTILE;
  }
};

// N adjacent fp32 values at `at` (16-byte rows, N-aligned)
template <int N>
__device__ __forceinline__ void load_n(float (&v)[N], const float* at) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(at);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(at);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *at;
  }
}
// N adjacent values rounded to T, stored at `at` in one access
template <typename T, int N>
__device__ __forceinline__ void store_n(T* at, const float (&v)[N]) {
  if constexpr (N == 1) {
    *at = from_f<T>(v[0]);
  } else if constexpr (N == 2) {
    store_pair(at, v[0], v[1]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(at) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(at) = u;
  }
}

// Multiply (kDivide: divide) row r of the [TB, W] accumulator by x[r]; in
// the mma.sync layout a thread's rows are r and r + 8.
template <typename T, int W, bool kDivide>
__device__ __forceinline__ void scale_rows(float (&acc)[Cell<T, W>::ACC],
                                           const float* x) {
  using K = Cell<T, W>;
  const int tid = threadIdx.x;
  if constexpr (K::kTC) {
    constexpr int WM = K::TB / 16;
    const int r = ((tid >> 5) % WM) * 16 + ((tid & 31) >> 2);
    const float a = x[r], b = x[r + 8];
#pragma unroll
    for (int j = 0; j < K::ACC; j += 4) {
      acc[j] = kDivide ? acc[j] / a : acc[j] * a;
      acc[j + 1] = kDivide ? acc[j + 1] / a : acc[j + 1] * a;
      acc[j + 2] = kDivide ? acc[j + 2] / b : acc[j + 2] * b;
      acc[j + 3] = kDivide ? acc[j + 3] / b : acc[j + 3] * b;
    }
  } else {
    constexpr int RS = kThreads / W;
    const int r0 = tid / W;
#pragma unroll
    for (int i = 0; i < K::ACC; ++i) {
      const float s = x[r0 + RS * i];
      acc[i] = kDivide ? acc[i] / s : acc[i] * s;
    }
  }
}

// The rows of a forward cell that CTA `rank` owns, one warp per row and
// CPL adjacent keys per lane: sum the partial scores of the nD slices of D
// in their order through distributed shared memory (key half h from ranks
// h nD + [0, nD) where `halves` is 2, else all keys from ranks [0, nD)),
// scale, clip and mask them (n0: the cell's first key), update the row's
// running max m and sum l in this CTA's shared memory, and store p =
// exp(s - m_new) in T and alpha = exp(m_old - m_new) into the buffers
// `buf` of every CTA of the cluster.
template <typename T, int W>
__device__ void publish_softmax(const FwdParams& p, const FwdSmem<T, W>& sm,
                                int buf, int n0, int rank, int C, int nD,
                                int halves) {
  using F = FwdCell<T, W>;
  constexpr int TB = F::TB, CPL = F::TK / 32;
  static_assert(F::TK % 32 == 0 && TB % CPL == 0, "whole lanes");
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, c = (threadIdx.x & 31) * CPL;
  const int from = halves == 2 ? c / TB * nD : 0;  // the first rank of c
  const int rpc = (TB + C - 1) / C, r1 = min(TB, (rank + 1) * rpc);
  for (int r = rank * rpc + warp; r < r1; r += kWarps) {
    float x[kMaxCluster][CPL];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)  // all loads first, then sums
      if (i < nD)
        load_n(x[i], cluster.map_shared_rank(sm.scores(buf) + r * F::LDS + c,
                                             from + i));
    const float m_old = sm.m[r];
    float s[CPL], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxCluster; ++i)
        if (i < nD) dot += x[i][j];
      const float clipped = fminf(fmaxf(dot * p.scale, -p.clip), p.clip);
      s[j] = n0 + c + j < p.N ? clipped : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_old, warp_max(mx));
    float pv[CPL], sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      pv[j] = expf(s[j] - m_new);
      sum += pv[j];
    }
    sum = warp_sum(sum);
    const float alpha = expf(m_old - m_new);
    if ((threadIdx.x & 31) == 0) {
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_new;
    }
    T* at_p = sm.cell(buf) + r * F::LDP + c;
    float* at_a = sm.alphas(buf) + r;
    for (int i = 0; i < C; ++i) {
      store_n(cluster.map_shared_rank(at_p, i), pv);
      if ((threadIdx.x & 31) == 0) *cluster.map_shared_rank(at_a, i) = alpha;
    }
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(FwdParams p) {
  using K = Cell<T, W>;
  using F = FwdCell<T, W>;
  constexpr int TB = F::TB, TK = F::TK;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<T, W> sm(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int nD = (p.D + W - 1) / W, nF = (p.F + W - 1) / W;
  // Rank r computes the partial scores of D slice r % nD; where the
  // cluster has room for two ranks per slice, over key half r / nD of the
  // cell, else over all its keys. Rank r owns F slice r.
  const int halves = 2 * nD <= C ? 2 : 1, half = rank / nD;
  const bool has_d = rank < halves * nD, has_f = rank < nF;
  const int g = blockIdx.z, q0 = blockIdx.x / C * TB;
  const int dc0 = rank % nD * W, fc0 = rank * W;
  const int q_rows = min(TB, p.Q - q0);
  const long long row0 = static_cast<long long>(g) * p.Q + q0;
  const int nt = (p.N + TK - 1) / TK, per = (nt + p.splits - 1) / p.splits;
  const int t0 = blockIdx.y * per, m = min(nt, t0 + per) - t0;
  const T* kg = static_cast<const T*>(p.k) + (long long)g * p.N * p.D + dc0;
  const T* vg = static_cast<const T*>(p.v) + (long long)g * p.N * p.F + fc0;
  auto stage_k = [&](int i) {  // this rank's k of the split's key tile i
    const int n0 = (t0 + i) * TK + (halves == 2 ? half * TB : 0);
    const T* at = kg + (long long)min(n0, p.N - 1) * p.D;  // rows < N - n0
    if (!has_d) return;
    if (halves == 2)
      stage_tile<T, TB, W>(sm.kslot(), K::LD, at, p.D, p.N - n0, p.D - dc0);
    else
      stage_tile<T, TK, W>(sm.kslot(), K::LD, at, p.D, p.N - n0, p.D - dc0);
  };
  auto issue = [&](int i) {  // k of tile i + 1 and v[:, Fc] of tile i
    if (i + 1 < m) stage_k(i + 1);
    if (i < m && has_f) {
      const int n0 = (t0 + i) * TK;
      stage_tile<T, TK, W>(sm.vslot(i), K::LD, vg + (long long)n0 * p.F, p.F,
                           p.N - n0, p.F - fc0);
    }
    cp_async_commit();
  };
  if (has_d)
    stage_tile<T, TB, W>(sm.q, K::LD,
                         static_cast<const T*>(p.q) + row0 * p.D + dc0, p.D,
                         q_rows, p.D - dc0);
  stage_k(0);
  cp_async_commit();
  for (int r = threadIdx.x; r < TB; r += kThreads) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
  }
  float acc[K::ACC];
#pragma unroll
  for (int i = 0; i < K::ACC; ++i) acc[i] = 0.f;

  // Step i: the partial scores of key tile i; one cluster barrier, after
  // which they, and tile i - 1's p and alpha, are visible in the cluster,
  // and every CTA is done with tile i's k and tile i - 2's v and p; the
  // loads of k of tile i + 1 (into the one k slot) and v of tile i; tile
  // i's p and alpha, stored in every CTA; tile i - 1's p v, after the
  // rescale by its alpha. Partial scores, p and alpha alternate between
  // two buffers, so a step's stores never meet the reads of the one
  // before. The first barrier also orders every CTA's start before any
  // peer access.
  for (int i = 0; i <= m; ++i) {
    cp_async_wait<0>();  // k of tile i, v of tile i - 1
    __syncthreads();
    if (i < m && has_d) {
      if (halves == 2)
        slice_scores<T, W, F::LDS>(sm.q, sm.kslot(), sm.scores(i) + half * TB);
      else
        slice_scores<T, W, F::LDS, TK>(sm.q, sm.kslot(), sm.scores(i));
    }
    __syncthreads();  // done with the k slot
    cluster_arrive();
    issue(i);
    cluster_wait();
    if (i < m)
      publish_softmax<T, W>(p, sm, i, (t0 + i) * TK, rank, C, nD, halves);
    if (i > 0 && has_f) {
      scale_rows<T, W, false>(acc, sm.alphas(i - 1));
      accumulate<T, W, false, 0, TK, F::LDP>(sm.cell(i - 1), sm.vslot(i - 1),
                                             acc);
    }
  }

  const int rpc = (TB + C - 1) / C, r0 = rank * rpc, r1 = min(TB, r0 + rpc);
  if (p.splits == 1) {
    // out = acc / l, each row's l read from its owner; lse by the owners
    if (has_f)
      for (int r = threadIdx.x; r < TB; r += kThreads)
        sm.fin[r] = *cluster.map_shared_rank(sm.l + r, r / rpc);
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
      if (r < q_rows) p.lse[row0 + r] = sm.m[r] + logf(sm.l[r]);
    cluster_arrive();  // no CTA exits while a peer reads its l
    cluster_wait();
    if (has_f) {
      scale_rows<T, W, true>(acc, sm.fin);
      store_acc<T, W>(acc, static_cast<T*>(p.out) + row0 * p.F + fc0, p.F,
                      q_rows, p.F - fc0);
    }
  } else {
    // this split's fp32 acc and (m, l), for fwd_merge_kernel
    const long long rows = static_cast<long long>(gridDim.z) * p.Q;
    const long long at = blockIdx.y * rows + row0;
    if (has_f)
      store_acc<T, W>(acc, p.acc_part + at * p.F + fc0, p.F, q_rows,
                      p.F - fc0);
    for (int r = r0 + threadIdx.x; r < r1; r += kThreads)
      if (r < q_rows) {
        p.ml_part[at + r] = sm.m[r];
        p.ml_part[p.splits * rows + at + r] = sm.l[r];
      }
  }
}

// out = the key splits' fp32 partial outputs rescaled to their common max
// M and summed in split order, over L = sum_s l_s exp(m_s - M), rounded to
// T; lse = M + log L. Four columns per thread (F is a multiple of 4).
template <typename T>
__global__ void fwd_merge_kernel(const float* acc, const float* ml, T* out,
                                 float* lse, long long rows, int F,
                                 int splits) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= rows * F) return;
  const long long row = i / F;
  const float* m = ml + row;
  const float* l = ml + splits * rows + row;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, m[s * rows]);
  float L = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float e = expf(m[s * rows] - M);
    const float4 x = *reinterpret_cast<const float4*>(acc + s * rows * F + i);
    L += l[s * rows] * e;
    a.x += x.x * e;
    a.y += x.y * e;
    a.z += x.z * e;
    a.w += x.w * e;
  }
  out[i] = from_f<T>(a.x / L);
  out[i + 1] = from_f<T>(a.y / L);
  out[i + 2] = from_f<T>(a.z / L);
  out[i + 3] = from_f<T>(a.w / L);
  if (i % F == 0) lse[row] = M + logf(L);
}

// ------------------------------------------------------------ launches ----

// the cluster size of width W, or 0 where W is not one of the kernels'
int cluster_size(int D, int F, int W) {
  if (W != 128 && W != 256) return 0;
  const int C = max((D + W - 1) / W, (F + W - 1) / W);
  return C <= kMaxCluster ? C : 0;
}

template <typename T, int W>
cudaError_t launch_bwd_w(const BwdParams& p, int G, bool dkdv, int C,
                         cudaStream_t stream) {
  constexpr int TB = Cell<T, W>::TB;
  constexpr size_t smem = BwdSmem<T, W>::bytes();
  auto kern = dkdv ? dkdv_kernel<T, W> : dq_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const dim3 grid = dkdv ? dim3(C * ((p.N + TB - 1) / TB), G, 1)
                         : dim3(C * ((p.Q + TB - 1) / TB), p.splits, G);
  const cudaLaunchConfig_t cfg = cluster_config(grid, C, smem, &attr, stream);
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

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int G, bool dkdv, int W,
                       cudaStream_t stream) {
  const int C = cluster_size(p.D, p.F, W);
  if (C == 0 || p.splits < 1) return cudaErrorInvalidValue;
  return W == 128 ? launch_bwd_w<T, 128>(p, G, dkdv, C, stream)
                  : launch_bwd_w<T, 256>(p, G, dkdv, C, stream);
}

template <typename T, int W>
cudaError_t bwd_occupancy_w(bool dkdv, int C, int* smem, int* clusters) {
  return occupancy(dkdv ? dkdv_kernel<T, W> : dq_kernel<T, W>,
                   BwdSmem<T, W>::bytes(), C, smem, clusters);
}

template <typename T, int W>
cudaError_t launch_fwd_w(const FwdParams& p, int G, int C,
                         cudaStream_t stream) {
  constexpr int TB = Cell<T, W>::TB;
  constexpr size_t smem = FwdSmem<T, W>::bytes();
  auto kern = fwd_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C * ((p.Q + TB - 1) / TB), p.splits, G), C, smem, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const long long rows = static_cast<long long>(G) * p.Q;
  const unsigned blocks =
      static_cast<unsigned>((rows * p.F / 4 + kThreads - 1) / kThreads);
  fwd_merge_kernel<T><<<blocks, kThreads, 0, stream>>>(
      p.acc_part, p.ml_part, static_cast<T*>(p.out), p.lse, rows, p.F,
      p.splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const FwdParams& p, int G, int W,
                       cudaStream_t stream) {
  const int C = cluster_size(p.D, p.F, W);
  if (C == 0 || p.splits < 1) return cudaErrorInvalidValue;
  return W == 128 ? launch_fwd_w<T, 128>(p, G, C, stream)
                  : launch_fwd_w<T, 256>(p, G, C, stream);
}

template <typename T, int W>
cudaError_t fwd_occupancy_w(int C, int* smem, int* clusters) {
  return occupancy(fwd_kernel<T, W>, FwdSmem<T, W>::bytes(), C, smem,
                   clusters);
}

}  // namespace

extern "C" {

// q [G,Q,D], k [G,N,D], v [G,N,F] -> out [G,Q,F] (compute type), lse [G,Q]
// fp32. `width` (128 or 256) is the column slice of each CTA of a cluster,
// `splits` the key splits, each holding at least one key tile (the
// wrapper's plan). With more than one split, acc_part (splits*G*Q*F) and
// ml_part (2*splits*G*Q) are fp32 scratch; else they may be null.
int flash_fwd(int is_bf16, const void* q, const void* k, const void* v,
              void* out, float* lse, float* acc_part, float* ml_part, int G,
              int Q, int N, int D, int F, int width, int splits, double scale,
              double clip, void* stream) {
  FwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.acc_part = acc_part; p.ml_part = ml_part;
  p.Q = Q; p.N = N; p.D = D; p.F = F; p.splits = splits;
  p.scale = static_cast<float>(scale);
  p.clip = static_cast<float>(clip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_fwd<bf16>(p, G, width, st)
                                  : launch_fwd<float>(p, G, width, st));
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

// The shared-memory bytes of one CTA of the forward kernel at `width`, and
// how many of its clusters of `cluster` CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters).
int flash_fwd_occupancy(int is_bf16, int width, int cluster, int* smem_bytes,
                        int* max_clusters) {
  if ((width != 128 && width != 256) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  int* sm = smem_bytes;
  int* mc = max_clusters;
  cudaError_t e;
  if (is_bf16)
    e = width == 128 ? fwd_occupancy_w<bf16, 128>(cluster, sm, mc)
                     : fwd_occupancy_w<bf16, 256>(cluster, sm, mc);
  else
    e = width == 128 ? fwd_occupancy_w<float, 128>(cluster, sm, mc)
                     : fwd_occupancy_w<float, 256>(cluster, sm, mc);
  return static_cast<int>(e);
}

// The same for a backward kernel (`dkdv` != 0: dK/dV, else dQ).
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
