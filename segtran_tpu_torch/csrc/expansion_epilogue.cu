// Fused expansion epilogue for Hopper (sm_90a): per mode m,
//
//     mid_m = gelu(P_m @ VW1_m + b1)        (full tier; the private tier is
//                                            given mid_m)
//     z_m   = mid_m @ W2_m + b2_m           (private output linear)
//     l_m   = LayerNorm(z_m)                (fp32 stats, var clamped at 0)
//     s_m   = l_m @ ws + bs                 (feat2score)
//     out   = sum_m softmax_m(s) * l_m      (fp32, rounded to T once)
//
// One cluster kernel, mid_pool_kernel<T, kFromMid>, replaces the Pallas
// kernels of segtran_tpu/kernels/expansion_epilogue.py:
//   kFromMid = false (the full tier) <- fused_mid_output_pool (:333,
//       pallas_call :356, body :174) and fused_mid_output_pool_permode
//       (:226, pallas_call :251, body :204 and the pool of _ln_score_pool
//       :125): the same math, one launch per call for either; the per-mode
//       split existed for TPU VMEM, which an H100 does not have.
//   kFromMid = true (the private tier) <- fused_private_output_pool (:289,
//       pallas_call :311, body :154): from a given mid [B, M, N, F].
//
// Rounding follows the JAX kernels point for point: each product
// accumulates in fp32 and is rounded to the compute type T before its bias
// is added in T; gelu runs in fp32 (erff) and rounds once; the LayerNorm
// statistics are fp32, the normalize/scale/shift run in T; the score
// accumulates in fp32; the mode softmax and weighted sum run in fp32
// (online over modes) and the result is rounded to T.
//
// What bounds it on an H100 SXM, bf16: the work is 2 B M N F (A + F) FLOP
// of matrix products (A = 0 for the private tier). Full tier at B=8, M=4,
// N=1296, A=256: 3.04e11 at F=1792 (0.308 ms at 989 TFLOP/s), 8.6e10 at
// F=896 (0.087 ms), 2.6e10 at F=448 (0.027 ms), against 40-60 MB of
// compulsory traffic (12-18 us at 3.35 TB/s). Private tier at the BraTS
// volume, mid [1, 4, 8640, 1024]: 7.2e10 FLOP (0.073 ms) against 97 MB
// (mid, W2, out: 29 us). Bound by operations.
//
// The design. W2 [M, F, F] (25.7 MB at F=1792) cannot stay on chip as it
// did in TPU VMEM, so it streams from L2, and the bytes of W2 read from L2
// are what a design has to keep down. A thread-block cluster of C =
// ceil(F/W) <= 8 CTAs owns a row tile of TM rows of one image (a tile
// never straddles two images: VW1 and mid differ per image); CTA c owns
// columns [cW, (c+1)W) of F, with W = 256, and TM = 32 KB / (W sizeof(T))
// rows (64 in bf16, 32 in fp32). W = 128 (128-row tiles) measured slower
// at F=896 and 448 and cannot take F=1792 (C = 14).
// Per mode, inside the cluster:
//   (a) full tier only: CTA c computes its slice of mid = gelu(P_m[tile]
//       VW1_m[:, slice c] + b1) into its own shared memory ([TM, W] in T,
//       32 KB); P and VW1 stream through a cp.async ring. One cluster
//       barrier.
//   (b) z[:, slice c] = mid_m[tile] W2_m[:, slice c], depth chunks in
//       order, W2 streamed through the ring by cp.async, the fp32
//       accumulator in registers. Full tier: chunk t of mid lies in rank
//       t KC / W's shared memory and is pulled over distributed shared
//       memory into the ring (ldmatrix reads only local shared memory),
//       read two chunks ahead and stored one ahead. Private tier: chunk t
//       of mid_m[tile] is staged from device memory by cp.async beside W2's
//       (every CTA of the cluster reads the tile's rows; the peers' reads
//       meet in L2), through a ring of three slots in the shared memory
//       the mid slice leaves (two chunks in flight; the full tier has room
//       for two slots).
//   (c) z = rnd(rnd(acc) + b2) in registers; each CTA publishes its rows'
//       partial sum and sum of squares, and after a cluster barrier every
//       CTA sums all C partials of a row in rank order (the same sum in
//       every CTA) into mean_T and inv_T; l in registers; the partial
//       scores l.ws are summed the same way, + bs.
//   (d) the online mode pool in fp32, in shared memory (registers hold the
//       accumulator): each CTA keeps the running max and denominator of
//       every row (identical in every CTA), pool = pool alpha + e l. After
//       the last mode out[:, slice c] = rnd_T(pool / denom) is the
//       kernel's only store to device memory: mid (full tier), z, l and the
//       per-mode scores never leave the chip.
// Three cluster barriers per mode in the full tier, two in the private;
// the one mid buffer is safe because a peer's last read of it (b) precedes
// two of them, and each CTA's row partials are rewritten only after the
// barrier that follows the peers' last read of them. The next mode's first
// chunks load behind this mode's row phases. No atomics, and every sum has
// a fixed order, so the kernel is bit-for-bit repeatable.
//
// W2 bytes read from L2 per call at F=1792 (bf16, 6.4 MB per mode): the
// per-mode kernel this replaces gave each 32-row block all of W2_m, 328
// blocks per mode, 8.4 GB per call; here each 64-row cluster reads each
// W2_m column slice once, 168 clusters, 4.3 GB. At F=896: 2.1 -> 1.08 GB.
// That kernel also re-read its mid rows from L2 scratch in each of 14
// column passes, wrote z and each mode's l to device memory, and pooled
// the modes in PyTorch; none of that remains. The private tier's earlier
// kernel (32-row blocks, 16x16x16 fragment products, 128-column passes)
// did the same with z and an fp32 pool in [B, N, F] scratch; at the BraTS
// volume W2 from L2 falls from 270 x 4 x 2 MB = 2.3 GB to 135 x 4 x 2 MB =
// 1.1 GB per call, and mid is read once per CTA in place of once per
// 128-column pass.
//
// What holds the full tier back (tools/ablate_epilogue.py, H100 SXM at 700
// W, bf16, F=1792: 2.88 ms, ~9x the bound; mma.sync alone peaks near
// 600-630 TFLOP/s on the card (tools/mma_sync_rate.py), a 0.61 ms floor at
// the 105 SMs that 15 clusters of 7 occupy): no part dominates. The
// products, the W2 stream, the per-mode row phases (gelu, LayerNorm,
// score, pool and their three cluster barriers) and the block barrier of
// each depth chunk each take about a fifth, the peers' mid reads 5%: the 8
// warps run loads, products and row phases one after another in lockstep,
// one CTA per SM (255 registers, ~194 KB of shared memory). The private
// tier at the BraTS volume (0.63 ms, 8.7x the bound; 202 KB) is held back
// by its chunk loads: without the W2 loads 34% of its time goes, without
// the mid loads 10%, without the products 22%, without the chunk barrier
// 16%; the row phases alone take 31%. A third ring slot took 10-12% off
// at N = 8640 and 18000; a fourth, or 32-deep chunks, nothing more. Next,
// for both tiers: warp specialisation, a producer warp feeding W2 and the
// mid chunks by TMA bulk copies into an mbarrier ring, so the tensor work
// overlaps the rest.
//
// mma.sync (m16n8k16, ldmatrix operands, fp32 accumulators), as in the
// flash kernels, rather than wgmma: the row ownership of the cluster
// reductions and the online pool want a thread's accumulator rows known
// (r and r + 8 of each 16-row tile), and the full tier's A operand of (b)
// arrives from peers' shared memory, copied by the threads, in no wgmma
// shared-memory layout. Warps tile the [TM, W] slice by 32 x 64. fp32 runs
// the same decomposition on the CUDA cores in full fp32 (no TF32), so the
// fp32 build checks the indexing, the rank-ordered reductions and the
// online pool exactly. Ragged N, A and F are masked in the kernel
// (zero-filled loads and zero parameters past F); A and F must be
// multiples of 16 bytes' worth of elements and the staged operands 16-byte
// aligned (the wrapper pads A with zeros and checks the rest).
//
// The cp.async, ldmatrix, mma.sync and cluster helpers are those of the
// flash kernels (cluster_mma.cuh).

#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "cluster_mma.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
// round an fp32 value to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

constexpr int kW = 256;    // columns of a CTA's slice of F

struct MidParams {
  const void* p;    // probs [B, M, N, A]; the private tier: mid [B, M, N, F]
  const void* vw1;  // V W1 [B, M, A, F] (full tier)
  const void* b1;   // [F] (full tier)
  const void* w2;   // [M, F, F] (in, out)
  const void* b2;   // [M, F]
  const void* scale;
  const void* lnb;
  const void* ws;   // [F] each
  const float* bs;  // [1]
  void* out;        // [B, N, F]
  int M, N, A, F;
  float eps;
};

// The geometry of mid_pool_kernel<T, *>: a CTA's slice of W = kW columns for
// TM rows (the mid slice, [TM, W] in T, is 32 KB in either type), depth
// chunks of KC, row strides padded by 16 bytes (the 8 rows of an ldmatrix
// fall into different banks). bf16: 8 warps of 32 x 64, WM x WN, each
// thread holding ACC = 64 accumulator floats in the mma.sync layout; fp32:
// thread t owns column t % W of the rows t / W + RS i.
template <typename T> struct MidGeom {
  static constexpr bool kTC = std::is_same<T, bf16>::value;
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / ES;
  static constexpr int TM = 32768 / (kW * ES);
  static constexpr int KC = kTC ? 64 : 32;
  static constexpr int LDM = kW + VEC, LDA = KC + VEC, LDB = kW + VEC;
  static constexpr int LDP = kW + 4;  // fp32 pool rows
  static constexpr int ACC = TM * kW / kThreads;
  static constexpr int WM = TM / 32, WN = kW / 64;  // bf16 warp grid
  static constexpr int RS = kThreads / kW;           // fp32 row step
  static constexpr int NG = kTC ? WN : kW / 32;      // threads' groups per row
  static constexpr int PAIR = kTC ? 2 : 1;           // adjacent columns held
  static constexpr int PULL = TM * KC / VEC / kThreads;  // mid vectors
  static_assert(!kTC || WM * WN == kWarps, "bf16 warp grid");
  static_assert(PULL >= 1 && kW % KC == 0, "chunks");
};

// Row and column, in the CTA's [TM, W] slice, of accumulator float e
template <typename T>
__device__ __forceinline__ int acc_row(int e) {
  using G = MidGeom<T>;
  if constexpr (G::kTC) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % G::WM) * 32 + (e >> 5) * 16 + ((e >> 1) & 1) * 8 +
           (lane >> 2);
  } else {
    return threadIdx.x / kW + G::RS * e;
  }
}
template <typename T>
__device__ __forceinline__ int acc_col(int e) {
  using G = MidGeom<T>;
  if constexpr (G::kTC) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / G::WM) * 64 + ((e >> 2) & 7) * 8 + (lane & 3) * 2 + (e & 1);
  } else {
    return threadIdx.x % kW;
  }
}

// the shared-memory carve-up (the same in every CTA, so a peer's buffer is
// this CTA's address mapped to its rank). Only the full tier keeps a mid
// slice; the room it leaves the private tier holds a third ring slot (two
// chunks in flight: 10-12% faster at the BraTS volume, H100 SXM).
template <typename T, bool kFromMid> struct MidSmem {
  using G = MidGeom<T>;
  static constexpr int kRing = kFromMid ? 3 : 2;  // slots of the ring
  static constexpr int MID = kFromMid ? 0 : G::TM * G::LDM;
  static constexpr int SLOT = G::TM * G::LDA + G::KC * G::LDB;
  static constexpr size_t bytes() {
    return sizeof(T) * (MID + kRing * SLOT) +
           sizeof(float) * (G::TM * G::LDP + 25 * G::TM + 5 * kW);
  }
  T* mid;       // this CTA's mid slice [TM][LDM], read by every peer
  T* ring;      // kRing slots: an A chunk [TM][LDA], then a B chunk [KC][LDB]
  float* red;   // [2][NG][TM] the thread groups' row partials
  float* part;  // [3][TM] this CTA's row partials (sum z, sum z^2, score),
                // read by every peer
  float* row;   // [6][TM] per row: mean_T, inv_T, max, denominator, alpha, e
  float* col;   // [5][W] per column of the slice: b1 (full tier), scale,
                // lnb, ws, b2_m; zero past F
  float* pool;  // [TM][LDP] the fp32 mode pool, each element only ever
                // touched by the thread that holds it in the accumulator
  __device__ explicit MidSmem(unsigned char* smem) {
    mid = reinterpret_cast<T*>(smem);
    ring = mid + MID;
    pool = reinterpret_cast<float*>(ring + kRing * SLOT);
    red = pool + G::TM * G::LDP;
    part = red + 16 * G::TM;
    row = part + 3 * G::TM;
    col = row + 6 * G::TM;
  }
  __device__ T* a(int t) const { return ring + (t % kRing) * SLOT; }
  __device__ T* b(int t) const { return a(t) + G::TM * G::LDA; }
};

// acc[TM, W] += A [TM][KC] . B [KC][W], one depth chunk from the ring
template <typename T>
__device__ __forceinline__ void mma_chunk(float (&acc)[MidGeom<T>::ACC],
                                          const T* sa, const T* sb) {
  using G = MidGeom<T>;
  if constexpr (G::kTC) {
    const int warp = threadIdx.x >> 5;
    const int m0 = (warp % G::WM) * 32, n0 = (warp / G::WM) * 64;
#pragma unroll
    for (int k0 = 0; k0 < G::KC; k0 += 16) {
      unsigned a[2][4];
      load_a<false>(a[0], sa, G::LDA, m0, k0);
      load_a<false>(a[1], sa, G::LDA, m0 + 16, k0);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned b[4];
        load_b_kn(b, sb, G::LDB, k0, n0 + j * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc + mt * 32 + j * 4, a[mt], b[0], b[1]);
          mma16816(acc + mt * 32 + j * 4 + 4, a[mt], b[2], b[3]);
        }
      }
    }
  } else {
    const int c = threadIdx.x % kW, r0 = threadIdx.x / kW;
#pragma unroll 2
    for (int k = 0; k < G::KC; k += 4) {
      const float b0 = sb[k * G::LDB + c], b1 = sb[(k + 1) * G::LDB + c];
      const float b2 = sb[(k + 2) * G::LDB + c], b3 = sb[(k + 3) * G::LDB + c];
#pragma unroll
      for (int i = 0; i < G::ACC; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            sa + (r0 + G::RS * i) * G::LDA + k);
        acc[i] = fmaf(x.x, b0, acc[i]);
        acc[i] = fmaf(x.y, b1, acc[i]);
        acc[i] = fmaf(x.z, b2, acc[i]);
        acc[i] = fmaf(x.w, b3, acc[i]);
      }
    }
  }
}

// The [TM][KC] chunk of depth chunk t of the output product: columns
// [kc0, kc0 + KC) of the mid slice of rank t KC / W, read from that rank's
// shared memory into registers (pull) and stored into the ring (put)
template <typename T>
__device__ __forceinline__ void pull_mid(uint4 (&v)[MidGeom<T>::PULL],
                                         const MidSmem<T, false>& sm, int t) {
  using G = MidGeom<T>;
  constexpr int PER_ROW = G::KC / G::VEC;
  cg::cluster_group cluster = cg::this_cluster();
  const int j = t * G::KC / kW, kc0 = t * G::KC - j * kW;
#pragma unroll
  for (int i = 0; i < G::PULL; ++i) {
    const int x = threadIdx.x + i * kThreads;
    const int r = x / PER_ROW, c = (x % PER_ROW) * G::VEC;
    v[i] = *reinterpret_cast<const uint4*>(
        cluster.map_shared_rank(sm.mid + r * G::LDM + kc0 + c, j));
  }
}
template <typename T>
__device__ __forceinline__ void put_mid(const uint4 (&v)[MidGeom<T>::PULL],
                                        T* sa) {
  using G = MidGeom<T>;
  constexpr int PER_ROW = G::KC / G::VEC;
#pragma unroll
  for (int i = 0; i < G::PULL; ++i) {
    const int x = threadIdx.x + i * kThreads;
    const int r = x / PER_ROW, c = (x % PER_ROW) * G::VEC;
    *reinterpret_cast<uint4*>(sa + r * G::LDA + c) = v[i];
  }
}

// acc += the product of nk depth chunks streamed through the ring. The
// caller has issued (cp.async, one commit each) the first kRing - 1
// chunks; issue(t) issues chunk t (an empty commit past the end). kPull:
// the A chunks are the peers' mid slices (the full tier's output product),
// copied by the threads: chunk t + 2 is read from the peer at step t and
// stored into the ring at step t + 1, so a whole step hides the peer's
// latency. Ends with every copy landed and a block barrier.
template <typename T, bool kPull, bool kFromMid, typename Issue>
__device__ __forceinline__ void run_chunks(float (&acc)[MidGeom<T>::ACC],
                                           const MidSmem<T, kFromMid>& sm,
                                           int nk, Issue issue) {
  constexpr int kRing = MidSmem<T, kFromMid>::kRing;
  static_assert(kRing >= 2, "a pulled chunk waits a step in registers");
  uint4 v[MidGeom<T>::PULL];
  if constexpr (kPull) {
    pull_mid<T>(v, sm, 0);
    put_mid<T>(v, sm.a(0));
    if (nk > 1) pull_mid<T>(v, sm, 1);
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kRing - 2>();  // chunk t landed (this thread's copies)
    __syncthreads();             // everyone's; slot t - 1 is free again
    issue(t + kRing - 1);
    if constexpr (kPull) {
      if (t + 1 < nk) put_mid<T>(v, sm.a(t + 1));
      if (t + 2 < nk) pull_mid<T>(v, sm, t + 2);
    }
    mma_chunk<T>(acc, sm.a(t), sm.b(t));
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Per row of the slice, the sum over its columns of f(e) (NQ quantities:
// f returns a float2, .y unused where NQ is 1): each thread sums its
// elements of the row, the row's threads of a warp combine by shuffles,
// and thread r < TM adds the NG groups in order into part[q TM + r].
// Starts after, and ends with, block barriers.
template <typename T, int NQ, bool kFromMid, typename Fn>
__device__ __forceinline__ void slice_row_sums(const MidSmem<T, kFromMid>& sm,
                                               float* part, Fn f) {
  using G = MidGeom<T>;
  constexpr int TM = G::TM;
  const int lane = threadIdx.x & 31;
  if constexpr (G::kTC) {
    const int g = (threadIdx.x >> 5) / G::WM;
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {  // rows of (16-row tile, half)
      const int e0 = (slot >> 1) * 32 + (slot & 1) * 2;
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float2 v = f(e0 + nt * 4 + x);
          s.x += v.x;
          s.y += v.y;
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
        if (NQ == 2) s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      }
      if ((lane & 3) == 0) {
        const int r = acc_row<T>(e0);
        sm.red[g * TM + r] = s.x;
        if (NQ == 2) sm.red[(G::NG + g) * TM + r] = s.y;
      }
    }
  } else {
    const int g = (threadIdx.x % kW) / 32;
#pragma unroll
    for (int e = 0; e < G::ACC; ++e) {
      const float2 v = f(e);
      const float sx = warp_sum(v.x);
      const float sy = NQ == 2 ? warp_sum(v.y) : 0.f;
      if (lane == 0) {
        const int r = acc_row<T>(e);
        sm.red[g * TM + r] = sx;
        if (NQ == 2) sm.red[(G::NG + g) * TM + r] = sy;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < TM) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float s = 0.f;
      for (int g = 0; g < G::NG; ++g) s += sm.red[(q * G::NG + g) * TM + threadIdx.x];
      part[q * TM + threadIdx.x] = s;
    }
  }
}

// s[q] = the sum over the cluster's C ranks, in rank order, of the peers'
// part[at + q stride]; every load is issued before the sums
template <int NQ>
__device__ __forceinline__ void rank_sums(float (&s)[NQ], const float* part,
                                          int at, int stride, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  float x[NQ][kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (j < C)
        x[q][j] = *cluster.map_shared_rank(
            const_cast<float*>(part) + at + q * stride, j);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    s[q] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < C) s[q] += x[q][j];
  }
}

// One cluster per (image, row tile of TM rows); CTA `rank` owns columns
// [rank W, rank W + W) of F (the note at the top of this file). kFromMid:
// the private tier, mid given in device memory in place of P and VW1.
template <typename T, bool kFromMid>
__global__ void __launch_bounds__(kThreads, 1) mid_pool_kernel(MidParams q) {
  using G = MidGeom<T>;
  constexpr int TM = G::TM, KC = G::KC, ACC = G::ACC;
  extern __shared__ __align__(128) unsigned char smem[];
  const MidSmem<T, kFromMid> sm(smem);
  constexpr int kRing = MidSmem<T, kFromMid>::kRing;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, F = q.F, A = q.A;
  const int b = blockIdx.y, n0 = blockIdx.x / C * TM;
  const int rows = min(TM, q.N - n0);
  const int c0 = rank * kW, wc = min(kW, F - c0);  // the slice, wc columns
  const T* P = static_cast<const T*>(q.p);
  const T* VW1 = static_cast<const T*>(q.vw1);
  const T* W2 = static_cast<const T*>(q.w2);
  const T* B2 = static_cast<const T*>(q.b2);
  for (int c = tid; c < kW; c += kThreads) {
    const bool in = c < wc;
    if constexpr (!kFromMid)
      sm.col[c] = in ? to_f(static_cast<const T*>(q.b1)[c0 + c]) : 0.f;
    sm.col[kW + c] = in ? to_f(static_cast<const T*>(q.scale)[c0 + c]) : 0.f;
    sm.col[2 * kW + c] = in ? to_f(static_cast<const T*>(q.lnb)[c0 + c]) : 0.f;
    sm.col[3 * kW + c] = in ? to_f(static_cast<const T*>(q.ws)[c0 + c]) : 0.f;
  }
  const float* b1s = sm.col;
  const float* scs = sm.col + kW;
  const float* lbs = sm.col + 2 * kW;
  const float* wss = sm.col + 3 * kW;
  const float* b2s = sm.col + 4 * kW;
  float* mean_t = sm.row;
  float* inv_t = sm.row + TM;
  float* run_max = sm.row + 2 * TM;
  float* denom = sm.row + 3 * TM;
  float* alpha = sm.row + 4 * TM;
  float* weight = sm.row + 5 * TM;
  const int nka = kFromMid ? 0 : (A + KC - 1) / KC, nkb = (F + KC - 1) / KC;
  // chunk t of W2_m[:, slice]
  auto stage_w2 = [&](int m, int t) {
    const T* w2 = W2 + (long long)m * F * F + c0;
    stage_tile<T, KC, kW>(sm.b(t), G::LDB, w2 + (long long)t * KC * F, F,
                          F - t * KC, wc);
  };
  // chunk t of mode m's first product: P_m[tile] and VW1_m[:, slice] (full
  // tier), or mid_m[tile] and W2_m[:, slice] (private tier)
  auto issue_a = [&](int m, int t) {
    if constexpr (kFromMid) {
      if (t < nkb) {
        const T* mg = P + (((long long)b * q.M + m) * q.N + n0) * F;
        stage_tile<T, TM, KC>(sm.a(t), G::LDA, mg + t * KC, F, rows,
                              F - t * KC);
        stage_w2(m, t);
      }
    } else if (t < nka) {
      const T* pg = P + (((long long)b * q.M + m) * q.N + n0) * A;
      const T* vg = VW1 + ((long long)b * q.M + m) * A * F + c0;
      stage_tile<T, TM, KC>(sm.a(t), G::LDA, pg + t * KC, A, rows, A - t * KC);
      stage_tile<T, KC, kW>(sm.b(t), G::LDB, vg + (long long)t * KC * F,
                            F, A - t * KC, wc);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) issue_a(0, t);

  for (int m = 0; m < q.M; ++m) {
    if (tid < kW)  // read after the barriers of (a) or (b)
      sm.col[4 * kW + tid] = tid < wc ? to_f(B2[(long long)m * F + c0 + tid])
                                     : 0.f;
    float acc[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
    if constexpr (kFromMid) {
      // (b) z[:, slice] = mid_m[tile] W2_m[:, slice], both operands from
      // device memory; the first chunks were issued before
      run_chunks<T, false>(acc, sm, nkb, [&](int t) { issue_a(m, t); });
    } else {
      // (a) this CTA's mid slice: gelu(rnd(P_m VW1_m[:, slice]) + b1); its
      // first chunks were issued before
      run_chunks<T, false>(acc, sm, nka, [&](int t) { issue_a(m, t); });
#pragma unroll
      for (int e = 0; e < ACC; e += G::PAIR) {
        float g[G::PAIR];
#pragma unroll
        for (int x = 0; x < G::PAIR; ++x) {
          const float v = rnd<T>(rnd<T>(acc[e + x]) + b1s[acc_col<T>(e + x)]);
          g[x] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
        }
        T* at = sm.mid + acc_row<T>(e) * G::LDM + acc_col<T>(e);
        if constexpr (G::PAIR == 2)
          store_pair(at, g[0], g[1]);
        else
          *at = from_f<T>(g[0]);
      }
      cluster_arrive();  // the slice is visible to every peer after the wait
      // (b) z[:, slice] = sum_j mid_j W2_m[slice j, slice], chunks in order;
      // the first W2 chunks load while the peers finish their slices
      auto issue_b = [&](int t) {
        if (t < nkb) stage_w2(m, t);
        cp_async_commit();
      };
#pragma unroll
      for (int t = 0; t < kRing - 1; ++t) issue_b(t);
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
      cluster_wait();
      run_chunks<T, true>(acc, sm, nkb, issue_b);
    }
    // the next mode's first chunks load behind this mode's row phases
    if (m + 1 < q.M)
#pragma unroll
      for (int t = 0; t < kRing - 1; ++t) issue_a(m + 1, t);
    // (c) z in T (zero past F); its rows' partial sums and squares
#pragma unroll
    for (int e = 0; e < ACC; ++e)
      acc[e] = rnd<T>(rnd<T>(acc[e]) + b2s[acc_col<T>(e)]);
    slice_row_sums<T, 2>(sm, sm.part, [&](int e) {
      return make_float2(acc[e], acc[e] * acc[e]);
    });
    cluster_arrive();
    cluster_wait();
    if (tid < TM) {
      float s[2];
      rank_sums(s, sm.part, tid, TM, C);
      const float mean = s[0] / F;
      const float var = fmaxf(0.f, s[1] / F - mean * mean);
      mean_t[tid] = rnd<T>(mean);
      inv_t[tid] = rnd<T>(1.f / sqrtf(var + q.eps));
    }
    __syncthreads();
    // l in T, in place, and its rows' partial scores
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int r = acc_row<T>(e), c = acc_col<T>(e);
      float t = rnd<T>(acc[e] - mean_t[r]);
      t = rnd<T>(t * inv_t[r]);
      t = rnd<T>(t * scs[c]);
      acc[e] = rnd<T>(t + lbs[c]);
    }
    slice_row_sums<T, 1>(sm, sm.part + 2 * TM, [&](int e) {
      return make_float2(acc[e] * wss[acc_col<T>(e)], 0.f);
    });
    cluster_arrive();
    cluster_wait();
    // (d) the online mode pool: every CTA updates every row's running max
    // and denominator alike
    if (tid < TM) {
      float sc[1];
      rank_sums(sc, sm.part, 2 * TM + tid, TM, C);
      const float s = sc[0] + *q.bs;
      if (m == 0) {
        run_max[tid] = s;
        denom[tid] = 1.f;
      } else {
        const float nm = fmaxf(run_max[tid], s);
        alpha[tid] = expf(run_max[tid] - nm);
        weight[tid] = expf(s - nm);
        denom[tid] = denom[tid] * alpha[tid] + weight[tid];
        run_max[tid] = nm;
      }
    }
    if (m == q.M - 1) cluster_arrive();  // done with the peers' partials
    __syncthreads();
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      const int r = acc_row<T>(e);
      float* at = sm.pool + r * G::LDP + acc_col<T>(e);
      *at = m == 0 ? acc[e] : *at * alpha[r] + weight[r] * acc[e];
    }
  }
  // out[:, slice] = rnd_T(pool / denom); then wait until no peer reads
  // this CTA's partials any more
  T* og = static_cast<T*>(q.out) + ((long long)b * q.N + n0) * F + c0;
#pragma unroll
  for (int e = 0; e < ACC; e += G::PAIR) {
    const int r = acc_row<T>(e), c = acc_col<T>(e);
    if (r >= rows || c >= wc) continue;  // wc is even: pairs never straddle
    T* at = og + (long long)r * F + c;
    const float* p = sm.pool + r * G::LDP + c;
    if constexpr (G::PAIR == 2)
      store_pair(at, p[0] / denom[r], p[1] / denom[r]);
    else
      *at = from_f<T>(p[0] / denom[r]);
  }
  cluster_wait();
}

template <typename T, bool kFromMid>
cudaError_t launch_mid_pool(const MidParams& q, int B, int tm,
                            cudaStream_t stream) {
  using G = MidGeom<T>;
  const int C = (q.F + kW - 1) / kW;
  if (tm != G::TM || C > kMaxCluster || q.A % G::VEC || q.F % G::VEC)
    return cudaErrorInvalidValue;
  constexpr size_t smem = MidSmem<T, kFromMid>::bytes();
  auto kern = mid_pool_kernel<T, kFromMid>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(C * ((q.N + G::TM - 1) / G::TM), B, 1), C, smem, &attr, stream);
  e = cudaLaunchKernelEx(&cfg, kern, q);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool kFromMid>
cudaError_t mid_pool_occupancy(int C, int* smem, int* clusters) {
  return occupancy(mid_pool_kernel<T, kFromMid>,
                   MidSmem<T, kFromMid>::bytes(), C, smem, clusters);
}

}  // namespace

extern "C" {

// fused_mid_output_pool and fused_mid_output_pool_permode: probs
// [B,M,N,A], vw1 [B,M,A,F] -> out [B,N,F] (compute type). `tm` is the rows
// of a row tile in the wrapper's plan, which must be the kernel's.
int epi_mid_pool(int is_bf16, const void* p, const void* vw1, const void* b1,
                 const void* w2, const void* b2, const void* scale,
                 const void* lnb, const void* ws, const void* bs, void* out,
                 int B, int M, int N, int A, int F, int tm, double eps,
                 void* stream) {
  MidParams q = {};
  q.p = p; q.vw1 = vw1; q.b1 = b1; q.w2 = w2; q.b2 = b2; q.scale = scale;
  q.lnb = lnb; q.ws = ws; q.bs = static_cast<const float*>(bs); q.out = out;
  q.M = M; q.N = N; q.A = A; q.F = F;
  q.eps = static_cast<float>(eps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_mid_pool<bf16, false>(q, B, tm, st)
              : launch_mid_pool<float, false>(q, B, tm, st));
}

// fused_private_output_pool: mid [B,M,N,F] -> out [B,N,F] (compute type),
// the same kernel without step (a); `tm` as above.
int epi_private_pool(int is_bf16, const void* mid, const void* w2,
                     const void* b2, const void* scale, const void* lnb,
                     const void* ws, const void* bs, void* out, int B, int M,
                     int N, int F, int tm, double eps, void* stream) {
  MidParams q = {};
  q.p = mid; q.w2 = w2; q.b2 = b2; q.scale = scale; q.lnb = lnb; q.ws = ws;
  q.bs = static_cast<const float*>(bs); q.out = out;
  q.M = M; q.N = N; q.A = 0; q.F = F;
  q.eps = static_cast<float>(eps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_mid_pool<bf16, true>(q, B, tm, st)
              : launch_mid_pool<float, true>(q, B, tm, st));
}

// The shared-memory bytes of one CTA of mid_pool_kernel (the private tier's
// where from_mid is set), and how many of its clusters of `cluster` CTAs
// the card holds at once (cudaOccupancyMaxActiveClusters).
int epi_mid_pool_occupancy(int is_bf16, int from_mid, int cluster,
                           int* smem_bytes, int* max_clusters) {
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (is_bf16)
    e = from_mid ? mid_pool_occupancy<bf16, true>(cluster, smem_bytes,
                                                  max_clusters)
                 : mid_pool_occupancy<bf16, false>(cluster, smem_bytes,
                                                   max_clusters);
  else
    e = from_mid ? mid_pool_occupancy<float, true>(cluster, smem_bytes,
                                                   max_clusters)
                 : mid_pool_occupancy<float, false>(cluster, smem_bytes,
                                                    max_clusters);
  return static_cast<int>(e);
}

}  // extern "C"
