// The front half of an EfficientNet MBConv block in eval, for Hopper
// (sm_90a):
//
//     e   = T(swish(bn0(x @ w_exp)))          fp32 sums, zero outside the
//                                             input (the TF-SAME halo)
//     y   = swish(bn1(depthwise_kxk(e)))      fp32 sums over the k*k taps
//     out = T(y),   se[b, c] = mean of y over the output positions
//
// with x [B, H, W, Cin] (any strides, channels contiguous) in the compute
// type T (bf16 or fp32), w_exp [Cin, Cexp] in T, the folded BatchNorm
// affines and the depthwise weights [k, k, Cexp] in fp32. Without an expand
// (expand_ratio 1) e is x itself, zero in the halo. Replaces the Pallas
// kernel of segtran_tpu/kernels/mbconv.py (mbconv_front /
// _mbconv_front_kernel).
//
// What bounds it on an H100 SXM: at the eff-b4 288^2 shapes at batch 8 the
// function reads x once and writes its 6x wider output once, 20-74 MB (5-22
// us at 3.35 TB/s), against 2-3 GFLOP of expand (3-5 us on the tensor cores
// at mma.sync's ~600 TFLOP/s): bound by bytes. The unfused chain also
// writes the expanded tensor and reads it back, and reads the output again
// for the SE mean; here the expanded tensor never leaves the SM.
//
// The design. A block owns (batch item, a segment of `rows` consecutive
// output rows, a chunk of CC expanded channels: 128 bytes per position, 64
// channels in bf16, 32 in fp32). It walks down its segment one padded input
// row at a time, the GPU form of the TPU kernel's sequential band walk:
//
// 1. staging: x's row [W x Cin] goes to shared memory by cp.async 16-byte
//    copies, one row ahead of its expand (two of the emit); in bf16 Cin is
//    zero-padded to a multiple of 16 (the mma depth), and positions to a
//    multiple of 16 (the mma rows);
// 2. the expand of that row into a ring of k + 1 expanded rows [wr x CC]:
//    bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulators, the
//    block's w_exp chunk [Cin x CC] in shared memory for the whole
//    segment), fp32 on the CUDA cores (register tiles of 4 positions x 4
//    channels; fp32 must stay exact, so no TF32); BN0 and swish on the
//    accumulators, rounded to T into the ring slot. A row outside the input
//    is zero (the halo is zero AFTER swish, because the unfused chain pads
//    the expanded tensor and swish(bn0(0)) is not zero), as are the ring's
//    halo columns. Without an expand the copies fill the ring directly;
// 3. once k rows are in the ring (stride 2: every second row after that)
//    one output row, while the next row is expanded into the extra slot
//    (one barrier per step; warps idle in one part run the other). Each
//    thread owns 4 channels at k 3 and 2 at k 5, whose k x k weights and
//    BN1 it holds in registers for the whole segment, and runs of up to 6
//    consecutive output columns; it slides the k-wide window along its
//    run, so each ring value is loaded about k times, not k^2; taps summed
//    in (ky, kx) order; BN1, swish, the output rounded to T (a warp stores
//    whole 128-byte positions) and the thread's fp32 SE sums.
//
// Only the k - 1 rows at a segment's top are expanded by two blocks; x is
// read from device memory once (the chunks of one row segment run side by
// side and share it through L2). The SE sums of a block are added in a
// fixed order into part[b, segment, c]; a second small kernel in the same
// call adds the segments in order and divides: no atomics, so every run
// gives the same bits. The launch plan (rows per segment, run length) comes
// from kernels/mbconv.py (_mb_plan).

#include "cluster_mma.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int NRMAX = 6;               // output columns per run, at most

// x * sigmoid(x) with the fast exponential and division: a few ulp of
// fp32, far inside the fp32 tolerance, and ~10 instructions fewer than
// the IEEE division for each of the two per output
__device__ __forceinline__ float swish(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

template <typename T> __device__ __forceinline__ void zero16(T* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

struct Params {
  const void* x;
  long long sb, sh, sw;                // x strides in elements
  const void* w_exp;                   // [Cin, Cexp] in T, or null
  const float* s0; const float* b0;    // [Cexp] (with w_exp)
  const float* w_dw;                   // [k, k, Cexp]
  const float* s1; const float* b1;    // [Cexp]
  void* out;                           // [B, Ho, Wo, Cexp] in T
  float* part;                         // [B, nseg, Cexp]
  int H, W, cin, cexp, pt, pl, ho, wo;
  int rows, nseg, nr;                  // plan: rows per segment, run length
  int kp, mpad, wr, ns;                // derived: see layout()
};

// Shared memory of a block (byte offsets; every region 16-byte aligned):
// the w_exp chunk [kp][ldb], two staged x rows [mpad][lda] (after the walk
// the SE reduction [threads][<= 4]), the ring of ns expanded rows [wr][ldr]
// and the BN0 affine [2][CC] (the depthwise weights and BN1 live in each
// thread's registers). In bf16 rows are padded by 16 bytes, which keeps
// ldmatrix and the fragment stores free of bank conflicts; fp32 (no tensor
// cores) pads only the staged rows and takes K as it is.
struct Layout {
  int lda, ldb, ldr;
  unsigned w, x, ring, prm, red, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(bool expand, int kp, int mpad,
                                         int wr, int ns) {
  constexpr int V = 16 / sizeof(T), CC = 128 / sizeof(T);
  constexpr int PAD = sizeof(T) == 2 ? V : 0;   // fp32 runs no ldmatrix
  Layout s;
  s.lda = kp + V;
  s.ldb = CC + PAD;
  s.ldr = CC + PAD;
  unsigned at = 0;
  s.w = at;
  at += expand ? kp * s.ldb * sizeof(T) : 0;
  s.x = at;                       // the SE reduction reuses this room
  s.red = at;
  const unsigned xb = expand ? 2 * mpad * s.lda * sizeof(T) : 0u;
  at += xb > kThreads * 4 * 4 ? xb : kThreads * 4 * 4;
  s.ring = at;
  at += ns * wr * s.ldr * sizeof(T);
  s.prm = at;
  at += 2 * CC * 4;
  s.bytes = at;
  return s;
}

// One staged x row (xr [mpad][lda]) expanded into a ring slot (dst, at
// column pl): BN0, swish, rounded to T.
template <typename T>
__device__ __forceinline__ void expand_row(const T* xr, const T* w_s,
                                           const float* prm, T* dst,
                                           const Layout& L, const Params& p) {
  constexpr int CC = 128 / sizeof(T);
  if constexpr (sizeof(T) == 2) {
    // tensor cores: warps take (16 positions, 32 channels) tiles
    constexpr int NQ = CC / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    // from the last warp down: the depthwise's runs fill the first threads
    for (int u = kWarps - 1 - warp; u < (p.mpad / 16) * NQ; u += kWarps) {
      const int m0 = (u / NQ) * 16, n0 = (u % NQ) * 32;
      float acc[4][4] = {};
      for (int k0 = 0; k0 < p.kp; k0 += 16) {
        unsigned a[4], b0[4], b1[4];
        load_a<false>(a, xr, L.lda, m0, k0);
        load_b_kn(b0, w_s, L.ldb, k0, n0);
        load_b_kn(b1, w_s, L.ldb, k0, n0 + 16);
        mma16816(acc[0], a, b0[0], b0[1]);
        mma16816(acc[1], a, b0[2], b0[3]);
        mma16816(acc[2], a, b1[0], b1[1]);
        mma16816(acc[3], a, b1[2], b1[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j * 8 + q * 2;
        const float sa = prm[n], sb = prm[n + 1];
        const float ha = prm[CC + n], hb = prm[CC + n + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pos = m0 + g + h * 8;
          if (pos < p.W)
            store_pair(dst + pos * L.ldr + n,
                       swish(fmaf(acc[j][2 * h], sa, ha)),
                       swish(fmaf(acc[j][2 * h + 1], sb, hb)));
        }
      }
    }
  } else {
    // CUDA cores: each thread 4 positions (PG apart) x 4 channels
    constexpr int CQ = CC / 4, PG = kThreads / CQ;
    const int cq = threadIdx.x % CQ, pg = threadIdx.x / CQ;
    const float* wp = w_s + cq * 4;
    for (int base = 0; base < p.W; base += 4 * PG) {
      const float* xp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xp[j] = xr + min(base + pg + PG * j, p.mpad - 1) * L.lda;
      float acc[4][4] = {};
      for (int k = 0; k < p.cin; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wp + k * L.ldb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = xp[j][k];
          acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = base + pg + PG * j;
        if (pos >= p.W) continue;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          e[i] = swish(fmaf(acc[j][i], prm[cq * 4 + i], prm[CC + cq * 4 + i]));
        *reinterpret_cast<float4*>(dst + pos * L.ldr + cq * 4) =
            make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }
}

// Channels per thread in the depthwise: all k x k weights of them stay in
// registers (36 at k 3, 50 at k 5)
template <int K> constexpr int kCpt = K == 3 ? 4 : 2;

// N channels of T in shared or global memory, as floats, and back
template <int N> __device__ __forceinline__ void load_n(const float* p,
                                                        float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else {
    const float2 r = *reinterpret_cast<const float2*>(p);
    v[0] = r.x; v[1] = r.y;
  }
}
template <int N> __device__ __forceinline__ void load_n(const bf16* p,
                                                        float (&v)[N]) {
  using Raw = typename std::conditional<N == 4, uint2, unsigned>::type;
  const Raw r = *reinterpret_cast<const Raw*>(p);   // one 8- or 4-byte load
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <int N> __device__ __forceinline__ void store_n(float* p,
                                                         const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
template <int N> __device__ __forceinline__ void store_n(bf16* p,
                                                         const float (&v)[N]) {
  if constexpr (N == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                           __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

// A thread's part of the depthwise: channels c0 + N g .. + N - 1 of the
// chunk, their k x k weights in registers for the whole segment, BN1.
template <int K> struct Taps {
  static constexpr int N = kCpt<K>;
  int g;
  bool on;                       // the group lies inside Cexp
  float w[K * K][N];
  float s1[N], b1[N];
};

// One output row (oy) from the ring, whose newest row is walk step i: runs
// of nr output columns per thread, the k-wide window sliding along the run
// (each ring value loaded about k times, not k^2); taps summed in (ky, kx)
// order; BN1, swish, the output rounded to T and the thread's SE sums.
template <typename T, int K, int S>
__device__ __forceinline__ void emit_row(const T* ring, int i, int oy, int b,
                                         int c0, const Taps<K>& t,
                                         const Layout& L, const Params& p,
                                         float (&se)[kCpt<K>]) {
  constexpr int N = kCpt<K>, CC = 128 / sizeof(T), NG = CC / N;
  constexpr int P = kThreads / NG;               // run slots
  constexpr int SPAN = (NRMAX - 1) * S + K;      // window of a full run
  if (!t.on) return;
  const int slot = p.wr * L.ldr;
  const int nruns = (p.wo + p.nr - 1) / p.nr;
  T* out = static_cast<T*>(p.out)
           + ((long long)b * p.ho + oy) * p.wo * p.cexp + c0 + N * t.g;
  for (int run = threadIdx.x / NG; run < nruns; run += P) {
    const int ox0 = run * p.nr;
    const int n = min(p.nr, p.wo - ox0);
    float acc[NRMAX][N] = {};
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const T* row = ring + ((i - (K - 1) + ky) % p.ns) * slot
                     + ox0 * S * L.ldr + N * t.g;
#pragma unroll
      for (int jj = 0; jj < SPAN; ++jj) {
        if (jj >= (n - 1) * S + K) break;
        float e[N];
        load_n<N>(row + jj * L.ldr, e);
#pragma unroll
        for (int o = 0; o < NRMAX; ++o) {
          const int kx = jj - o * S;
          if (kx < 0 || kx >= K || o >= n) continue;
#pragma unroll
          for (int c = 0; c < N; ++c)
            acc[o][c] = fmaf(e[c], t.w[ky * K + kx][c], acc[o][c]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NRMAX; ++o) {
      if (o >= n) break;
      float y[N];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        y[c] = swish(fmaf(acc[o][c], t.s1[c], t.b1[c]));
        se[c] += y[c];
      }
      store_n<N>(out + (long long)(ox0 + o) * p.cexp, y);
    }
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads, 2)
mbconv_kernel(Params p) {
  constexpr int V = 16 / sizeof(T), CC = 128 / sizeof(T), NV = CC / V;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool expand = p.w_exp != nullptr;
  const Layout L = layout<T>(expand, p.kp, p.mpad, p.wr, p.ns);
  T* w_s = reinterpret_cast<T*>(smem + L.w);
  T* x_s = reinterpret_cast<T*>(smem + L.x);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  float* prm = reinterpret_cast<float*>(smem + L.prm);  // s0, b0
  float* red = reinterpret_cast<float*>(smem + L.red);  // [threads][N]
  const int tid = threadIdx.x;
  const int seg = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * CC;
  const int oy0 = seg * p.rows;
  const int nin = (min(p.rows, p.ho - oy0) - 1) * S + K;  // walk steps
  const int r0 = oy0 * S - p.pt;                 // input row of step 0
  const T* xb = static_cast<const T*>(p.x) + b * p.sb;
  const int slot = p.wr * L.ldr;

  // ---- set-up: the chunk's operands; zero every padding ----
  for (int i = tid; i < CC; i += kThreads) {
    const bool ok = expand && c0 + i < p.cexp;
    prm[i] = ok ? p.s0[c0 + i] : 0.0f;
    prm[CC + i] = ok ? p.b0[c0 + i] : 0.0f;
  }
  constexpr int N = kCpt<K>;
  Taps<K> taps;
  taps.g = tid % (CC / N);
  const int tc = c0 + N * taps.g;
  taps.on = tc < p.cexp;              // Cexp is a multiple of 16 bytes of T
#pragma unroll
  for (int q = 0; q < K * K; ++q)
#pragma unroll
    for (int c = 0; c < N; ++c)
      taps.w[q][c] = taps.on ? p.w_dw[q * p.cexp + tc + c] : 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    taps.s1[c] = taps.on ? p.s1[tc + c] : 0.0f;
    taps.b1[c] = taps.on ? p.b1[tc + c] : 0.0f;
  }
  const int nhalo = p.wr - p.W;                  // ring columns outside x
  for (int i = tid; i < p.ns * nhalo * NV; i += kThreads) {
    const int v = i % NV, col = (i / NV) % nhalo, s = i / (NV * nhalo);
    zero16(ring + s * slot + (col < p.pl ? col : col + p.W) * L.ldr + v * V);
  }
  if (expand) {
    const T* we = static_cast<const T*>(p.w_exp);
    for (int i = tid; i < p.kp * NV; i += kThreads) {
      const int k = i / NV, c = c0 + (i % NV) * V;
      const bool ok = k < p.cin && c < p.cexp;
      cp_async16(w_s + k * L.ldb + (i % NV) * V,
                 ok ? we + (long long)k * p.cexp + c : we, ok ? 16 : 0);
    }
    // channels [cin, kp) and positions [W, mpad) of both staged rows
    const int cv_in = p.cin / V, cv_all = p.kp / V;
    for (int i = tid; i < 2 * p.mpad * cv_all; i += kThreads) {
      const int v = i % cv_all, r = i / cv_all;
      if (v >= cv_in || r % p.mpad >= p.W) zero16(x_s + r * L.lda + v * V);
    }
  }

  // walk step i's input row: to a staged row (expand) or to its ring slot
  auto stage = [&](int i) {
    const int ih = r0 + i;
    const bool in = ih >= 0 && ih < p.H;
    const T* src = xb + (long long)(in ? ih : 0) * p.sh;
    if (expand) {
      if (!in) return;
      T* dst = x_s + (i & 1) * p.mpad * L.lda;
      const int cv_in = p.cin / V;
      for (int q = tid; q < p.W * cv_in; q += kThreads) {
        const int pos = q / cv_in, v = q % cv_in;
        cp_async16(dst + pos * L.lda + v * V, src + pos * p.sw + v * V, 16);
      }
    } else {
      T* dst = ring + (i % p.ns) * slot + p.pl * L.ldr;
      for (int q = tid; q < p.W * NV; q += kThreads) {
        const int pos = q / NV, v = q % NV;
        const bool ok = in && c0 + v * V < p.cexp;
        cp_async16(dst + pos * L.ldr + v * V,
                   ok ? src + pos * p.sw + c0 + v * V : xb, ok ? 16 : 0);
      }
    }
  };

  // walk step i's expanded row into its ring slot (zero outside x)
  auto expand_step = [&](int i) {
    T* dst = ring + (i % p.ns) * slot + p.pl * L.ldr;
    const int ih = r0 + i;
    if (ih >= 0 && ih < p.H) {
      expand_row<T>(x_s + (i & 1) * p.mpad * L.lda, w_s, prm, dst, L, p);
    } else {
      for (int q = tid; q < p.W * NV; q += kThreads)
        zero16(dst + (q / NV) * L.ldr + (q % NV) * V);
    }
  };

  // Step i expands row i + 1 and emits from rows i - k + 1 .. i: the ring's
  // k + 1 slots keep the two apart, so one barrier per step suffices, and
  // warps idle in one part run the other.
  const int ahead = expand ? 2 : 1;              // rows copied ahead
  stage(0);
  cp_async_commit();
  if (expand) {
    stage(1);                     // a walk has at least k rows
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    expand_step(0);
  }
  float se[N] = {};
  for (int i = 0; i < nin; ++i) {
    cp_async_wait<0>();
    __syncthreads();              // rows i (and i + 1) in; step i - 1 done
    if (i + ahead < nin) stage(i + ahead);
    cp_async_commit();
    if (expand && i + 1 < nin) expand_step(i + 1);
    const int j = i - (K - 1);
    if (j >= 0 && j % S == 0)
      emit_row<T, K, S>(ring, i, oy0 + j / S, b, c0, taps, L, p, se);
  }

  // ---- the block's SE sums: threads of one group, in run-slot order ----
  __syncthreads();                // red takes the staged rows' room
#pragma unroll
  for (int c = 0; c < N; ++c) red[N * tid + c] = se[c];
  __syncthreads();
  for (int c = tid; c < CC; c += kThreads) {
    if (c0 + c >= p.cexp) break;
    float s = 0.0f;
    for (int q = 0; q < kThreads / (CC / N); ++q) s += red[c + q * CC];
    p.part[((long long)b * p.nseg + seg) * p.cexp + c0 + c] = s;
  }
}

// se[b, c] = (sum over the segments, in order, of part[b, t, c]) / count
__global__ void se_mean_kernel(const float* part, float* se, int n, int nseg,
                               int cexp, float count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* at = part + (long long)(i / cexp) * nseg * cexp + i % cexp;
  float s = 0.0f;
  for (int t = 0; t < nseg; ++t) s += at[(long long)t * cexp];
  se[i] = s / count;
}

// the derived plan fields, as _mb_plan computes them
template <typename T, int K, int S> void derive(Params& p, bool expand) {
  p.kp = sizeof(T) == 2 ? (p.cin + 15) / 16 * 16 : p.cin;
  p.mpad = (p.W + 15) / 16 * 16;
  p.wr = max(p.pl + p.W, (p.wo - 1) * S + K);
  p.ns = K + 1;
}

template <typename T, int K, int S>
cudaError_t launch(Params p, int B, float* se, cudaStream_t stream) {
  const bool expand = p.w_exp != nullptr;
  derive<T, K, S>(p, expand);
  const Layout L = layout<T>(expand, p.kp, p.mpad, p.wr, p.ns);
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return err;
  constexpr int CC = 128 / sizeof(T);
  dim3 grid((p.cexp + CC - 1) / CC, p.nseg, B);
  mbconv_kernel<T, K, S><<<grid, kThreads, L.bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * p.cexp;
  se_mean_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      p.part, se, n, p.nseg, p.cexp, (float)(p.ho * p.wo));
  return cudaGetLastError();
}

template <typename T, int K, int S>
cudaError_t occupancy(Params p, bool expand, int* smem, int* blocks) {
  derive<T, K, S>(p, expand);
  *smem = (int)layout<T>(expand, p.kp, p.mpad, p.wr, p.ns).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_kernel<T, K, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mbconv_kernel<T, K, S>, kThreads, *smem);
}

struct Launch {
  Params p;
  int B;
  float* se;
  cudaStream_t stream;
  template <typename T, int K, int S> cudaError_t run() const {
    return launch<T, K, S>(p, B, se, stream);
  }
};
struct Occupancy {
  Params p;
  bool expand;
  int* smem;
  int* blocks;
  template <typename T, int K, int S> cudaError_t run() const {
    return occupancy<T, K, S>(p, expand, smem, blocks);
  }
};

// f.run<T, K, S>() for the runtime (is_bf16, k, stride)
template <typename F>
cudaError_t dispatch(int is_bf16, int k, int stride, const F& f) {
  if (is_bf16) {
    if (k == 3 && stride == 1) return f.template run<bf16, 3, 1>();
    if (k == 3 && stride == 2) return f.template run<bf16, 3, 2>();
    if (k == 5 && stride == 1) return f.template run<bf16, 5, 1>();
    if (k == 5 && stride == 2) return f.template run<bf16, 5, 2>();
  } else {
    if (k == 3 && stride == 1) return f.template run<float, 3, 1>();
    if (k == 3 && stride == 2) return f.template run<float, 3, 2>();
    if (k == 5 && stride == 1) return f.template run<float, 5, 1>();
    if (k == 5 && stride == 2) return f.template run<float, 5, 2>();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [B, H, W, Cin] in the compute type with element strides (sb, sh, sw)
// and contiguous channels, 16-byte aligned rows, Cin a whole number of
// 16-byte vectors; w_exp [Cin, Cexp] in the compute type (16-byte aligned)
// or null for expand_ratio 1 (then Cin == Cexp); s0, b0, s1, b1 [Cexp]
// fp32; w_dw [k, k, Cexp] fp32 -> out [B, Ho, Wo, Cexp] (compute type,
// contiguous), se [B, Cexp] fp32 (the SE mean), with part [B, nseg, Cexp]
// fp32 scratch, nseg = ceil(Ho / rows). k is 3 or 5, stride 1 or 2; rows
// and nr (output columns per run, 1..4) come from the plan.
int mbconv_front(int is_bf16, int k, int stride, const void* x, long long sb,
                 long long sh, long long sw, const void* w_exp,
                 const float* s0, const float* b0, const float* w_dw,
                 const float* s1, const float* b1, void* out, float* part,
                 float* se, int B, int H, int W, int cin, int cexp, int pt,
                 int pl, int ho, int wo, int rows, int nr, void* stream) {
  if (nr < 1 || nr > NRMAX || rows < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.sb = sb; p.sh = sh; p.sw = sw;
  p.w_exp = w_exp; p.s0 = s0; p.b0 = b0; p.w_dw = w_dw; p.s1 = s1; p.b1 = b1;
  p.out = out; p.part = part;
  p.H = H; p.W = W; p.cin = cin; p.cexp = cexp; p.pt = pt; p.pl = pl;
  p.ho = ho; p.wo = wo; p.rows = rows; p.nr = nr;
  p.nseg = (ho + rows - 1) / rows;
  return (int)dispatch(is_bf16, k, stride,
                       Launch{p, B, se, static_cast<cudaStream_t>(stream)});
}

// the kernel's shared memory for a shape and how many of its blocks an SM
// holds at once (for logging beside the plan)
int mbconv_occupancy(int is_bf16, int k, int stride, int has_expand, int W,
                     int cin, int pl, int wo, int* smem, int* blocks) {
  Params p = {};
  p.W = W; p.cin = cin; p.pl = pl; p.wo = wo;
  return (int)dispatch(is_bf16, k, stride,
                       Occupancy{p, has_expand != 0, smem, blocks});
}

}  // extern "C"
