// The front half of an EfficientNet MBConv block in eval, for Hopper
// (sm_90a):
//
//     e   = T(swish(bn0(x @ w_exp)))          fp32 sums, zero outside the
//                                             input (the TF-SAME halo)
//     y   = swish(bn1(depthwise_kxk(e)))      fp32 sums over the k*k taps
//     out = T(y),   part[b, t, c] = sum of y over the block's output rows
//
// with x [B, H, W, Cin] (any strides, channels contiguous) in the compute
// type T (bf16 or fp32), the folded BatchNorm affines, the expand weights
// (T-rounded) and the depthwise weights in fp32. Without an expand
// (expand_ratio 1) e is x itself, zero in the halo. Replaces the Pallas
// kernel of segtran_tpu/kernels/mbconv.py (mbconv_front /
// _mbconv_front_kernel).
//
// What bounds it on an H100 SXM: at the eff-b4 288^2 shapes at batch 8
// (H = 144..36, Cin = 32..160, Cexp = 192..960, k = 3 or 5) the function
// moves x once and its 6x wider output once, 31-74 MB (9-22 us at 3.35
// TB/s), against 1-4 GFLOP (1-4 us at 989 TFLOP/s): bound by bytes. The
// unfused chain also writes the expanded tensor and reads it back, and
// reads the output again for the SE mean; this kernel keeps the expanded
// tile in shared memory and sums the SE mean on the way out.
//
// The design (a first, simple one). Each block owns one batch item, a tile
// of `th` output rows and 32 expanded channels (one per lane; 8 warps):
//
// 1. the expand for its band of (th - 1) * stride + k padded input rows
//    and the (wo - 1) * stride + k columns its outputs read, on the CUDA
//    cores: each warp takes 4 band positions at a time and reads their
//    input channels as 16-byte vectors (the same address in every lane: a
//    broadcast from L1), each lane one expanded channel whose weights sit
//    in shared memory; BN0 and swish in fp32, zero outside the input
//    rectangle, rounded to T into the shared-memory tile;
// 2. the depthwise conv from that tile, taps in (ky, kx) order as the TPU
//    kernel sums them, with each lane's k*k weights in registers; BN1,
//    swish, the rounded output, and the lane's fp32 sum for the SE mean;
// 3. the SE partial sums of the 8 warps, added in a fixed order and written
//    to part[b, t, c]: no atomics, so every run gives the same bits.
//
// Halo rows are recomputed by the neighbouring row tiles, and x is read
// once for each 32-channel tile (from L2). The wrapper picks th so the
// tile fits 100 KB of shared memory (two blocks per SM), or, where one row
// does not (fp32 at W = 288), the 226 KB one block may take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CT = 32;                 // expanded channels per block
constexpr int kWarps = 8;
constexpr int kThreads = CT * kWarps;
constexpr int PP = 4;                  // band positions per warp step

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float swish(float v) {
  return v / (1.0f + expf(-v));
}

// 16 bytes of T as floats
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 r = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  }
};
template <> struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* out) {
    uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

struct Params {
  const void* x;
  long long sb, sh, sw;                // x strides in elements
  const float* w_exp;                  // [Cin, Cexp] or null
  const float* s0; const float* b0;    // [Cexp] (with w_exp)
  const float* w_dw;                   // [k, k, Cexp]
  const float* s1; const float* b1;    // [Cexp]
  void* out;                           // [B, Ho, Wo, Cexp]
  float* part;                         // [B, n_t, Cexp]
  int H, W, cin, cexp, stride, pt, pl, ho, wo, th, n_t;
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
mbconv_front_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float se_red[kWarps][CT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int c = ct * CT + lane;
  const bool active = c < p.cexp;
  const int tin = (p.th - 1) * p.stride + K;
  const int wc = (p.wo - 1) * p.stride + K;
  const int npos = tin * wc;
  const int r0 = t * p.th * p.stride;   // first band row, padded coords
  const T* x = static_cast<const T*>(p.x) + b * p.sb;
  const bool expand = p.w_exp != nullptr;
  float* w_s = reinterpret_cast<float*>(smem);
  T* e_s = reinterpret_cast<T*>(smem + (expand ? p.cin * CT * 4 : 0));

  // ---- 1. the expanded band tile e_s [tin * wc][CT] ----
  if (expand) {
    for (int i = threadIdx.x; i < p.cin * CT; i += kThreads) {
      const int ci = i / CT, cc = ct * CT + i % CT;
      w_s[i] = cc < p.cexp ? p.w_exp[(long long)ci * p.cexp + cc] : 0.0f;
    }
    __syncthreads();
    const float sc0 = active ? p.s0[c] : 0.0f;
    const float sh0 = active ? p.b0[c] : 0.0f;
    constexpr int V = Vec16<T>::N;
    for (int q0 = warp * PP; q0 < npos; q0 += kWarps * PP) {
      const T* xp[PP];
      bool ok[PP];
      float acc[PP];
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int q = q0 + j;
        const int ih = r0 + q / wc - p.pt, iw = q % wc - p.pl;
        ok[j] = q < npos && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
        xp[j] = x + ih * p.sh + iw * p.sw;
        acc[j] = 0.0f;
      }
      for (int ci = 0; ci < p.cin; ci += V) {
        float wv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) wv[v] = w_s[(ci + v) * CT + lane];
#pragma unroll
        for (int j = 0; j < PP; ++j) {
          if (!ok[j]) continue;
          float xv[V];
          Vec16<T>::load(xp[j] + ci, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[j] = fmaf(xv[v], wv[v], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int q = q0 + j;
        if (q >= npos) break;
        // the halo is zero AFTER swish: the unfused chain pads the
        // expanded tensor, and swish(bn0(0)) is not zero
        const float e = ok[j] ? swish(fmaf(acc[j], sc0, sh0)) : 0.0f;
        e_s[q * CT + lane] = from_f<T>(e);
      }
    }
  } else {
    // expand_ratio 1: the band of x itself (Cin == Cexp), zero halo
    for (int q = warp; q < npos; q += kWarps) {
      const int ih = r0 + q / wc - p.pt, iw = q % wc - p.pl;
      const bool ok = active && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
      e_s[q * CT + lane] = ok ? x[ih * p.sh + iw * p.sw + c] : from_f<T>(0.0f);
    }
  }
  __syncthreads();

  // ---- 2. depthwise k x k, BN1, swish, output and SE sums ----
  float wd[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i)
    wd[i] = active ? p.w_dw[(long long)i * p.cexp + c] : 0.0f;
  const float sc1 = active ? p.s1[c] : 0.0f;
  const float sh1 = active ? p.b1[c] : 0.0f;
  const int oy0 = t * p.th;
  const int rows = min(p.th, p.ho - oy0);
  T* out = static_cast<T*>(p.out);
  float se = 0.0f;
  for (int q = warp; q < rows * p.wo; q += kWarps) {
    const int oy = q / p.wo, ox = q % p.wo;
    const T* e = e_s + ((oy * p.stride) * wc + ox * p.stride) * CT + lane;
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
        acc += to_f(e[(ky * wc + kx) * CT]) * wd[ky * K + kx];
    const float y = swish(fmaf(acc, sc1, sh1));
    if (active) {
      out[(((long long)b * p.ho + oy0 + oy) * p.wo + ox) * p.cexp + c] =
          from_f<T>(y);
      se += y;
    }
  }

  // ---- 3. the block's SE partial sums, in a fixed order ----
  se_red[warp][lane] = se;
  __syncthreads();
  if (warp == 0 && active) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += se_red[w][lane];
    p.part[((long long)b * p.n_t + t) * p.cexp + c] = s;
  }
}

template <typename T, int K>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int tin = (p.th - 1) * p.stride + K;
  const int wc = (p.wo - 1) * p.stride + K;
  const size_t smem = (p.w_exp ? (size_t)p.cin * CT * 4 : 0)
                      + (size_t)tin * wc * CT * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_front_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.cexp + CT - 1) / CT, p.n_t, B);
  mbconv_front_kernel<T, K><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const Params& p, int k, int B, cudaStream_t stream) {
  if (k == 3) return launch<T, 3>(p, B, stream);
  if (k == 5) return launch<T, 5>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [B, H, W, Cin] in the compute type with element strides (sb, sh, sw)
// and contiguous channels, 16-byte aligned rows; w_exp [Cin, Cexp] fp32
// (T-rounded values) or null for expand_ratio 1 (then Cin == Cexp); s0,
// b0, s1, b1 [Cexp] fp32; w_dw [k, k, Cexp] fp32 -> out [B, Ho, Wo, Cexp]
// (compute type, contiguous), part [B, n_t, Cexp] fp32 with n_t =
// ceil(Ho / th). k is 3 or 5.
int mbconv_front(int is_bf16, int k, const void* x, long long sb,
                 long long sh, long long sw, const float* w_exp,
                 const float* s0, const float* b0, const float* w_dw,
                 const float* s1, const float* b1, void* out, float* part,
                 int B, int H, int W, int cin, int cexp, int stride, int pt,
                 int pl, int ho, int wo, int th, void* stream) {
  Params p = {};
  p.x = x; p.sb = sb; p.sh = sh; p.sw = sw;
  p.w_exp = w_exp; p.s0 = s0; p.b0 = b0; p.w_dw = w_dw; p.s1 = s1; p.b1 = b1;
  p.out = out; p.part = part;
  p.H = H; p.W = W; p.cin = cin; p.cexp = cexp; p.stride = stride;
  p.pt = pt; p.pl = pl; p.ho = ho; p.wo = wo; p.th = th;
  p.n_t = (ho + th - 1) / th;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_k<bf16>(p, k, B, st)
                                  : launch_k<float>(p, k, B, st));
}

}  // extern "C"
