"""The card's peak rate of ``mma.sync.m16n8k16`` (bf16 in, fp32
accumulate), the tensor-core instruction of the port's cluster kernels.

    python3 -m segtran_tpu_torch.tools.mma_sync_rate

Builds a small CUDA program with nvcc (sm_90a) into ``build/kernels/``,
whose kernel runs nothing but mma.sync on registers (16 independent
accumulators per warp) on every SM, at 4, 8 and 16 warps per block and
one or two blocks per SM, and prints the TFLOP/s of each with the card's
name, power limit and SM clock. It is the ceiling that a kernel built on
mma.sync can approach (the H100's 989 TFLOP/s bf16 peak needs wgmma).
Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import subprocess

from ..kernels import _build

# mma16816 is the kernels' own (csrc/cluster_mma.cuh)
SOURCE = r"""
#include <cstdio>
#include "cluster_mma.cuh"
__global__ void mma_loop(float* out, int iters) {
  float acc[16][4] = {};
  const unsigned t = threadIdx.x;
  unsigned a[4] = {t, t * 3u, t * 5u, t * 7u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) mma16816(acc[j], a, t * 11u + j, t * 13u);
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 2 * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 20000;
  for (int warps : {4, 8, 16})
    for (int per_sm : {1, 2}) {
      const int grid = sms * per_sm;
      mma_loop<<<grid, warps * 32>>>(out, 100);
      cudaDeviceSynchronize();
      cudaEventRecord(e0);
      mma_loop<<<grid, warps * 32>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flop = 2.0 * 16 * 8 * 16 * 16.0 * iters * grid * warps;
      printf("%2d warps per block, %d block(s) per SM: %.1f TFLOP/s\n",
             warps, per_sm, flop / ms / 1e9);
    }
  const cudaError_t e = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "mma_sync_rate.cu"
    exe = _build.BUILD_DIR / "mma_sync_rate"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-I", str(_build.CSRC), "-o", str(exe), str(src)],
                   check=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=False)
    return subprocess.run([str(exe)], check=False).returncode


if __name__ == "__main__":
    raise SystemExit(main())
