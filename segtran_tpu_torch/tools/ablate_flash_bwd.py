"""Where the flash backward kernels (dK/dV and dQ) spend their time, by
ablation.

    python3 -m segtran_tpu_torch.tools.ablate_flash_bwd

Builds ``csrc/squeezed_attention.cu`` as it is and in variants with one
part removed or replaced (the partial score products, the dK/dV/dQ
products, the p / ds step, the loads of the streamed q / dO or k / v
tiles, distributed shared memory: peers' buffers replaced by this CTA's
own, and that with block barriers in place of the cluster barriers), then
times each backward kernel with CUDA events at the in-squeeze of a
160x192x144 training crop (bf16, G=1, Q=1024, N=8640, D=F=1024). A
variant computes garbage; only its time is read. The difference to the
unchanged source is that part's share. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import squeezed_attention as sa

_SCORES = "__device__ void slice_scores(const T* A, const T* B, float* out) {\n"
_PRODUCTS = ("float (&acc)[Cell<T, W>::ACC]) {\n  using K = Cell<T, W>;\n"
             "  constexpr int TB = K::TB;\n")
_PUBLISH = "                             int nD, int nF) {\n"
_ARRIVE = ('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: '
           '"memory");')
_WAIT = ('asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: '
         '"memory");')
_LOCAL = ("template <typename P> __device__ P* local_rank(P* at, int) "
          "{ return at; }\n")
_RETURN = "  if (threadIdx.x < 1024) return;  // ablated\n"

# variant -> [(text to find, replacement), ...]
VARIANTS = {
    "as is": [],
    "no partial scores": [(_SCORES, _SCORES + _RETURN)],
    "no dK/dV/dQ products": [(_PRODUCTS, _PRODUCTS + _RETURN)],
    "no p / ds step": [(_PUBLISH, _PUBLISH + _RETURN)],
    "own shared memory for peers'": [
        ("cluster.map_shared_rank(", "local_rank("),
        ("// The rows of a cell that CTA `rank` owns",
         _LOCAL + "// The rows of a cell that CTA `rank` owns")],
    "no streamed tile loads": [("stage_tile<T, TB, W>(sm.slot(",
                                "if (false) stage_tile<T, TB, W>(sm.slot(")],
}
# without cluster barriers a CTA could exit while a peer still stores into
# its shared memory, so that variant also keeps every access local
VARIANTS["own shared memory and block barriers"] = VARIANTS[
    "own shared memory for peers'"] + [(_ARRIVE, "__syncthreads();"),
                                       (_WAIT, "")]


def _build_variants(out_dir: Path, variants=None,
                    source: str = "squeezed_attention") -> dict:
    """Build csrc/<source>.cu (its headers inlined) once per variant, all
    nvcc processes at once; the loaded library of each variant by name."""
    src = _build.source_text(source)
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate((variants or VARIANTS).items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant '{name}': source text not found")
            text = text.replace(old, new)
        cu, so = out_dir / f"{source}{i}.cu", out_dir / f"{source}{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant '{name}':\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_flash_bwd needs a CUDA GPU")
    libs = _build_variants(_build.BUILD_DIR / "ablate")
    vp, i_, d_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.flash_bwd.argtypes = [i_, i_] + [vp] * 10 + [i_] * 7 + [d_, d_,
                                                                   vp]
    g, nq, n, d, f = 1, 1024, 8640, 1024, 1024
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(bf)
                   for shape in ((g, nq, d), (g, n, d), (g, n, f),
                                 (g, nq, f)))
    lse = torch.full((g, nq, 1), math.log(n), device="cuda")
    delta = torch.zeros((g, nq, 1), device="cuda")
    plan = sa._bwd_plan(g, nq, n, d, f, bf, sa._sm_count("cuda"))
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dv = torch.empty_like(v)
    part = torch.empty((plan.splits, g, nq, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), plan)
    base = {}
    for name, lib in libs.items():
        for kernel, dkdv in (("dK/dV", 1), ("dQ", 0)):
            def call(lib=lib, dkdv=dkdv):
                return lib.flash_bwd(
                    1, dkdv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    part.data_ptr(), g, nq, n, d, f, plan.width, plan.splits,
                    1.0 / math.sqrt(d), 500.0, stream)
            if call() != 0:
                raise RuntimeError(f"variant '{name}' failed to launch")
            ms = _time_ms(call)
            base.setdefault(kernel, ms)
            cut = 100 * (base[kernel] - ms) / base[kernel]
            print(f"{kernel:6s} {name:36s} {ms:.4f} ms ({cut:+.1f}% of the "
                  f"as-is time removed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
