"""Where the full-fusion epilogue kernel (``mid_pool_kernel``) spends its
time, by ablation.

    python3 -m segtran_tpu_torch.tools.ablate_epilogue

Builds ``csrc/expansion_epilogue.cu`` as it is and in variants with one
part removed or replaced (the tensor-core products; the W2 chunk loads;
distributed shared memory for the mid pulls, the peers' slices replaced by
this CTA's own; the cluster reductions, the peers' row partials replaced by
this CTA's own; all distributed shared memory, with block barriers in
place of the cluster barriers; the gelu; the block barrier of each depth
chunk; both products' chunk loops, leaving the per-mode row phases and
their barriers), then times one call at each of chip_smoke's full-fusion
shapes (bf16, the flagship's B=8, M=4, N=1296, A=256; F=1792, 896, 448)
with CUDA events. A variant computes garbage; only its time is read. The
difference to the unchanged source is that part's share. Needs a CUDA GPU
and nvcc.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import _build
from ..kernels import expansion_epilogue as epi
from .ablate_flash_bwd import _build_variants, _time_ms

_PULL = "cluster.map_shared_rank(sm.mid + r * G::LDM + kc0 + c, j)"
_SUM = ("*cluster.map_shared_rank(\n"
        "            const_cast<float*>(part) + at + q * stride, j)")
_ARRIVE = ('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: '
           '"memory");')
_WAIT = ('asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: '
         '"memory");')
_MMA = ("          mma16816(acc + mt * 32 + j * 4, a[mt], b[0], b[1]);\n"
        "          mma16816(acc + mt * 32 + j * 4 + 4, a[mt], b[2], b[3]);\n")
_W2 = "        stage_tile<T, KC, kW>(sm.b(t), G::LDB, w2 +"
_SYNC = ("    __syncthreads();             // everyone's; slot t - 1 is free "
         "again\n")
_RUN_A = ("    run_chunks<T, false>(acc, sm, nka, [&](int t) { issue_a(m, t); "
          "});")
_RUN_B = "    run_chunks<T, true>(acc, sm, nkb, issue_b);"
_NO_RUN = "    cp_async_wait<0>();\n    __syncthreads();"
_LOCAL_PULL = [(_PULL, "(sm.mid + r * G::LDM + kc0 + c)")]
_LOCAL_SUM = [(_SUM, "part[at + q * stride]")]

# variant -> [(text to find, replacement), ...]
VARIANTS = {
    "as is": [],
    "no products": [(_MMA, "")],
    "no W2 loads": [(_W2, "        if (false) stage_tile<T, KC, kW>(sm.b(t), "
                          "G::LDB, w2 +")],
    "own mid slice for the peers'": _LOCAL_PULL,
    "own row partials for the peers'": _LOCAL_SUM,
    # without cluster barriers a CTA could exit while a peer still reads
    # its shared memory, so that variant also keeps every access local
    "own memory and block barriers": _LOCAL_PULL + _LOCAL_SUM + [
        (_ARRIVE, "__syncthreads();"), (_WAIT, "")],
    "no gelu": [("g[x] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));",
                 "g[x] = v;")],
    "no depth-chunk block barrier": [(_SYNC, "")],
    # what remains is the per-mode row phases (gelu, LayerNorm, score,
    # pool), the cluster barriers and the waits for the first chunks
    "row phases only (no chunk loops)": [(_RUN_A, _NO_RUN),
                                         (_RUN_B, _NO_RUN)],
}
# (label, F): chip_smoke's full-fusion cases
CASES = [("permode F=1792", 1792), ("all modes F=896", 896),
         ("all modes F=448", 448)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_epilogue needs a CUDA GPU")
    libs = _build_variants(_build.BUILD_DIR / "ablate_epi", VARIANTS,
                           "expansion_epilogue")
    vp, i_, d_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.epi_mid_pool.argtypes = [i_] + [vp] * 10 + [i_] * 6 + [d_, vp]
    b, m, n, a = 8, 4, 1296, 256
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), flush=True)
    for label, f in CASES:
        plan = epi._epi_plan(b, m, n, a, f, bf, epi._sm_count("cuda"))
        p = torch.softmax(rn(b, m, n, a, s=4.0), -1).to(bf)
        t = [p, rn(b, m, a, f, s=2.0).to(bf), rn(f, s=0.1).to(bf),
             (rn(m, f, f) / f ** 0.5).to(bf), rn(m, f, s=0.1).to(bf),
             (torch.rand(f, device="cuda") + 0.5).to(bf), rn(f, s=0.1).to(bf),
             rn(f, 1, s=0.02).to(bf), rn(1)]
        out = torch.empty(b, n, f, dtype=bf, device="cuda")
        ptrs = [x.data_ptr() for x in t]
        print(label, plan, flush=True)
        base = None
        for name, lib in libs.items():
            def call(lib=lib):
                return lib.epi_mid_pool(1, *ptrs, out.data_ptr(), b, m, n, a,
                                        f, plan.tile, 1e-12, stream)
            if call() != 0:
                raise RuntimeError(f"variant '{name}' failed to launch")
            ms = _time_ms(call)
            base = ms if base is None else base
            print(f"{label:16s} {name:34s} {ms:.4f} ms "
                  f"({100 * (base - ms) / base:+.1f}% of the as-is time "
                  f"removed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
