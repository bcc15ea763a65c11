"""Where the expansion-epilogue kernel (``mid_pool_kernel``, both tiers)
spends its time, by ablation.

    python3 -m segtran_tpu_torch.tools.ablate_epilogue

Builds ``csrc/expansion_epilogue.cu`` as it is and in variants with one
part removed or replaced (the tensor-core products; the W2 chunk loads;
the private tier's mid chunk loads; distributed shared memory for the
full tier's mid pulls, the peers' slices replaced by this CTA's own; the
cluster reductions, the peers' row partials replaced by this CTA's own;
all distributed shared memory, with block barriers in place of the
cluster barriers; the gelu; the block barrier of each depth chunk; the
chunk loops of the products, leaving the per-mode row phases and their
barriers), then times one call at each of chip_smoke's full-fusion shapes
(bf16, the flagship's B=8, M=4, N=1296, A=256; F=1792, 896, 448) and at
the private tier's BraTS volume (mid [1, 4, 8640, 1024]) with CUDA events.
A variant computes garbage; only its time is read. The difference to the
unchanged source is that part's share (a variant of a part the tier does
not run shows none). Needs a CUDA GPU and nvcc.
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
_W2 = "stage_tile<T, KC, kW>(sm.b(t), G::LDB, w2 +"
_MID = "stage_tile<T, TM, KC>(sm.a(t), G::LDA, mg +"
_SYNC = ("    __syncthreads();             // everyone's; slot t - 1 is free "
         "again\n")
_RUN_A = "run_chunks<T, false>(acc, sm, nka, [&](int t) { issue_a(m, t); });"
_RUN_P = "run_chunks<T, false>(acc, sm, nkb, [&](int t) { issue_a(m, t); });"
_RUN_B = "run_chunks<T, true>(acc, sm, nkb, issue_b);"
_NO_RUN = "cp_async_wait<0>();\n      __syncthreads();"
_LOCAL_PULL = [(_PULL, "(sm.mid + r * G::LDM + kc0 + c)")]
_LOCAL_SUM = [(_SUM, "part[at + q * stride]")]

# variant -> [(text to find, replacement), ...]
VARIANTS = {
    "as is": [],
    "no products": [(_MMA, "")],
    "no W2 loads": [(_W2, "if (false) " + _W2)],
    "no mid loads (private tier)": [(_MID, "if (false) " + _MID)],
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
    "row phases only (no chunk loops)": [(_RUN_A, _NO_RUN), (_RUN_B, _NO_RUN),
                                         (_RUN_P, _NO_RUN)],
}
# (label, B, N, A, F): chip_smoke's full-fusion cases (M=4) and the
# private tier (A = 0) at the BraTS volume
CASES = [("permode F=1792", 8, 1296, 256, 1792),
         ("all modes F=896", 8, 1296, 256, 896),
         ("all modes F=448", 8, 1296, 256, 448),
         ("private BraTS", 1, 8640, 0, 1024)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_epilogue needs a CUDA GPU")
    libs = _build_variants(_build.BUILD_DIR / "ablate_epi", VARIANTS,
                           "expansion_epilogue")
    vp, i_, d_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.epi_mid_pool.argtypes = [i_] + [vp] * 10 + [i_] * 6 + [d_, vp]
        lib.epi_private_pool.argtypes = [i_] + [vp] * 8 + [i_] * 5 + [d_, vp]
    m = 4
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), flush=True)
    for label, b, n, a, f in CASES:
        plan = epi._epi_plan(b, m, n, a, f, bf, epi._sm_count("cuda"))
        params = [(rn(m, f, f) / f ** 0.5).to(bf), rn(m, f, s=0.1).to(bf),
                  (torch.rand(f, device="cuda") + 0.5).to(bf),
                  rn(f, s=0.1).to(bf), rn(f, 1, s=0.02).to(bf), rn(1)]
        if a:
            p = torch.softmax(rn(b, m, n, a, s=4.0), -1).to(bf)
            t = [p, rn(b, m, a, f, s=2.0).to(bf), rn(f, s=0.1).to(bf)]
        else:
            t = [rn(b, m, n, f, s=0.5).to(bf)]
        t += params
        out = torch.empty(b, n, f, dtype=bf, device="cuda")
        ptrs = [x.data_ptr() for x in t]
        print(label, plan, flush=True)
        base = None
        for name, lib in libs.items():
            def call(lib=lib):
                if a:
                    return lib.epi_mid_pool(1, *ptrs, out.data_ptr(), b, m, n,
                                            a, f, plan.tile, 1e-12, stream)
                return lib.epi_private_pool(1, *ptrs, out.data_ptr(), b, m, n,
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
