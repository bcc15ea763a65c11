"""Where the flash forward kernel spends its time, by ablation.

    python3 -m segtran_tpu_torch.tools.ablate_flash_fwd

Builds ``csrc/squeezed_attention.cu`` as it is and in the variants of
``ablate_flash_bwd`` (the partial score products, the p v products, the
softmax step, the streamed k / v loads, distributed shared memory, and
that with block barriers in place of the cluster barriers, each removed or
replaced), then times the forward (the cluster kernel, and the merge of its
key splits) with CUDA events at the BraTS whole-volume in-squeeze and
out-squeeze of a 160x192x144 volume (bf16; G=1, Q=1024, N=8640, D=F=1024
and G=4, Q=8640, N=1024, D=256, F=1024). A variant computes garbage; only
its time is read. The difference to the unchanged source is that part's
share. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import _build
from ..kernels import squeezed_attention as sa
from .ablate_flash_bwd import VARIANTS, _build_variants, _time_ms

_SOFTMAX = "                                int halves) {\n"
_RETURN = "  if (threadIdx.x < 1024) return;  // ablated\n"
FWD_VARIANTS = dict(VARIANTS)
FWD_VARIANTS["no softmax step"] = [(_SOFTMAX, _SOFTMAX + _RETURN)]
FWD_VARIANTS["no streamed tile loads"] = [
    ("stage_tile<T, TK, W>(sm.", "if (false) stage_tile<T, TK, W>(sm."),
    ("stage_tile<T, TB, W>(sm.kslot", "if (false) stage_tile<T, TB, W>(sm.kslot")]
del FWD_VARIANTS["no p / ds step"]
# (label, G, Q, N, D, F)
CASES = [("in-squeeze", 1, 1024, 8640, 1024, 1024),
         ("out-squeeze", 4, 8640, 1024, 256, 1024)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_flash_fwd needs a CUDA GPU")
    libs = _build_variants(_build.BUILD_DIR / "ablate_fwd", FWD_VARIANTS)
    vp, i_, d_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.flash_fwd.argtypes = [i_] + [vp] * 7 + [i_] * 7 + [d_, d_, vp]
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), flush=True)
    for label, g, nq, n, d, f in CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(bf)
                   for shape in ((g, nq, d), (g, n, d), (g, n, f)))
        plan = sa._fwd_plan(g, nq, n, d, f, bf, sa._sm_count("cuda"))
        out = torch.empty((g, nq, f), dtype=bf, device="cuda")
        lse = torch.empty((g, nq, 1), device="cuda")
        part = torch.empty((max(1, plan.acc_scratch + plan.stats_scratch),),
                           device="cuda")
        print(label, plan, flush=True)
        base = None
        for name, lib in libs.items():
            def call(lib=lib):
                return lib.flash_fwd(
                    1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), part.data_ptr(),
                    part[plan.acc_scratch:].data_ptr(), g, nq, n, d, f,
                    plan.width, plan.splits, 1.0 / math.sqrt(d), 500.0,
                    stream)
            if call() != 0:
                raise RuntimeError(f"variant '{name}' failed to launch")
            ms = _time_ms(call)
            base = ms if base is None else base
            cut = 100 * (base - ms) / base
            print(f"{label:12s} {name:36s} {ms:.4f} ms ({cut:+.1f}% of the "
                  f"as-is time removed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
