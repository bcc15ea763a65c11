"""Where the ``mbconv_front`` kernel (``mbconv_kernel``) spends its time,
by ablation.

    python3 -m segtran_tpu_torch.tools.ablate_mbconv

Builds ``csrc/mbconv.cu`` as it is and in variants with one part removed
(the x row copies into the staged rows, which a block without an expand
does not make: its copies fill the ring and stay; the expand's
tensor-core products; the whole expand of a row, its epilogue included;
the depthwise taps, loads and products; the output stores; the swish's
exponential and division; the barrier that opens each walk step), then
times one call at each of chip_smoke's
``MBCONV_CASES`` (bf16, batch 8, the inputs chip_smoke makes) with CUDA
events. A variant computes garbage; only its time is read. The difference
to the unchanged source is that part's share. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import mbconv as mb
from .ablate_flash_bwd import _build_variants, _time_ms

_STAGE_X = ("cp_async16(dst + pos * L.lda + v * V, src + pos * p.sw + v * V, "
            "16);")
_MMA = "        mma16816(acc[0], a, b0[0], b0[1]);\n"
_EXPAND = ("expand_row<T>(x_s + (i & 1) * p.mpad * L.lda, w_s, prm, dst, L, "
           "p);")
_TAPS = "    for (int ky = 0; ky < K; ++ky) {"
_STORE = "      store_n<N>(out + (long long)(ox0 + o) * p.cexp, y);"
_SWISH = "  return __fdividef(v, 1.0f + __expf(-v));"
_STEP_SYNC = ("    __syncthreads();              // rows i (and i + 1) in; "
              "step i - 1 done")

# variant -> [(text to find, replacement), ...]
VARIANTS = {
    "as is": [],
    "no x row copies": [(_STAGE_X, "")],
    "no expand products": [(_MMA, "")] + [
        (f"        mma16816(acc[{j}], a, b{j // 2}[{2 * (j % 2)}], "
         f"b{j // 2}[{2 * (j % 2) + 1}]);\n", "") for j in (1, 2, 3)],
    "no expand (products and epilogue)": [(_EXPAND, "")],
    "no depthwise taps": [(_TAPS, "    for (int ky = 0; ky < 0; ++ky) {")],
    "no output stores": [(_STORE, "")],
    "no swish": [(_SWISH, "  return v;")],
    "no step barrier": [(_STEP_SYNC, "")],
}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_mbconv needs a CUDA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from ..nn.backbones.efficientnet import build_block_specs
    libs = _build_variants(_build.BUILD_DIR / "ablate_mb", VARIANTS, "mbconv")
    typed = mb._lib()
    for lib in libs.values():
        lib.mbconv_front.argtypes = typed.mbconv_front.argtypes
    blocks = build_block_specs("eff-b4", 1)[0]
    bf = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(cs.card_line(torch), flush=True)
    for i, (label, bi, h) in enumerate(cs.MBCONV_CASES):
        spec = blocks[bi]
        k, st, pad = spec.kernel, spec.stride, spec.pad
        x, w_exp, s0, b0, w_dw, s1, b1 = cs.mbconv_inputs(
            torch, spec, h, bf, seed=100 + i)
        b, _, _, cin = x.shape
        cexp = w_dw.shape[-1]
        ho, wo = mb._out_size(h, h, k, st, pad)
        plan = mb._mb_plan(b, h, h, cin, cexp, k, st, pad, bf, sms,
                           w_exp is not None)
        out = torch.empty(b, ho, wo, cexp, dtype=bf, device="cuda")
        part = torch.empty(b, plan.nseg, cexp, device="cuda")
        se = torch.empty(b, cexp, device="cuda")
        ptrs = [t.data_ptr() if t is not None else None
                for t in (w_exp, s0, b0, w_dw, s1, b1, out, part, se)]
        print(label, plan, flush=True)
        base = None
        for name, lib in libs.items():
            def call(lib=lib):
                return lib.mbconv_front(
                    1, k, st, x.data_ptr(), *x.stride()[:3], *ptrs, b, h, h,
                    cin, cexp, pad[0][0], pad[1][0], ho, wo, plan.rows,
                    plan.nr, stream)
            if call() != 0:
                raise RuntimeError(f"variant '{name}' failed to launch")
            ms = _time_ms(call)
            base = ms if base is None else base
            print(f"{label:26s} {name:34s} {ms:.4f} ms "
                  f"({100 * (base - ms) / base:+.1f}% of the as-is time "
                  f"removed)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
